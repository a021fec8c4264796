"""fdtd_idle_share: device idle share of FDTD requests (readers.fdtd_idle_share)."""

from portbench.readers import fdtd_idle_share as read  # noqa: F401
