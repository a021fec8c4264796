"""fdfd_idle_share: device idle share of FDFD requests (readers.fdfd_idle_share)."""

from portbench.readers import fdfd_idle_share as read  # noqa: F401
