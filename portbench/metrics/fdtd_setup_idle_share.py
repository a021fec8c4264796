"""fdtd_setup_idle_share: device idle under the program's fdtd.setup spans (spans.fdtd_setup_idle_share)."""

from portbench.spans import fdtd_setup_idle_share as read  # noqa: F401
