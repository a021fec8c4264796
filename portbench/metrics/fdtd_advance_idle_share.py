"""fdtd_advance_idle_share: device idle under the program's fdtd.advance spans (spans.fdtd_advance_idle_share)."""

from portbench.spans import fdtd_advance_idle_share as read  # noqa: F401
