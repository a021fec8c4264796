"""fdfd_backsolve_idle_share: device idle under the program's fdfd.backsolve spans (spans.fdfd_backsolve_idle_share)."""

from portbench.spans import fdfd_backsolve_idle_share as read  # noqa: F401
