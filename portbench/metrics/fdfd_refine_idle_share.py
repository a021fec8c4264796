"""fdfd_refine_idle_share: device idle under the program's refinement spans (spans.fdfd_refine_idle_share)."""

from portbench.spans import fdfd_refine_idle_share as read  # noqa: F401
