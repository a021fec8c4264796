"""fdfd_inner_solves_per_call: complex64 inner solves a traced call (spans.fdfd_inner_solves_per_call)."""

from portbench.spans import fdfd_inner_solves_per_call as read  # noqa: F401
