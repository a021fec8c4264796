"""invdes_rounds_per_solve: refinement rounds a forward or adjoint solve (invdes_readers.invdes_rounds_per_solve)."""

from portbench.invdes_readers import invdes_rounds_per_solve as read  # noqa: F401
