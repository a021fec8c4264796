"""invdes_adjoint_idle_share: device idle under the design step's own spans (invdes_readers.invdes_adjoint_idle_share)."""

from portbench.invdes_readers import invdes_adjoint_idle_share as read  # noqa: F401
