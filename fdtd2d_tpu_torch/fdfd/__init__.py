"""FDFD steady-state solves (counterpart of ``fdtd2d_tpu/fdfd``): the direct
sublattice block-Thomas solver, FDM-preconditioned FGMRES, and complex128
iterative refinement. Not ported yet: the adjoint (autodiff), tiled
Schwarz, the time-domain solver, and the compressed/HPS factor modes."""

from fdtd2d_tpu_torch.ops.helmholtz import make_operator, HelmholtzOperator
from fdtd2d_tpu_torch.fdfd.solver import (
    run_fdfd, shifted_laplacian_preconditioner, solve_fdfd,
)
from fdtd2d_tpu_torch.fdfd.direct import (
    DirectSolver, factor, factor_checkpointed, solve_checkpointed, solve_direct,
    solve_factored,
)
from fdtd2d_tpu_torch.fdfd.refine import refine, refine_batched, RefineResult

__all__ = [
    "make_operator",
    "HelmholtzOperator",
    "solve_fdfd",
    "run_fdfd",
    "DirectSolver",
    "factor",
    "solve_direct",
    "solve_factored",
    "factor_checkpointed",
    "solve_checkpointed",
    "refine",
    "refine_batched",
    "RefineResult",
    "shifted_laplacian_preconditioner",
]
