"""FDFD steady-state solves (counterpart of ``fdtd2d_tpu/fdfd``): the direct
sublattice block-Thomas solver (stored, checkpointed and HODLR-compressed
factors), the HPS nested-dissection factor, FDM-preconditioned FGMRES
(batched over omega for a stacked operator), complex128 iterative
refinement, the differentiable adjoint solve, tiled Schwarz (two-level ORAS
and the stationary sweeps) and the frequency-locked time-domain solver."""

from fdtd2d_tpu_torch.fdfd.autodiff import solve_helmholtz_differentiable
from fdtd2d_tpu_torch.ops.helmholtz import make_operator, HelmholtzOperator
from fdtd2d_tpu_torch.fdfd.solver import (
    run_fdfd, shifted_laplacian_preconditioner, solve_fdfd,
)
from fdtd2d_tpu_torch.fdfd.direct import (
    DirectSolver, factor, factor_checkpointed, solve_checkpointed, solve_direct,
    solve_factored,
)
from fdtd2d_tpu_torch.fdfd.hps import hps_factor, hps_solve
from fdtd2d_tpu_torch.fdfd.refine import refine, refine_batched, RefineResult
from fdtd2d_tpu_torch.fdfd.tiled import TiledSolver, run_fdfd_tiled
from fdtd2d_tpu_torch.fdfd.timedomain import TimeDomainSolver

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
    "hps_factor",
    "hps_solve",
    "refine",
    "refine_batched",
    "RefineResult",
    "shifted_laplacian_preconditioner",
    "solve_helmholtz_differentiable",
    "run_fdfd_tiled",
    "TiledSolver",
    "TimeDomainSolver",
]
