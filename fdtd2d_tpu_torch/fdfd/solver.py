"""Iterative FDFD solves: preconditioned FGMRES on the matrix-free Helmholtz
operator (counterpart of ``fdtd2d_tpu/fdfd/solver.py``).

Preconditioners:
- "fdm" (default): exact uniform-medium UPML inverse by fast
  diagonalization (ops/fdm.py).
- "dst": complex-shifted-Laplacian inverse, applied exactly in O(N^2 log N)
  via DST-I diagonalization of the constant-coefficient distance-2 stencil.
- "jacobi": diagonal scaling.
- None: raw Krylov.

The JAX package's ``bicgstab`` and ``gmres`` methods are ``jax.scipy``
library solvers; they are not ported yet and raise.

A stacked operator (ops/helmholtz.py ``stack_operators``) solves its F
systems as one batched FGMRES, the port's form of ``jax.vmap`` of the JAX
solve: ``b`` and ``x0`` are then (F, Nx, Ny), and the result's residuals,
``converged`` and iterations are lists, one entry a member.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from fdtd2d_tpu_torch.fdfd.refine import refine, true_relative_residual
from fdtd2d_tpu_torch.ops.dst import dst2d
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator, make_operator
from fdtd2d_tpu_torch.ops.krylov import fgmres


def shifted_laplacian_preconditioner(
    op: HelmholtzOperator, beta: complex = 1.0 - 0.5j
) -> Callable[[torch.Tensor], torch.Tensor]:
    """M^{-1} exactly inverting the constant-coefficient shifted operator.

    M = mean(1/mu) (L_c + L_r) - beta omega^2 mean(eps) I, where L = K K^T is
    the 1D distance-2 Laplacian built from the truncated central difference K.
    K is skew-symmetric tridiagonal Toeplitz(-a, 0, a), a = 1/(2d), whose
    exact eigendecomposition is K = V (2ia cos(theta_k)) V^{-1} with
    V = diag(i^j) S, S the DST-I matrix, theta_k = k pi/(n+1). Hence
    L = -K^2 = V (4 a^2 cos^2 theta_k) V^{-1} *including* the boundary
    truncation. With S^2 = (n+1)/2 I, V^{-1} = (2/(n+1)) S diag(i^-j).
    """
    Nx, Ny = op.shape
    dev = op.device
    im_ref = op.inv_mu.mean()
    eps_ref = op.eps.mean()
    w2 = op.omega**2
    if op.batch_shape:
        w2 = w2[:, None, None]
    kr = torch.arange(1, Nx + 1, dtype=torch.float64, device=dev)
    kc = torch.arange(1, Ny + 1, dtype=torch.float64, device=dev)
    lam_r = 4.0 * op.inv_2dy.double()**2 * torch.cos(math.pi * kr / (Nx + 1)) ** 2
    lam_c = 4.0 * op.inv_2dx.double()**2 * torch.cos(math.pi * kc / (Ny + 1)) ** 2
    shift = beta * w2 * eps_ref
    denom = (im_ref * (lam_r[:, None] + lam_c[None, :])).to(op.dtype) - shift

    powers_of_i = torch.tensor([1, 1j, -1, -1j], dtype=op.dtype).to(dev)
    mod_r = powers_of_i[torch.arange(Nx, device=dev) % 4]   # i^j along rows
    mod_c = powers_of_i[torch.arange(Ny, device=dev) % 4]   # i^j along cols
    w = mod_r[:, None] * mod_c[None, :]
    w_inv = w.conj()                                        # i^{-j}
    norm = 4.0 / ((Nx + 1) * (Ny + 1))

    def minv(r: torch.Tensor) -> torch.Tensor:
        r2 = r.reshape(op.field_shape).to(op.dtype)
        rhat = dst2d(r2 * w_inv) * norm      # V^{-1} r
        x = w * dst2d(rhat / denom)          # V xhat
        return x.to(op.dtype).reshape(r.shape)

    return minv


def jacobi_preconditioner(op: HelmholtzOperator) -> Callable[[torch.Tensor], torch.Tensor]:
    d = op.diagonal()

    def minv(r: torch.Tensor) -> torch.Tensor:
        return (r.reshape(d.shape) / d).reshape(r.shape).to(op.dtype)

    return minv


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """A solve's field and figures; for a stacked operator the field is
    (F, Nx, Ny) and each figure a list with one entry a member."""

    x: torch.Tensor            # (Nx, Ny) complex field
    relative_residual: float   # true residual in the solve's precision
    converged: bool            # relative_residual < 10 * tol
    iterations: int            # whole restart cycles times the restart length


class RefinedSolveResult(NamedTuple):
    """Result of a refined solve (``run_fdfd(..., refine_target=...)``).

    ``x`` is the downcast of the refined iterate and ``relative_residual``
    is the TRUE float64 residual OF THAT DOWNCAST ARRAY: in complex64 the
    downcast alone floors it around eps_f32 * ||A|| ||x|| / ||b||, however
    far refinement pushed the float64 iterate. Callers needing the full
    refined accuracy use ``x64`` (residual ``x64_residual``)."""

    x: torch.Tensor                # downcast field
    relative_residual: float       # true float64 residual of the downcast x
    converged: bool                # did the float64 ITERATE meet refine_target
    x64: torch.Tensor              # complex128 solution
    x64_residual: float            # true float64 residual of the iterate
    trace: tuple                   # per-round true residuals of the iterate


def resolve_preconditioner(op: HelmholtzOperator, preconditioner):
    """Resolve a preconditioner spec to (callable_or_None, builtin_name)."""
    if preconditioner == "fdm":
        from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner_for

        return fdm_preconditioner_for(op), None
    if preconditioner in ("dst", "jacobi", None):
        return None, preconditioner
    return preconditioner, None  # already a callable (e.g. FDMPreconditioner)


def solve_fdfd(
    op: HelmholtzOperator,
    b: torch.Tensor,
    *,
    method: str = "fgmres",
    preconditioner="fdm",
    tol: float = 1e-6,
    maxiter: int = 2000,
    restart: int = 40,
    x0: Optional[torch.Tensor] = None,
) -> SolveResult:
    """Solve A x = b. ``b`` may be (Nx, Ny) or flattened; returns (Nx, Ny) x
    ((F, Nx, Ny) for a stacked operator, whose ``b`` is (F, Nx, Ny)).

    ``preconditioner``: "fdm" (default), "dst", "jacobi", None, or any
    callable (e.g. a prebuilt :class:`~fdtd2d_tpu_torch.ops.fdm.FDMPreconditioner`).
    ``x0``: a warm start, (Nx, Ny) or flattened; zero when None.
    """
    if method in ("bicgstab", "gmres"):
        raise NotImplementedError(
            f"method {method!r} (a jax.scipy library solver in the JAX package) is "
            f"not ported yet (ROADMAP Queue 1); use method='fgmres'")
    if method != "fgmres":
        raise ValueError(f"unknown method {method!r}")
    M, builtin = resolve_preconditioner(op, preconditioner)
    if builtin == "dst":
        M = shifted_laplacian_preconditioner(op)
    elif builtin == "jacobi":
        M = jacobi_preconditioner(op)
    b2 = b.reshape(op.field_shape).to(op.dtype)
    if x0 is not None:
        x0 = x0.reshape(op.field_shape).to(op.dtype)
    batched = bool(op.batch_shape)
    out = fgmres(op.apply, b2, M, x0=x0, restart=restart, maxiter=maxiter, tol=tol,
                 batched=batched)
    res = out.relative_residual
    converged = [r < 10 * tol for r in res] if batched else res < 10 * tol
    return SolveResult(x=out.x, relative_residual=res, converged=converged,
                       iterations=out.iterations)


def run_fdfd(eps, mu, dx, dy, omega, source, *, pml_thickness: int = 40,
             sigma_max: float = 2.0, m: int = 3, rhs_scale=None,
             dtype=torch.complex64, refine_target: float | None = None,
             max_refine_rounds: int = 8, device="cuda", **solve_kwargs):
    """End-to-end steady-state solve from scene arrays.

    ``rhs_scale`` defaults to ``-1j*omega`` (the physical TE convention);
    the reference's plain driver used ``omega``.

    ``refine_target``: when set, the solve is wrapped in complex128
    iterative refinement (fdfd/refine.py) and a :class:`RefinedSolveResult`
    is returned; otherwise a :class:`SolveResult`.
    """
    op = make_operator(eps, mu, dx, dy, omega, pml_thickness, sigma_max, m, dtype, device)
    scale = (-1j * float(omega)) if rhs_scale is None else complex(rhs_scale)
    b64 = torch.as_tensor(source, device=device).to(torch.complex128) * scale
    if refine_target is None:
        return solve_fdfd(op, b64.to(dtype), **solve_kwargs)

    M, builtin = resolve_preconditioner(op, solve_kwargs.pop("preconditioner", "fdm"))

    def inner_solve(rhs):
        return solve_fdfd(op, rhs, preconditioner=M if M is not None else builtin,
                          **solve_kwargs).x

    def f64(a):
        return torch.as_tensor(a, device=device).to(torch.float64)

    op64 = make_operator(f64(eps), f64(mu), dx, dy, float(omega), pml_thickness,
                         sigma_max, m, torch.complex128, device)
    out = refine(op64, b64, inner_solve, target=refine_target,
                 max_rounds=max_refine_rounds, inner_dtype=dtype)
    x = out.x.to(dtype)
    return RefinedSolveResult(
        x=x, relative_residual=true_relative_residual(op64, b64, x),
        converged=out.relative_residual < 10 * refine_target,
        x64=out.x, x64_residual=out.relative_residual, trace=tuple(out.trace))
