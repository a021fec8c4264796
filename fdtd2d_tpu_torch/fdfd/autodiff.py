"""Differentiable FDFD solve via the implicit-function-theorem adjoint
(counterpart of ``fdtd2d_tpu/fdfd/autodiff.py``).

The solve is the matrix-free Krylov iteration of fdfd/solver.py, and its
backward is the adjoint system: one more solve with the same operator and
preconditioner (A is complex symmetric, A^T = A), from a zero start, instead
of differentiating through the iteration.

torch's gradient of a real loss with respect to a complex tensor is the
complex conjugate of JAX's cotangent, so for x = A(eps, 1/mu)^{-1} b and the
incoming gradient g of x:

    y         = A^{-1} conj(g)          (adjoint solve; A^{-H} = conj(A^{-1}))
    b_bar     = conj(y)
    eps_bar   = omega^2 Re(x * y)        (dA/deps = -omega^2 I per cell)
    invmu_bar = -sum_axes Re(K((1/s) x) * K((1/s) y))

which are the JAX module's formulas with its y. For a stacked operator
(ops/helmholtz.py ``stack_operators``) x, b and y are (F, Nx, Ny), the
adjoint is one batched solve, and the gradients of the shared eps and 1/mu
sum over the omegas, as ``jax.vmap`` with ``in_axes=None`` sums them.
PML stretch factors and omega are non-differentiable structure; the warm
start gets no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator, _dcol, _drow

RESTART = 40


class _Solve(torch.autograd.Function):
    """x = A(eps, inv_mu)^{-1} b; differentiable in eps, inv_mu and b."""

    @staticmethod
    def forward(ctx, eps, inv_mu, b, x0, op, M, kw, info):
        op = dataclasses.replace(op, eps=eps, inv_mu=inv_mu)
        res = solve_fdfd(op, b, preconditioner=M, x0=x0, **kw)
        if info is not None:
            info["forward_iterations"] = res.iterations
            info["forward_residual"] = res.relative_residual
        ctx.save_for_backward(eps, inv_mu, res.x)
        ctx.structure = (op, M, kw, info)
        return res.x

    @staticmethod
    def backward(ctx, g):
        eps, inv_mu, x = ctx.saved_tensors
        op, M, kw, info = ctx.structure
        op = dataclasses.replace(op, eps=eps, inv_mu=inv_mu)
        res = solve_fdfd(op, torch.conj_physical(g), preconditioner=M, **kw)
        if info is not None:
            info["adjoint_iterations"] = res.iterations
            info["adjoint_residual"] = res.relative_residual
        y = res.x
        isc, isr, w2 = op._factors()

        def shared(a):  # the gradient of an input every member shares
            return a.sum(0) if op.batch_shape else a

        eps_bar = invmu_bar = b_bar = None
        if ctx.needs_input_grad[0]:
            eps_bar = shared(w2 * (x * y).real).to(eps.dtype)
        if ctx.needs_input_grad[1]:
            kx_c = _dcol(x * isc, op.inv_2dx)
            ky_c = _dcol(y * isc, op.inv_2dx)
            kx_r = _drow(x * isr, op.inv_2dy)
            ky_r = _drow(y * isr, op.inv_2dy)
            invmu_bar = shared(-(kx_c * ky_c + kx_r * ky_r).real).to(inv_mu.dtype)
        if ctx.needs_input_grad[2]:
            b_bar = torch.conj_physical(y)
        return eps_bar, invmu_bar, b_bar, None, None, None, None, None


def solve_helmholtz_differentiable(op: HelmholtzOperator, b: torch.Tensor, *,
                                   method: str = "fgmres", preconditioner="fdm",
                                   tol: float = 1e-6, maxiter: int = 2000,
                                   x0: Optional[torch.Tensor] = None,
                                   info: Optional[dict] = None) -> torch.Tensor:
    """Differentiable x = A^{-1} b; gradients flow to ``op.eps``,
    ``op.inv_mu`` and ``b`` (FGMRES with restart 40, as the JAX package).

    ``preconditioner``: "fdm" builds the FDM factors from ``op`` here, once a
    call; pass a prebuilt (stacked) ``FDMPreconditioner`` to reuse it.
    ``x0``: a warm start (e.g. the previous optimization step's field); it
    gets no gradient. ``info``: a dict that receives the forward solve's
    ``forward_iterations``/``forward_residual`` and, once backward has run,
    ``adjoint_iterations``/``adjoint_residual`` (lists for a stacked
    operator)."""
    b = b.reshape(op.field_shape).to(op.dtype)
    if x0 is not None:
        x0 = x0.detach().reshape(op.field_shape).to(op.dtype)
    M, builtin = resolve_preconditioner(op, preconditioner)
    kw = dict(method=method, tol=tol, maxiter=maxiter, restart=RESTART)
    return _Solve.apply(op.eps, op.inv_mu, b, x0, op, M if M is not None else builtin,
                        kw, info)
