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

:func:`solve_helmholtz_hps_differentiable` is the direct form: the forward
factors a complex128 operator (stacked or not) by HPS nested dissection
(fdfd/hps.py: eliminations in complex128, a complex64 store, one factor a
member; on the card with cuSOLVER's inverses, :func:`_cusolver`) and refines every member's field in complex128 to a target true
residual (fdfd/refine.py); the backward solves the adjoint systems with the
same factors, refined the same way (A^T = A, so A^{-1}'s factors serve
A^{-T}), applies the formulas above, and drops the factors. Spans
(utils/trace.py): ``fdfd.adjoint.forward`` around the factor and the forward
refinement, ``fdfd.adjoint.backward`` around the adjoint refinement and the
gradients, ``fdfd.backsolve`` around each complex64 inner solve; counter
``fdfd.adjoint.solves``, one a member a direction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import contextlib
import math
import warnings

from fdtd2d_tpu_torch.fdfd import hps
from fdtd2d_tpu_torch.fdfd.refine import refine_batched
from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator, _dcol, _drow
from fdtd2d_tpu_torch.utils.trace import count, span

RESTART = 40
HPS_ROUNDS = 40   # DirectSolver(hps=True)'s default: the HPS factor's slow contraction
HPS_LEAF = 8      # fdfd/hps.py's default leaf


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
        return (*_input_grads(ctx.needs_input_grad, op, x, res.x),
                None, None, None, None, None)


def _input_grads(needs, op: HelmholtzOperator, x, y):
    """(eps_bar, invmu_bar, b_bar) of x = A^{-1} b from the adjoint field
    y = A^{-1} conj(g), each None where ``needs`` (the Function's
    ``needs_input_grad`` of eps, inv_mu and b) says it is not wanted."""
    isc, isr, w2 = op._factors()

    def shared(a):  # the gradient of an input every member shares
        return a.sum(0) if op.batch_shape else a

    eps_bar = invmu_bar = b_bar = None
    if needs[0]:
        eps_bar = shared(w2 * (x * y).real).to(op.eps.dtype)
    if needs[1]:
        kx_c = _dcol(x * isc, op.inv_2dx)
        ky_c = _dcol(y * isc, op.inv_2dx)
        kx_r = _drow(x * isr, op.inv_2dy)
        ky_r = _drow(y * isr, op.inv_2dy)
        invmu_bar = shared(-(kx_c * ky_c + kx_r * ky_r).real).to(op.inv_mu.dtype)
    if needs[2]:
        b_bar = torch.conj_physical(y)
    return eps_bar, invmu_bar, b_bar


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


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """On a CUDA device, cuSOLVER and cuBLAS for torch's linear algebra in
    the block. MAGMA's batched LU, torch's default for the factor's batched
    inverses, allocates and frees device memory on every call outside
    torch's caching allocator; on an H100 a step's cudaFree calls there held
    the card idle 0.1-0.34 s in about one step of four at 1024^2 (steps of
    995-1450 ms, against 1127-1368 ms with cuSOLVER)."""
    if device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def _refined(op: HelmholtzOperator, factors, b, target: float, direction: str):
    """The complex128 fields A^{-1} b of every member, refined to ``target``
    with the complex64 HPS ``factors`` as inner solves; warns where the
    refinement stopped above it."""
    def inner(r):
        with span("fdfd.backsolve"):
            return hps.hps_solve(factors, r)

    out = refine_batched(op, b.reshape((-1,) + op.shape), inner, target=target,
                         max_rounds=HPS_ROUNDS)
    worst = float(out.relative_residual.max())
    if worst > target:
        warnings.warn(f"the {direction} HPS refinement stopped at worst true residual "
                      f"{worst:.2e} (target {target:.0e})", RuntimeWarning, stacklevel=3)
    count("fdfd.adjoint.solves", math.prod(op.batch_shape))
    return out


class _DirectSolve(torch.autograd.Function):
    """x = A(eps, inv_mu)^{-1} b by refined HPS direct solves; differentiable
    in eps, inv_mu and b."""

    @staticmethod
    def forward(ctx, eps, inv_mu, b, op, target, info):
        op = dataclasses.replace(op, eps=eps, inv_mu=inv_mu)
        with span("fdfd.adjoint.forward"):
            with _cusolver(op.device):
                factors = hps.hps_factor(op, m=HPS_LEAF, dtype=torch.complex64)
            out = _refined(op, factors, b, target, "forward")
        if info is not None:
            info["forward_rounds"] = out.rounds
            info["forward_residual"] = out.relative_residual
        x = out.x.reshape(op.field_shape)
        ctx.save_for_backward(eps, inv_mu, x)
        ctx.structure = (op, target, info)
        ctx.factors = factors
        return x

    @staticmethod
    def backward(ctx, g):
        eps, inv_mu, x = ctx.saved_tensors
        op, target, info = ctx.structure
        op = dataclasses.replace(op, eps=eps, inv_mu=inv_mu)
        with span("fdfd.adjoint.backward"):
            out = _refined(op, ctx.factors, torch.conj_physical(g), target, "adjoint")
            ctx.factors = None      # the step's factors go with its adjoint
            y = out.x.reshape(op.field_shape)
            grads = _input_grads(ctx.needs_input_grad, op, x, y)
        if info is not None:
            info["adjoint_rounds"] = out.rounds
            info["adjoint_residual"] = out.relative_residual
            info["adjoint_fields"] = y
        return (*grads, None, None, None)


def solve_helmholtz_hps_differentiable(op: HelmholtzOperator, b: torch.Tensor, *,
                                       target: float = 1e-6,
                                       info: Optional[dict] = None) -> torch.Tensor:
    """Differentiable x = A^{-1} b by HPS direct solves; gradients flow to
    ``op.eps``, ``op.inv_mu`` and ``b``. ``op`` is complex128 (one operator,
    or stacked over omega: one factor a member, all in one batch); the
    factors are complex64 (fdfd/hps.py, leaves of 8). Every member's field,
    forward and adjoint, is the complex128 iterate refined from zero to a
    true relative residual of ``target`` (at most 40 rounds; a
    RuntimeWarning where it stops above). The factors live from the forward
    until the backward has run, and no longer. ``info``: a dict that
    receives ``forward_rounds``/``forward_residual`` (a residual a member)
    and, once backward has run, ``adjoint_rounds``/``adjoint_residual`` and
    the adjoint fields ``adjoint_fields``."""
    if op.dtype != torch.complex128:
        raise ValueError(f"the HPS adjoint solve refines a complex128 operator, got {op.dtype}")
    return _DirectSolve.apply(op.eps, op.inv_mu, b.reshape(op.field_shape).to(op.dtype), op,
                              target, info)
