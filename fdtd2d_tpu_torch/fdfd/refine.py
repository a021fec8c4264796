"""Mixed-precision iterative refinement for FDFD solves.

Counterpart of ``fdtd2d_tpu/fdfd/refine.py``, on complex128 tensors in
place of the JAX package's split-complex float64 pairs:

    r_k = b - A x_k               (complex128, on the device)
    d_k ~= A^{-1} (r_k / ||r_k||)  (any complex64 inner solve)
    x_{k+1} = x_k + ||r_k|| d_k    (complex128)

Each round contracts the true residual by the inner solve's achieved
relative residual, so complex64-only inner solves reach float64-floor true
residuals. The inner right-hand side has unit norm, so the complex64 solver
always sees O(1) data. A result reports the TRUE float64 residual of the
array it returns.

The one loop, :func:`refine_batched`, runs on (B, Nx, Ny) batches;
:func:`refine` is a batch of one. Each round reads one host value, the
vector of the residuals' norms, which the stopping rule needs. Spans
(utils/trace.py): ``fdfd.refine.residual`` around each residual pass,
``fdfd.refine.read`` around each host read of the norms, where the host
waits for the device.

On the card the residual pass, the norm of b and the update run as
hand-written kernels (ops/fdfd_residual.py) wherever its rule holds, which
each call takes once: contiguous complex128 fields of an unstacked
complex128 operator, complex64 inner solves; the update then writes the
refinement's own iterate in place.
Every other input (CPU tensors, stacked operators, complex64 operators) takes
torch's chain below.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from fdtd2d_tpu_torch.ops import fdfd_residual
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator
from fdtd2d_tpu_torch.utils.trace import span


def scaled_norm(x: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """Overflow-safe 2-norm of a complex field, or per sample of a (B, Nx,
    Ny) batch: max |re|, |im| is factored out before squaring, so entries
    near 1e20 (an FDFD right-hand side scaled by -1j*omega twice) square
    to O(1)."""
    v = torch.view_as_real(x)
    dims = tuple(range(1 if batched else 0, v.ndim))
    m = v.abs().amax(dim=dims, keepdim=True)
    safe = torch.where(m == 0, torch.ones_like(m), m)
    return m.reshape(m.shape[:1] if batched else ()) * torch.sqrt(
        ((v / safe) ** 2).sum(dim=dims))


class RefineResult(NamedTuple):
    x: torch.Tensor                # complex128 solution
    relative_residual: float       # its true float64 relative residual
    rounds: int
    trace: List[float]             # true relative residual per round (incl. final)


class BatchRefineResult(NamedTuple):
    x: torch.Tensor                # (B, Nx, Ny) complex128 solutions
    relative_residual: np.ndarray  # (B,) true float64 relative residual each
    rounds: int
    trace: List[float]             # MAX-over-batch relative residual per round


def _residual_step(op64: HelmholtzOperator, b, x, inner_dtype, kernel):
    """(r/||r|| as inner_dtype, ||r|| (B,) float64 on the device) of a (B,
    Nx, Ny) batch; by the kernels where ``kernel`` (ops/fdfd_residual.py's
    rule) holds."""
    with span("fdfd.refine.residual"):
        if kernel:
            return fdfd_residual.residual_pass(op64, b, x)
        r = op64.residual(b, x)
        rn = scaled_norm(r, True)
        safe = torch.where(rn == 0, torch.ones_like(rn), rn)
        return (r / safe[:, None, None]).to(inner_dtype), rn


def _rhs_norm(b, kernel):
    """||b|| per sample, (B,) float64 on the device."""
    return fdfd_residual.norms(b) if kernel else scaled_norm(b, True)


def _update(x, rn, d, kernel):
    """x + ||r|| d: in place on ``x`` by the kernel where ``kernel`` holds."""
    if kernel:
        return fdfd_residual.update(x, rn, d)
    return x + rn[:, None, None] * d.to(torch.complex128)


def _read(norms) -> np.ndarray:
    """The device's norms on the host (float64); the host waits for them."""
    with span("fdfd.refine.read"):
        return norms.cpu().numpy()


def true_relative_residual(op64: HelmholtzOperator, b, x) -> float:
    """TRUE float64 relative residual ||b - A x|| / ||b|| of ANY iterate
    ``x`` (e.g. the complex64 downcast of a refined solution, whose residual
    is floor-limited by the downcast to ~eps_f32 * ||x||)."""
    r = op64.residual(b, x.to(torch.complex128))
    bn = float(scaled_norm(b))
    return float(scaled_norm(r)) / bn if bn else 0.0


def refine(
    op64: HelmholtzOperator,
    b: torch.Tensor,
    inner_solve: Callable[[torch.Tensor], torch.Tensor],
    *,
    target: float = 1e-9,
    max_rounds: int = 8,
    x0: Optional[torch.Tensor] = None,
    inner_dtype=torch.complex64,
) -> RefineResult:
    """Iteratively refine ``A x = b`` (complex128 ``op64`` and (Nx, Ny)
    ``b``) to ``target`` true relative residual: :func:`refine_batched` of
    a batch of one.

    ``inner_solve``: any complex64 solver taking a unit-norm (Nx, Ny) RHS
    and returning an approximate correction. Stops early when the residual
    stagnates (``rel >= 0.9 * prev``), so a mis-tuned inner solve never loops
    forever. A supplied ``x0`` is copied, never written.
    """
    out = refine_batched(op64, b[None], lambda r: inner_solve(r[0])[None], target=target,
                         max_rounds=max_rounds, x0=None if x0 is None else x0[None],
                         inner_dtype=inner_dtype)
    return RefineResult(out.x[0], float(out.relative_residual[0]), out.rounds, out.trace)


def refine_batched(
    op64: HelmholtzOperator,
    b: torch.Tensor,
    inner_solve: Callable[[torch.Tensor], torch.Tensor],
    *,
    target: float = 1e-9,
    max_rounds: int = 8,
    x0: Optional[torch.Tensor] = None,
    inner_dtype=torch.complex64,
) -> BatchRefineResult:
    """Refine a BATCH of right-hand sides ``A x_i = b_i`` jointly.

    ``b``: (B, Nx, Ny) complex128 (one operator, many sources).
    ``inner_solve`` maps a (B, Nx, Ny) batch to corrections in one call.
    Runs until the WORST sample meets ``target`` or the worst-case residual
    stagnates; each round is one batched float64 residual pass and one
    batched inner solve. A supplied ``x0`` is copied, never written. Where
    every b is zero, x (zero, or the copy of ``x0``) returns at once, with
    no residual pass.
    """
    if b.ndim != 3:
        raise ValueError(f"refine_batched wants (B, Nx, Ny) fields, got {tuple(b.shape)}")
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    kernel = fdfd_residual.takes_kernel(op64, b, x, inner_dtype)
    bn = _read(_rhs_norm(b, kernel))
    if not bn.any():
        return BatchRefineResult(x, np.zeros_like(bn), 0, [0.0])
    bn_safe = np.where(bn == 0.0, 1.0, bn)

    trace: List[float] = []
    prev = float("inf")
    rounds = 0
    for k in range(max_rounds):
        rc, rn = _residual_step(op64, b, x, inner_dtype, kernel)
        rel = _read(rn) / bn_safe
        worst = float(rel.max())
        trace.append(worst)
        if worst <= target or worst >= 0.9 * prev:  # converged or stagnated
            break
        prev = worst
        x = _update(x, rn, inner_solve(rc), kernel)
        rounds = k + 1
    else:
        _, rn = _residual_step(op64, b, x, inner_dtype, kernel)
        rel = _read(rn) / bn_safe
        trace.append(float(rel.max()))
    # ``rel`` is the residual of the returned x: every exit reads it last
    return BatchRefineResult(x, rel, rounds, trace)
