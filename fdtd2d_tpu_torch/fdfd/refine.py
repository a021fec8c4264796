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

Each round reads one host value (the residual norm, a vector of them when
batched), which the stopping rule needs. Spans (utils/trace.py):
``fdfd.refine.residual`` around each residual pass, ``fdfd.refine.read``
around each host read of the norms, where the host waits for the device.

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


def _residual_step(op64: HelmholtzOperator, b, x, inner_dtype, batched, kernel):
    """(r/||r|| as inner_dtype, ||r|| float64 on the device); by the
    kernels where ``kernel`` (ops/fdfd_residual.py's rule) holds."""
    with span("fdfd.refine.residual"):
        if kernel:
            return fdfd_residual.residual_pass(op64, b, x)
        r = op64.residual(b, x)
        rn = scaled_norm(r, batched)
        safe = torch.where(rn == 0, torch.ones_like(rn), rn)
        if batched:
            safe = safe[:, None, None]
        return (r / safe).to(inner_dtype), rn


def _rhs_norm(b, batched, kernel):
    """||b|| float64 on the device, per sample when batched."""
    return fdfd_residual.norms(b) if kernel else scaled_norm(b, batched)


def _update(x, rn, d, batched, kernel):
    """x + ||r|| d: in place on ``x`` by the kernel where ``kernel`` holds."""
    if kernel:
        return fdfd_residual.update(x, rn, d)
    return x + (rn[:, None, None] if batched else rn) * d.to(torch.complex128)


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
    """Iteratively refine ``A x = b`` (complex128 ``op64`` and ``b``) to
    ``target`` true relative residual.

    ``inner_solve``: any complex64 solver taking a unit-norm (Nx, Ny) RHS
    and returning an approximate correction. Stops early when the residual
    stagnates (``rel >= 0.9 * prev``), so a mis-tuned inner solve never loops
    forever. A supplied ``x0`` is copied, never written.
    """
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    kernel = fdfd_residual.takes_kernel(op64, b, x, inner_dtype, batched=False)
    bn = float(_read(_rhs_norm(b, False, kernel)))
    if bn == 0.0:
        return RefineResult(x, 0.0, 0, [0.0])

    trace: List[float] = []
    prev = float("inf")
    rounds = 0
    for k in range(max_rounds):
        rc, rn = _residual_step(op64, b, x, inner_dtype, False, kernel)
        rel = float(_read(rn)) / bn
        trace.append(rel)
        if rel <= target or rel >= 0.9 * prev:  # converged or stagnated
            break
        prev = rel
        x = _update(x, rn, inner_solve(rc), False, kernel)
        rounds = k + 1
    else:
        _, rn = _residual_step(op64, b, x, inner_dtype, False, kernel)
        trace.append(float(_read(rn)) / bn)
    return RefineResult(x, trace[-1], rounds, trace)


def refine_batched(
    op64: HelmholtzOperator,
    b: torch.Tensor,
    inner_solve: Callable[[torch.Tensor], torch.Tensor],
    *,
    target: float = 1e-9,
    max_rounds: int = 8,
    inner_dtype=torch.complex64,
) -> BatchRefineResult:
    """Refine a BATCH of right-hand sides ``A x_i = b_i`` jointly.

    ``b``: (B, Nx, Ny) complex128 (one operator, many sources).
    ``inner_solve`` maps a (B, Nx, Ny) batch to corrections in one call.
    Runs until the WORST sample meets ``target`` or the worst-case residual
    stagnates; each round is one batched float64 residual pass and one
    batched inner solve.
    """
    if b.ndim != 3:
        raise ValueError(f"refine_batched wants (B, Nx, Ny) fields, got {tuple(b.shape)}")
    B = b.shape[0]
    x = torch.zeros_like(b)
    kernel = fdfd_residual.takes_kernel(op64, b, x, inner_dtype, batched=True)
    bn = _read(_rhs_norm(b, True, kernel))
    bn_safe = np.where(bn == 0.0, 1.0, bn)

    trace: List[float] = []
    prev = float("inf")
    rounds = 0
    for k in range(max_rounds):
        rc, rn = _residual_step(op64, b, x, inner_dtype, True, kernel)
        rel = _read(rn) / bn_safe
        worst = float(rel.max()) if B else 0.0
        trace.append(worst)
        if worst <= target or worst >= 0.9 * prev:
            break
        prev = worst
        x = _update(x, rn, inner_solve(rc), True, kernel)
        rounds = k + 1
    else:
        _, rn = _residual_step(op64, b, x, inner_dtype, True, kernel)
        rel = _read(rn) / bn_safe
        trace.append(float(rel.max()) if B else 0.0)
    # ``rel`` is the residual of the returned x: every exit reads it last
    return BatchRefineResult(x, rel, rounds, trace)
