"""TE-mode leapfrog step as plain torch ops — the plain path of every kernel.

Counterpart of ``fdtd2d_tpu/fdtd/step.py`` with the same staged semantics
(those of the float64 NumPy oracle, ``fdtd2d_tpu/fdtd/reference.py``):
H update, interior Ez update, 5-cell Mur bands (left/right, then
top/bottom), 5x5 corner averaging.

The step works in place on its field tensors. Of the pre-step Ez it copies
only the four 6-wide strips that the Mur scheme reads, as the CUDA kernel
does (``fdtd2d_tpu_torch/ops/csrc/fdtd_fused.cu``). Each band and corner
assignment evaluates its right-hand side before the store, so every stage
reads the previous stage's output, as the oracle's staged copies do; this
holds for grids of at least 3*MUR_BAND cells a side, which the oracle asserts.
"""

from __future__ import annotations

from typing import Tuple

import torch

MUR_BAND = 5


def mur_coefficient(eps00, mu00, dt, dx):
    """First-order Mur coefficient (c*dt - dx)/(c*dt + dx); tensor arguments."""
    c = 1.0 / torch.sqrt(mu00 * eps00)
    return (c * dt - dx) / (c * dt + dx)


def precompute_coefficients(eps, mu, dt, dx, dtype=torch.float32):
    """(ce, ch, coef): update coefficients and the scalar Mur coefficient,
    computed in the dtype of ``eps``/``mu`` and then cast to ``dtype``."""
    eps = torch.as_tensor(eps)
    mu = torch.as_tensor(mu)
    ce = (dt / (eps * dx)).to(dtype)
    ch = (dt / (mu[..., :-1, :-1] * dx)).to(dtype)
    coef = mur_coefficient(eps[..., 0, 0], mu[..., 0, 0], dt, dx).to(dtype)
    return ce, ch, coef


def fdtd_step(Ez: torch.Tensor, Hx: torch.Tensor, Hy: torch.Tensor,
              ce: torch.Tensor, ch: torch.Tensor, coef
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leapfrog step, in place on ``Ez``, ``Hx`` and ``Hy`` (returned).

    Takes the staggered layout (Ez (N,M), Hx (N,M-1), Hy (N-1,M), ch
    (N-1,M-1)) or the padded one (all (N,M)): the slices below touch the same
    cells in both. Hx's last row and Hy's last column are never written, and
    the padded layout's phantom Hx column and Hy row are never read or written.
    The fields may carry leading batch dimensions, which ``ce``, ``ch`` and
    ``coef`` broadcast over (one set for every scene, or one a scene: ce and
    ch (B, ...) and coef (B, 1, 1)).
    """
    b = MUR_BAND
    N, M = Ez.shape[-2:]
    pl, pr = Ez[..., :, : b + 1].clone(), Ez[..., :, M - b - 1 :].clone()
    pt, pb = Ez[..., : b + 1, :].clone(), Ez[..., N - b - 1 :, :].clone()

    # -- H update (staggered curl of Ez) ------------------------------------
    e00 = Ez[..., : N - 1, : M - 1]
    chv = ch[..., : N - 1, : M - 1]
    Hx[..., : N - 1, : M - 1] -= chv * (Ez[..., 1:, : M - 1] - e00)
    Hy[..., : N - 1, : M - 1] += chv * (Ez[..., : N - 1, 1:] - e00)

    # -- Ez interior update --------------------------------------------------
    curl_h = (Hy[..., 1 : N - 1, 1 : M - 1] - Hy[..., 1 : N - 1, : M - 2]) - (
        Hx[..., 1 : N - 1, 1 : M - 1] - Hx[..., : N - 2, 1 : M - 1]
    )
    Ez[..., 1:-1, 1:-1] += curl_h * ce[..., 1:-1, 1:-1]

    # -- Mur bands: left/right, then top/bottom ------------------------------
    Ez[..., 1:-1, :b] = pl[..., 1:-1, 1:] + coef * (Ez[..., 1:-1, 1 : b + 1] - pl[..., 1:-1, :b])
    Ez[..., 1:-1, -b:] = pr[..., 1:-1, :b] + coef * (Ez[..., 1:-1, -b - 1 : -1] - pr[..., 1:-1, 1:])
    Ez[..., :b, 1:-1] = pt[..., 1:, 1:-1] + coef * (Ez[..., 1 : b + 1, 1:-1] - pt[..., :b, 1:-1])
    Ez[..., -b:, 1:-1] = pb[..., :b, 1:-1] + coef * (Ez[..., -b - 1 : -1, 1:-1] - pb[..., 1:, 1:-1])

    # -- corner averaging (the reference's per-corner index choices) ---------
    Ez[..., :b, :b] = (Ez[..., :b, 1 : b + 1] + Ez[..., 1 : b + 1, :b]) * 0.5
    Ez[..., :b, -b:] = (Ez[..., :b, -b - 1 : -1] + Ez[..., 1 : b + 1, -b:]) * 0.5
    Ez[..., -b:, :b] = (Ez[..., -b - 1 : -1, :b] + Ez[..., -b:, 1 : b + 1]) * 0.5
    Ez[..., -b:, -b:] = (Ez[..., -b - 1 : -1, -b:] + Ez[..., -b:, -b - 1 : -1]) * 0.5
    return Ez, Hx, Hy


# The padded layout needs no separate body: fdtd_step's slices cover it.
fdtd_step_padded = fdtd_step


def multistep(Ez, Hx, Hy, ce, ch, coef, amps, sx: int, sy: int):
    """``len(amps)`` steps, each followed by ``Ez[..., sx, sy] += amps[i]``;
    in place on the fields (returned)."""
    for amp in amps:
        fdtd_step(Ez, Hx, Hy, ce, ch, coef)
        Ez[..., sx, sy] += amp
    return Ez, Hx, Hy
