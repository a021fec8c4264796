"""Plain FDTD reference: the TE leapfrog of the upstream NumPy code
(github.com/skunnavakkam/fdtd-2d, python-src/main.py and fdtd.py), written
from its equations in plain torch, with a leading batch axis.

One step, on Ez (N, M), Hx (N, M-1) and Hy (N-1, M):

    Hx[:-1, :]    -= dt / (mu dx) * (Ez[1:, :-1] - Ez[:-1, :-1])
    Hy[:, :-1]    += dt / (mu dx) * (Ez[:-1, 1:] - Ez[:-1, :-1])
    Ez[1:-1,1:-1] += dt / (eps dx) * ((Hy[1:, 1:-1] - Hy[1:, :-2]) - (Hx[1:-1, 1:] - Hx[:-2, 1:]))

with mu taken on [:-1, :-1] and eps on [1:-1, 1:-1]; then first-order Mur
bands five cells wide, which read the field from before the step (P):
left and right, then top and bottom (each reading the previous stage's
output), then each 5x5 corner set to the mean of its two neighbours, as the
upstream loops leave it; then a Ricker point source added at
``t = i dt`` for step i of the call:

    tau = pi fc (t - 1/fc),   amp = (1 - 2 tau^2) exp(-tau^2)

Everything is computed in ``dtype``: float64 for the check, bfloat16 for the
control. The coefficients are worked out again here from eps and mu. This
module imports nothing of the measured program.
"""

from __future__ import annotations

import math

import torch

BAND = 5
BLOCK = 32       # tile side of local_error
FLOOR = 1e-3     # least share of the peak a tile's own peak is taken as


def ricker(t: float, fc: float) -> float:
    tau = math.pi * fc * (t - 1.0 / fc)
    return (1.0 - 2.0 * tau * tau) * math.exp(-tau * tau)


def rollout(eps, mu, dt: float, dx: float, fields, steps: int, sources, fc: float,
            dtype=torch.float64):
    """Advance a batch of states ``steps`` steps on one scene.

    ``eps``, ``mu``: (N, M) tensors. ``fields``: (Ez, Hx, Hy), each with a
    leading batch axis B, copied and never modified. ``sources``: B (row,
    col) injection sites. Returns ``(Ez, Hx, Hy)`` in ``dtype``.
    """
    b = BAND
    eps64, mu64 = eps.to(torch.float64), mu.to(torch.float64)
    ce = (dt / (eps64[1:-1, 1:-1] * dx)).to(dtype)
    ch = (dt / (mu64[:-1, :-1] * dx)).to(dtype)
    c = 1.0 / math.sqrt(float(mu64[0, 0]) * float(eps64[0, 0]))
    coef = (c * dt - dx) / (c * dt + dx)
    Ez, Hx, Hy = (f.to(dtype).clone() for f in fields)
    B, N, M = Ez.shape
    rows = torch.arange(B, device=Ez.device)
    sx = torch.as_tensor([s[0] for s in sources], device=Ez.device)
    sy = torch.as_tensor([s[1] for s in sources], device=Ez.device)
    for i in range(steps):
        Hx[:, :-1, :] -= ch * (Ez[:, 1:, :-1] - Ez[:, :-1, :-1])
        Hy[:, :, :-1] += ch * (Ez[:, :-1, 1:] - Ez[:, :-1, :-1])
        # the strips of the pre-step field that the Mur bands read
        left, right = Ez[:, :, : b + 1].clone(), Ez[:, :, -b - 1 :].clone()
        top, bottom = Ez[:, : b + 1, :].clone(), Ez[:, -b - 1 :, :].clone()
        Ez[:, 1:-1, 1:-1] += ce * ((Hy[:, 1:, 1:-1] - Hy[:, 1:, :-2])
                                   - (Hx[:, 1:-1, 1:] - Hx[:, :-2, 1:]))
        new_left = left[:, 1:-1, 1:] + coef * (Ez[:, 1:-1, 1 : b + 1] - left[:, 1:-1, :b])
        new_right = right[:, 1:-1, :b] + coef * (Ez[:, 1:-1, -b - 1 : -1] - right[:, 1:-1, 1:])
        Ez[:, 1:-1, :b] = new_left
        Ez[:, 1:-1, -b:] = new_right
        new_top = top[:, 1:, 1:-1] + coef * (Ez[:, 1 : b + 1, 1:-1] - top[:, :b, 1:-1])
        new_bottom = bottom[:, :b, 1:-1] + coef * (Ez[:, -b - 1 : -1, 1:-1] - bottom[:, 1:, 1:-1])
        Ez[:, :b, 1:-1] = new_top
        Ez[:, -b:, 1:-1] = new_bottom
        corners = ((Ez[:, :b, 1 : b + 1] + Ez[:, 1 : b + 1, :b]) / 2,
                   (Ez[:, :b, -b - 1 : -1] + Ez[:, 1 : b + 1, -b:]) / 2,
                   (Ez[:, -b - 1 : -1, :b] + Ez[:, -b:, 1 : b + 1]) / 2,
                   (Ez[:, -b - 1 : -1, -b:] + Ez[:, -b:, -b - 1 : -1]) / 2)
        Ez[:, :b, :b], Ez[:, :b, -b:], Ez[:, -b:, :b], Ez[:, -b:, -b:] = corners
        Ez[rows, sx, sy] += ricker(i * dt, fc)
    return Ez, Hx, Hy


def local_error(got, want, block: int = BLOCK, floor: float = FLOOR) -> float:
    """The worst, over ``block`` x ``block`` tiles of the last two axes, of
    max |got - want| in the tile over max |want| in the tile, the latter
    never taken below ``floor`` x max |want| over the whole tensor. A fault
    confined to a quiet part of the grid (a Mur band, a corner, a tile seam
    far from the sources) then reads against the field there, and not
    against the peak near a source; the floor keeps tiles that the wave has
    not reached from reading rounding as error."""
    want = want.to(torch.float64)
    err = (got.to(torch.float64) - want).abs()
    n, m = want.shape[-2:]
    pad = (0, -m % block, 0, -n % block)
    tiles = []
    for a in (err, want.abs()):
        a = torch.nn.functional.pad(a.reshape(-1, n, m), pad)
        tiles.append(a.reshape(a.shape[0], a.shape[1] // block, block, a.shape[2] // block,
                               block).amax(dim=(2, 4)))
    scale = float(tiles[1].max())
    if not scale:
        return float("inf")
    worst = float((tiles[0] / tiles[1].clamp(min=floor * scale)).max())
    return worst if math.isfinite(worst) else float("inf")


def band_cover(Ez) -> float:
    """The least, over the four Mur bands and the four corners, of the band's
    max |Ez|, as a share of max |Ez| (of a batch: the least over it)."""
    b = BAND
    A = Ez.abs()
    parts = (A[:, b:-b, :b], A[:, b:-b, -b:], A[:, :b, b:-b], A[:, -b:, b:-b],
             A[:, :b, :b], A[:, :b, -b:], A[:, -b:, :b], A[:, -b:, -b:])
    peak = A.amax(dim=(1, 2))
    return float(torch.stack([p.amax(dim=(1, 2)) / peak for p in parts]).min())
