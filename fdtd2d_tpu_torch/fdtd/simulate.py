"""FDTD rollout: frames, source injection, snapshots, backend choice.

Counterpart of ``fdtd2d_tpu/fdtd/simulate.py``. A Python loop over frames
takes the place of ``lax.scan``; each frame advances ``steps_per_frame``
leapfrog steps with the selected backend. Backend names, with the JAX
package's name for the same path:

- ``"torch"``  (JAX ``"jax"``)    — the plain step as torch ops, on any device
                                    and dtype (fdtd/step.py).
- ``"fused"``  (JAX ``"pallas"``) — the K1 CUDA kernel, float32
                                    (ops/fdtd_fused.py); CPU tensors take its
                                    plain version.
- ``"ttiled"`` (JAX ``"ttiled"``) — the temporally tiled K2 CUDA kernel, K
                                    steps per pass over 2D tiles, float32
                                    (ops/fdtd_ttiled.py); CPU tensors take its
                                    tile emulation.
- ``"auto"``   — ``"torch"`` on the CPU. On a CUDA device the JAX package's
                 rule: ``"fused"`` up to (2048+256)^2 cells with both sides
                 >= 16, else ``"ttiled"`` where K2's planner admits the grid,
                 else it raises (never the plain step on the card).

The source is a scalar amplitude added at one node after each step, at
global step ``offset + i``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fdtd2d_tpu_torch.core.sources import source_amplitudes
from fdtd2d_tpu_torch.fdtd.step import multistep, precompute_coefficients
# Modules, not names: the kernel modules import fdtd.step, whose package
# imports this module, so their names are read at call time.
from fdtd2d_tpu_torch.ops import fdtd_fused, fdtd_ttiled

BACKENDS = ("auto", "torch", "fused", "ttiled")
# Largest grid "auto" gives K1: the JAX package's limit for its VMEM-resident
# kernel (fdtd2d_tpu/fdtd/simulate.py:35), kept so both packages pick the
# same path. Whether K2 beats K1 below it on this card is PERF.md's open
# question.
FUSED_MAX_CELLS = (2048 + 256) * (2048 + 256)


@dataclasses.dataclass(frozen=True)
class FDTDConfig:
    dt: float
    dx: float
    nsteps: int
    source_xy: Tuple[int, int]
    source_fc: float
    source_kind: str = "ricker"        # "ricker" | "sinusoidal"
    nframes: int = 0                   # 0 = no snapshots
    backend: str = "auto"              # "auto" | "torch" | "fused" | "ttiled"
    padded: bool = False               # uniform (N, M) field shapes
    dtype: torch.dtype = torch.float32
    device: str = "cuda"


def resolve_backend(backend: str, shape: Tuple[int, int], device) -> str:
    """The backend that ``backend`` names for a grid of ``shape`` on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend != "auto":
        return backend
    device = torch.device(device)
    if device.type == "cpu":
        return "torch"
    if device.type == "cuda" and min(shape) >= fdtd_fused.MIN_SIDE:
        if shape[0] * shape[1] <= FUSED_MAX_CELLS:
            return "fused"
        try:
            fdtd_ttiled.pick_sweep_depth(*shape)
            return "ttiled"
        except ValueError:
            pass
    raise ValueError(f"backend 'auto' has no kernel for a {shape} grid on {device}")


def _advance(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps: int,
             source_kind: str, step_offset: int, backend: str):
    """Advance ``nsteps`` steps from global step ``step_offset``. The
    ``"torch"`` backend updates the fields in place; the kernels return new
    tensors."""
    if backend in ("fused", "ttiled"):
        run = (fdtd_fused.fdtd_multistep_fused if backend == "fused"
               else fdtd_ttiled.fdtd_multistep_ttiled)
        return run(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps, source_kind,
                   step_offset)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             Ez.dtype, Ez.device)
    return multistep(Ez, Hx, Hy, ce, ch, coef, amps, sx, sy)


def simulate(eps, mu, config: FDTDConfig, state=None):
    """Run an FDTD rollout on ``config.device`` in ``config.dtype``.

    ``eps``/``mu`` are arrays or tensors; ``state`` an optional ``(Ez, Hx,
    Hy)`` to continue from, which is copied and never modified. Returns
    ``(Ez, Hx, Hy), snapshots`` where ``snapshots`` is a ``(nframes, N, M)``
    tensor of strided Ez frames (or None if nframes=0).

    Frame timing deviation from the reference: frame k is emitted after
    ``(k+1)*steps_per_frame`` steps, while the reference captures at
    ``i % steps_per_frame == 0`` inside its loop, i.e. after
    ``k*steps_per_frame + 1`` steps — a constant offset of
    ``steps_per_frame - 1`` steps per frame (as in the JAX package).
    """
    dtype, device = config.dtype, torch.device(config.device)
    eps = torch.as_tensor(eps, dtype=dtype, device=device)
    mu = torch.as_tensor(mu, dtype=dtype, device=device)
    rows, cols = eps.shape
    if state is None:
        Ez = torch.zeros((rows, cols), dtype=dtype, device=device)
        hx_shape, hy_shape = ((rows, cols), (rows, cols)) if config.padded else (
            (rows, cols - 1), (rows - 1, cols))
        Hx = torch.zeros(hx_shape, dtype=dtype, device=device)
        Hy = torch.zeros(hy_shape, dtype=dtype, device=device)
    else:
        Ez, Hx, Hy = (torch.as_tensor(a, dtype=dtype, device=device).clone()
                      for a in state)

    ce, ch, coef = precompute_coefficients(eps, mu, config.dt, config.dx, dtype)
    if config.padded:
        ch = torch.nn.functional.pad(ch, (0, 1, 0, 1))
    dt = torch.tensor(config.dt, dtype=dtype, device=device)
    fc = torch.tensor(config.source_fc, dtype=dtype, device=device)
    sx, sy = config.source_xy
    backend = resolve_backend(config.backend, (rows, cols), device)

    def advance(fields, n, offset):
        return _advance(*fields, ce, ch, coef, dt, fc, sx, sy, n,
                        config.source_kind, offset, backend)

    fields = (Ez, Hx, Hy)
    if config.nframes <= 0:
        return advance(fields, config.nsteps, 0), None

    steps_per_frame = max(config.nsteps // config.nframes, 1)
    nframes = config.nsteps // steps_per_frame
    snaps = torch.empty((nframes, rows, cols), dtype=dtype, device=device)
    for k in range(nframes):
        fields = advance(fields, steps_per_frame, k * steps_per_frame)
        snaps[k].copy_(fields[0])
    remainder = config.nsteps - nframes * steps_per_frame
    if remainder > 0:
        fields = advance(fields, remainder, nframes * steps_per_frame)
    return fields, snaps
