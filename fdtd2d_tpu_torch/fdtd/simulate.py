"""FDTD rollout: frames, source injection, snapshots, backend choice.

Counterpart of ``fdtd2d_tpu/fdtd/simulate.py``. A Python loop over frames
takes the place of ``lax.scan``; each frame advances ``steps_per_frame``
leapfrog steps with the selected backend. Backend names, with the JAX
package's name for the same path:

- ``"torch"``  (JAX ``"jax"``)    — the plain step as torch ops, on any device
                                    and dtype (fdtd/step.py).
- ``"fused"``  (JAX ``"pallas"``) — the K1 CUDA kernel, float32
                                    (ops/fdtd_fused.py): its resident mode
                                    (the state in the SMs for a whole call)
                                    where the grid fits the card, else its
                                    streaming mode; CPU tensors take its
                                    plain version.
- ``"ttiled"`` (JAX ``"ttiled"``) — the temporally tiled K2 CUDA kernel, K
                                    steps per pass over 2D tiles, float32
                                    (ops/fdtd_ttiled.py); CPU tensors take its
                                    tile emulation.
- ``"auto"``   — ``"torch"`` on the CPU, and for any dtype but float32 (the
                 kernels take no other). On a CUDA device, for float32 grids of
                 at least 16 cells a side, what was fastest on an H100 (PERF.md
                 section 6, the table of ``tools/bench_fused.py``):
                 ``"fused"`` where K1's resident mode holds the grid in an
                 H100's SMs (squares up to 1034^2); past that ``"ttiled"``
                 where K2's planner admits the grid, except that calls of
                 fewer than ``SHORT_CALL_STEPS`` steps (frames a few steps
                 apart) on grids up to ``STREAMING_MAX_CELLS`` go to
                 ``"fused"``, whose streaming mode was ahead there; grids K2
                 does not admit go to ``"fused"`` too (its streaming mode
                 takes any grid). Never the plain step for float32 on the card. This
                 departs from the JAX package, which gives its on-chip kernel
                 every grid up to (2048+256)^2 whatever the call's length: on
                 this card the state stays on chip only up to about a million
                 cells, and past that K2 is several times faster than K1
                 streaming from device memory.

The source is a scalar amplitude added at one node after each step, at
global step ``offset + i``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fdtd2d_tpu_torch.core.sources import source_amplitudes
from fdtd2d_tpu_torch.fdtd.step import multistep, precompute_coefficients
# Modules, not names: the kernel modules import fdtd.step, whose package
# imports this module, so their names are read at call time.
from fdtd2d_tpu_torch.ops import fdtd_fused, fdtd_ttiled

BACKENDS = ("auto", "torch", "fused", "ttiled")
# "auto" past K1's resident limit, as timed on an H100 (PERF.md section 6): K2
# wins from this many steps a call on; below it K1's streaming mode did, on
# grids up to this many cells
SHORT_CALL_STEPS = 8
STREAMING_MAX_CELLS = 2304 * 2304


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


def resolve_backend(backend: str, shape: Tuple[int, int], device,
                    steps_per_call: Optional[int] = None,
                    dtype: torch.dtype = torch.float32) -> str:
    """The backend that ``backend`` names for a grid of ``shape`` and fields
    of ``dtype`` on ``device``; ``steps_per_call`` is the number of steps one
    kernel call advances (a frame's steps), None for a long call."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend != "auto":
        return backend
    device = torch.device(device)
    # the kernels take float32 only; any other dtype runs the plain step, as
    # the JAX package's "auto" runs any dtype
    if device.type == "cpu" or dtype != torch.float32:
        return "torch"
    if device.type != "cuda" or min(shape) < fdtd_fused.MIN_SIDE:
        raise ValueError(f"backend 'auto' has no kernel for a {shape} grid on {device}")
    # the rule is that of the card it was measured on, whatever card runs
    if _admits(fdtd_fused.plan_resident, *shape, *fdtd_fused.H100):
        return "fused"
    short = steps_per_call is not None and steps_per_call < SHORT_CALL_STEPS
    if short and shape[0] * shape[1] <= STREAMING_MAX_CELLS:
        return "fused"
    return "ttiled" if _admits(fdtd_ttiled.pick_sweep_depth, *shape) else "fused"


def _admits(planner, *args) -> bool:
    try:
        planner(*args)
    except ValueError:
        return False
    return True


def _advance(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps: int,
             source_kind: str, step_offset: int, backend: str, amps=None):
    """Advance ``nsteps`` steps from global step ``step_offset``. The
    ``"torch"`` backend updates the fields in place; the kernels return new
    tensors. ``"fused"`` takes and returns the padded layout, ``ch`` too, and
    takes the call's source amplitudes where the caller has them."""
    args = (Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps, source_kind, step_offset)
    if backend == "fused":
        return fdtd_fused.advance_padded(*args, amps=amps)
    if backend == "ttiled":
        return fdtd_ttiled.fdtd_multistep_ttiled(*args)
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
    steps_per_frame = max(config.nsteps // max(config.nframes, 1), 1)
    backend = resolve_backend(config.backend, (rows, cols), device, steps_per_frame, dtype)

    fields = (Ez, Hx, Hy)
    unpad = backend == "fused" and not config.padded
    if backend == "fused":
        # K1 works on the padded layout: the state and ch are padded once and
        # stay padded across the frames; the phantom cells go at the end
        ch = fdtd_fused.pad_field(ch, rows, cols)
        fields = tuple(fdtd_fused.pad_field(f, rows, cols) for f in fields)
    # one computation of the source for all frames of a float32 K1 rollout on
    # the card: a frame of a few steps otherwise pays it again every call
    amps = (source_amplitudes(config.source_kind, 0, config.nsteps, dt, fc, dtype, device)
            if backend == "fused" and device.type == "cuda" and dtype == torch.float32
            else None)

    def advance(fields, n, offset):
        return _advance(*fields, ce, ch, coef, dt, fc, sx, sy, n, config.source_kind, offset,
                        backend, None if amps is None else amps[offset : offset + n])

    def finish(fields):
        return fdtd_fused.unpad_state(*fields) if unpad else fields

    if config.nframes <= 0:
        return finish(advance(fields, config.nsteps, 0)), None

    nframes = config.nsteps // steps_per_frame
    snaps = torch.empty((nframes, rows, cols), dtype=dtype, device=device)
    for k in range(nframes):
        fields = advance(fields, steps_per_frame, k * steps_per_frame)
        snaps[k].copy_(fields[0])
    remainder = config.nsteps - nframes * steps_per_frame
    if remainder > 0:
        fields = advance(fields, remainder, nframes * steps_per_frame)
    return finish(fields), snaps
