"""K3: one leapfrog step per pass over the grid's tiles — the K = 1 mode of
the K2 kernel.

Counterpart of ``fdtd2d_tpu/ops/pallas_fdtd_blocked.py``. That TPU kernel
sweeps row panels once per step, recomputing the halo's H in each panel and
writing back its own rows. On this card the K2 kernel
(``ops/csrc/fdtd_ttiled.cu``) at K = 1 is that computation: one launch and
one pass over HBM per step (5 reads, 3 writes: 32 B/cell/step plus the
halo), each tile recomputing its one-cell halo. So K3 has no kernel source
of its own; this module is its entry point with the JAX signature and its
own launch counter.

A CPU tensor goes to the K = 1 tile emulation
(:func:`~fdtd2d_tpu_torch.ops.fdtd_ttiled.fdtd_multistep_ttiled_reference`);
a CUDA tensor launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

from fdtd2d_tpu_torch.ops import fdtd_ttiled

# Kernel launches made by fdtd_multistep_blocked (one per step).
launches = 0


def fdtd_multistep_blocked(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                           nsteps: int, source_kind: str, step_offset: int,
                           PH: int = 512, tile=None):
    """Advance ``nsteps`` steps from global step ``step_offset``, one pass
    per step. ``PH``, the TPU kernel's panel height, is accepted for the
    signature and ignored: the tiles are K2's planner's for K = 1, or
    ``tile`` = (TH, TW) where given. Staggered shapes in and out (the padded
    layout is accepted too); float32 only on the card."""
    global launches
    N, M = Ez.shape
    _, TH, TW = fdtd_ttiled.resolve_plan(N, M, 1, tile)
    if Ez.device.type == "cpu":
        return fdtd_ttiled.fdtd_multistep_ttiled_reference(
            Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps, source_kind,
            step_offset, 1, (TH, TW))
    if Ez.device.type != "cuda":
        raise ValueError(f"no K3 kernel for device {Ez.device}")
    out = fdtd_ttiled.launch(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps,
                             source_kind, step_offset, 1, TH, TW)
    launches += nsteps
    return out
