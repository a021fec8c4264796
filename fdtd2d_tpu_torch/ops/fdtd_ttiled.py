"""K2: temporally tiled multi-step FDTD — CUDA kernel wrapper, planner and
the plain tile emulation.

Counterpart of ``fdtd2d_tpu/ops/pallas_fdtd_ttiled.py``. The kernel is
``ops/csrc/fdtd_ttiled.cu`` (its header comment gives the design, the
validity argument and the bound on the card). Each sweep advances up to K
steps: the grid is cut into tiles of TH x TW owned cells, and each tile
steps its window (owned cells plus a halo of K, clipped at the domain) and
keeps its owned cells. :func:`tile_spans` is the tiling rule the kernel
computes for itself; :func:`pick_sweep_depth` chooses (K, TH, TW) for this
card; :func:`fdtd_multistep_ttiled_reference` emulates the tiling with plain
torch ops.

:func:`fdtd_multistep_ttiled` dispatches on the device of ``Ez``: a CPU
tensor goes to the emulation; a CUDA tensor launches the kernel or raises —
there is no fallback. Both take the staggered (or padded) layout and return
new tensors in the staggered shapes; the caller's tensors are never modified.
"""

from __future__ import annotations

import torch

from fdtd2d_tpu_torch.core.sources import source_amplitudes
from fdtd2d_tpu_torch.fdtd.step import MUR_BAND, multistep
# fdtd_fused as a module, its names read at call time: importing it first
# imports fdtd.simulate, which imports this module.
from fdtd2d_tpu_torch.ops import _build, fdtd_fused

S = MUR_BAND + 1  # Mur strip width: least owned cells of a tile, least window offset

SMEM_LIMIT = 232_448   # dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_BUDGET = 115_712  # two blocks per SM: (228 KB - 2 x 1 KB reserved) / 2
MAX_GRID_Y = 65_535    # row tiles are the launch grid's y dimension
# Preferred window, rows x columns: 96 columns are three warps of the
# kernel's 32 x 16 thread block, 80 rows five passes of its 16 thread rows;
# 80 x 96 windows of three fields fit SMEM_BUDGET.
WINDOW = (80, 96)
# Cap on the window cells stepped per owned cell, minus one. At 4096^2 on
# an H100 (PERF.md section 6) the 80 x 96 windows ran 115.4 GCells/s at
# K = 4 (redundancy 0.21), 123.6 at K = 6 (0.34), 123.4 at K = 8 (0.49) and
# 106.3 at K = 12 (0.89); the cap admits K = 6 and not K = 8.
MAX_REDUNDANCY = 0.35
DEPTHS = (8, 6, 4, 3, 2, 1)  # sweep depths pick_sweep_depth tries, deepest first

# Kernel launches made by fdtd_multistep_ttiled (one per sweep); a run shows
# it went through the kernel by reading this before and after.
launches = 0


def tile_spans(n: int, T: int, K: int):
    """``[(own0, own1, win0, win1), ...]`` of the tiles along one axis of
    ``n`` cells: tiles of ``T`` owned cells (the last one may be shorter),
    windows of a halo ``K`` on each side. A window that would start less than
    S cells inside the domain starts at its edge instead, and likewise at the
    far end, so a Mur chain or corner block is whole in a window or not in it
    at all. ``ttiled_sweep``'s ``tile_span`` computes the same."""
    spans = []
    for own0 in range(0, n, T):
        own1 = min(own0 + T, n)
        win0 = own0 - K if own0 - K >= S else 0
        win1 = own1 + K if own1 + K <= n - S else n
        spans.append((own0, own1, win0, win1))
    return spans


def window_extent(n: int, T: int, K: int) -> int:
    """The longest window along one axis."""
    return max(w1 - w0 for _, _, w0, w1 in tile_spans(n, T, K))


def smem_bytes(WH: int, WW: int) -> int:
    """Dynamic shared memory of a WH x WW window: Ez, Hx, Hy at the odd row
    stride ``WW | 1``, and the four pre-step Mur strips (fdtd_ttiled.cu)."""
    ld = WW | 1
    return 4 * (3 * WH * ld + 2 * WH * S + 2 * S * ld)


def redundancy(N: int, M: int, K: int, TH: int, TW: int) -> float:
    """Cells stepped over all windows per cell of the grid, minus one."""
    rows = sum(w1 - w0 for _, _, w0, w1 in tile_spans(N, TH, K))
    cols = sum(w1 - w0 for _, _, w0, w1 in tile_spans(M, TW, K))
    return rows * cols / (N * M) - 1.0


def _tile_ok(n: int, T: int) -> bool:
    # every tile owns at least S cells: the kernel's validity argument
    return T >= n or (T >= S and (n % T == 0 or n % T >= S))


def check_plan(N: int, M: int, K: int, TH: int, TW: int, budget: int = SMEM_LIMIT):
    """Raise ``ValueError`` unless the kernel can run this tiling."""
    if K < 1:
        raise ValueError(f"sweep depth K must be >= 1, got {K}")
    for n, T, name in ((N, TH, "TH"), (M, TW, "TW")):
        if not _tile_ok(n, T):
            raise ValueError(f"{name}={T} for {n} cells: every tile must own at "
                             f"least {S} cells (T >= {S}, and n % T == 0 or >= {S})")
    if -(-N // TH) > MAX_GRID_Y:
        raise ValueError(f"{-(-N // TH)} row tiles exceed the launch grid's "
                         f"{MAX_GRID_Y}: use taller tiles")
    need = smem_bytes(window_extent(N, TH, K), window_extent(M, TW, K))
    if need > budget:
        raise ValueError(f"windows of K={K}, tiles {(TH, TW)} need {need} B of "
                         f"shared memory, more than {budget} B")


def fit_tile(n: int, target: int) -> int:
    """The largest tile of at most ``target`` cells that tiles ``n`` cells
    with every tile owning at least S; ``n`` itself when it fits."""
    if n <= target:
        return n
    for T in range(target, S - 1, -1):
        if _tile_ok(n, T):
            return T
    raise ValueError(f"no tile of {S}..{target} cells tiles {n} cells")


def plan_tiles(N: int, M: int, K: int):
    """(TH, TW) whose windows at halo ``K`` are about :data:`WINDOW`."""
    return (fit_tile(N, max(WINDOW[0] - 2 * K, S)),
            fit_tile(M, max(WINDOW[1] - 2 * K, S)))


def pick_sweep_depth(N: int, M: int):
    """``(K, TH, TW)``: the deepest K in :data:`DEPTHS` whose tiling keeps the
    redundant compute at or below :data:`MAX_REDUNDANCY` and fits two blocks
    per SM. Raises ``ValueError`` when no depth admits the grid."""
    for K in DEPTHS:
        try:
            TH, TW = plan_tiles(N, M, K)
            check_plan(N, M, K, TH, TW, SMEM_BUDGET)
        except ValueError:
            continue
        if redundancy(N, M, K, TH, TW) <= MAX_REDUNDANCY:
            return K, TH, TW
    raise ValueError(f"no temporally tiled plan for a {(N, M)} grid")


def resolve_plan(N: int, M: int, K=None, tile=None):
    """(K, TH, TW): the planner's choice, with ``K`` and ``tile`` = (TH, TW)
    overriding it where given; checked with :func:`check_plan`."""
    if K is None:
        K, TH, TW = pick_sweep_depth(N, M)
    else:
        TH, TW = plan_tiles(N, M, K)
    if tile is not None:
        TH, TW = tile
    check_plan(N, M, K, TH, TW)
    return K, TH, TW


def fdtd_multistep_ttiled_reference(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                                    nsteps: int, source_kind: str, step_offset: int,
                                    K=None, tile=None):
    """Plain torch emulation of the tiling, in the dtype and on the device of
    ``Ez``. Per sweep, each tile's window is set into a zero grid (all tiles
    as one batch), the plain :func:`multistep` runs the sweep's steps on it,
    and each cell is taken from the tile that owns it. The band, corner and
    source stages of the plain step act in domain coordinates, so they apply
    wherever they fall in a window, as in the kernel."""
    N, M = Ez.shape
    K, TH, TW = resolve_plan(N, M, K, tile)
    fields = fdtd_fused.pad_state(Ez, Hx, Hy)
    chp = fdtd_fused.pad_field(ch, N, M)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             Ez.dtype, Ez.device)
    rows, cols = tile_spans(N, TH, K), tile_spans(M, TW, K)
    inside = torch.zeros((len(rows) * len(cols), N, M), dtype=torch.bool,
                         device=Ez.device)
    owner = torch.empty((1, N, M), dtype=torch.long, device=Ez.device)
    for a, (o0, o1, w0, w1) in enumerate(rows):
        for b, (p0, p1, v0, v1) in enumerate(cols):
            t = a * len(cols) + b
            inside[t, w0:w1, v0:v1] = True
            owner[0, o0:o1, p0:p1] = t
    for start in range(0, nsteps, K):
        tiles = [torch.where(inside, f, 0.0) for f in fields]
        multistep(*tiles, ce, chp, coef, amps[start : start + K], sx, sy)
        fields = [t.gather(0, owner)[0] for t in tiles]
    return fdtd_fused.unpad_state(*fields)


def launch(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps: int,
           source_kind: str, step_offset: int, K: int, TH: int, TW: int):
    """Run ``ttiled_sweep`` over ``nsteps`` steps on CUDA tensors; returns the
    fields in the staggered shapes. Counts nothing: its callers do."""
    fdtd_fused.check_kernel_inputs(Ez, Hx, Hy, ce, ch, sx, sy, nsteps)
    check_plan(*Ez.shape, K, TH, TW)
    lib = _build.load()
    N, M = Ez.shape
    a = fdtd_fused.pad_state(Ez, Hx, Hy)
    b = tuple(torch.empty_like(f) for f in a)
    chp = fdtd_fused.pad_field(ch, N, M)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             torch.float32, Ez.device)
    WH, WW = window_extent(N, TH, K), window_extent(M, TW, K)
    # The launches run after this function returns. Freeing amps and chp
    # then is safe: the caching allocator hands their memory only to work
    # queued later on the same stream.
    with torch.cuda.device(Ez.device):
        err = lib.fdtd_ttiled_run(
            *(f.data_ptr() for f in (*a, *b)), ce.data_ptr(), chp.data_ptr(),
            amps.data_ptr(), N, M, TH, TW, K, nsteps, WH, WW, int(sx), int(sy),
            float(coef), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fdtd_ttiled_run failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    sweeps = -(-nsteps // K)
    return fdtd_fused.unpad_state(*(b if sweeps % 2 else a))


def fdtd_multistep_ttiled(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                          nsteps: int, source_kind: str, step_offset: int,
                          K=None, tile=None):
    """Advance ``nsteps`` steps from global step ``step_offset`` in
    ``ceil(nsteps / K)`` sweeps, the last of depth ``nsteps % K`` where that
    is not 0.

    ``K`` and ``tile`` = (TH, TW) default to :func:`pick_sweep_depth`'s
    choice; passing either overrides it. Standard staggered shapes in and
    out (the padded layout is accepted too). CPU tensors run the tile
    emulation; CUDA tensors run the K2 kernel, which takes float32 only and
    raises on anything else.
    """
    global launches
    N, M = Ez.shape
    K, TH, TW = resolve_plan(N, M, K, tile)
    if Ez.device.type == "cpu":
        return fdtd_multistep_ttiled_reference(Ez, Hx, Hy, ce, ch, coef, dt, fc,
                                               sx, sy, nsteps, source_kind,
                                               step_offset, K, (TH, TW))
    if Ez.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {Ez.device}")
    out = launch(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps, source_kind,
                 step_offset, K, TH, TW)
    launches += -(-nsteps // K)
    return out
