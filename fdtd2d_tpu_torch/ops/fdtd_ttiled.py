"""K2: temporally tiled multi-step FDTD — CUDA kernel wrapper, planner and
the plain tile emulation.

Counterpart of ``fdtd2d_tpu/ops/pallas_fdtd_ttiled.py``. The kernel is
``ops/csrc/fdtd_ttiled.cu`` (its header comment gives the design, the
validity argument and the bound on the card). Each sweep advances up to K
steps: the grid is cut into tiles of TH x TW owned cells, and each tile
steps its window (owned cells plus a halo of K, clipped at the domain) and
keeps its owned cells. :func:`tile_spans` is the tiling rule the kernel
computes for itself; :func:`tile_order` lists the tiles its persistent
blocks walk, edge tiles first (:func:`interior_tiles` counts the others,
which its register body steps); :func:`pick_sweep_depth` chooses (K, TH,
TW) for this card; :func:`fdtd_multistep_ttiled_reference` emulates the
tiling with plain torch ops.

:func:`fdtd_multistep_ttiled` dispatches on the device of ``Ez``: a CPU
tensor goes to the emulation; a CUDA tensor launches the kernel or raises —
there is no fallback. Both take the staggered (or padded) layout and return
new tensors in the staggered shapes; the caller's tensors are never modified.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fdtd2d_tpu_torch.core.sources import source_amplitudes
from fdtd2d_tpu_torch.fdtd.step import MUR_BAND, multistep
# fdtd_fused as a module, its names read at call time: importing it first
# imports fdtd.simulate, which imports this module.
from fdtd2d_tpu_torch.ops import _build, fdtd_fused

S = MUR_BAND + 1  # Mur strip width: least owned cells of a tile, least window offset

SMEM_LIMIT = 232_448   # shared memory one block may use on sm_90 (227 KB)
# The planner's copy of fdtd_ttiled.cu's layout (STATIC_SMEM_BYTES,
# WINDOW_BYTES, staged_bytes, WINDOW); the CPU emulation plans with it, and
# every launch first holds it to what the built kernel reports
# (_check_layout). The static shared memory: the exchange buffers (Ez and Hx
# rows of (5 + 1) x 96 floats, Ez and Hy columns of (3 + 1) x 80), then 128
# B for the mbarrier and the claimed items, which keep the dynamic window
# 128-byte aligned.
STATIC_SMEM_BYTES = 4 * (2 * 6 * 96 + 2 * 4 * 80) + 128
WINDOW_BYTES = 4 * 5 * 80 * 100  # an interior window: 5 TMA boxes of 80 x 100 floats
SMEM_BUDGET = SMEM_LIMIT - STATIC_SMEM_BYTES  # dynamic shared memory, one block an SM
MAX_CELLS = 2**31 - 1  # the kernel indexes its (N, row_stride(M)) arrays with 32-bit ints
# The interior window the kernel's register body holds, rows x columns
# (kWinH x kWinW): 15 warps, 3 across (96 columns) and 5 down, each thread
# holding 16 rows of one column. The planner's tiles fill it.
WINDOW = (80, 96)
# Cap on the window cells stepped per owned cell, minus one. At 4096^2 on
# an H100 (PERF.md section 6, tools/bench_ttiled.py --ksweep) the kernel
# ran 0.07113 ms a step at K = 4 (redundancy 0.21), 0.05841 at K = 6
# (0.34), 0.05089 at K = 8 (0.49), 0.05443 at K = 10 (0.68) and 0.0585 at
# K = 12; the cap admits K = 8 and not K = 10.
MAX_REDUNDANCY = 0.55
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


def row_stride(M: int) -> int:
    """Floats a row of the kernel's arrays holds: M rounded up to a multiple
    of 4, so that every row starts on 16 bytes, as TMA requires."""
    return -(-M // 4) * 4


def window_extent(n: int, T: int, K: int) -> int:
    """The longest window along one axis."""
    return max(w1 - w0 for _, _, w0, w1 in tile_spans(n, T, K))


def interior_span(span, n: int) -> bool:
    """Whether a window ``(own0, own1, win0, win1)`` along an axis of ``n``
    cells lies at least S cells inside the domain at both ends (by the rule
    of :func:`tile_spans`, one that does not start or end at the edge)."""
    return span[2] > 0 and span[3] < n


def interior_tiles(N: int, M: int, K: int, TH: int, TW: int) -> int:
    """Tiles whose window holds no Mur band, corner or domain edge: the
    tiles the kernel's register body steps."""
    rows = sum(interior_span(s, N) for s in tile_spans(N, TH, K))
    cols = sum(interior_span(s, M) for s in tile_spans(M, TW, K))
    return rows * cols


def staged_bytes(WH: int, WW: int) -> int:
    """Shared memory of the edge body for a WH x WW window: Ez, Hx, Hy, ce,
    ch at the odd row stride ``WW | 1``, and the four pre-step Mur strips."""
    ld = WW | 1
    return 4 * (5 * WH * ld + 2 * WH * S + 2 * S * ld)


def smem_bytes(WH: int, WW: int) -> int:
    """Dynamic shared memory of a block when the largest window is WH x WW:
    the edge body's staged window, or the interior window (five fields) that
    is copied in while the previous one steps, whichever is larger. The
    exchange buffers are static (STATIC_SMEM_BYTES) and come on top."""
    return max(staged_bytes(WH, WW), WINDOW_BYTES)


def tile_order(N: int, M: int, K: int, TH: int, TW: int):
    """``(tiles, n_edge)``: every (row tile, column tile) pair once, the
    edge tiles first, then the interior tiles (:func:`interior_tiles`), each
    group in row-major order. The kernel's persistent blocks walk this list,
    so the staged edge bodies run first and interior windows follow one
    another, each copied in while the previous one steps."""
    rows, cols = tile_spans(N, TH, K), tile_spans(M, TW, K)
    edge, inner = [], []
    for a, rspan in enumerate(rows):
        for b, cspan in enumerate(cols):
            inside = interior_span(rspan, N) and interior_span(cspan, M)
            (inner if inside else edge).append((a, b))
    return edge + inner, len(edge)


def redundancy(N: int, M: int, K: int, TH: int, TW: int) -> float:
    """Cells stepped over all windows per cell of the grid, minus one."""
    rows = sum(w1 - w0 for _, _, w0, w1 in tile_spans(N, TH, K))
    cols = sum(w1 - w0 for _, _, w0, w1 in tile_spans(M, TW, K))
    return rows * cols / (N * M) - 1.0


def _tile_ok(n: int, T: int) -> bool:
    # every tile owns at least S cells: the kernel's validity argument
    return T >= n or (T >= S and (n % T == 0 or n % T >= S))


def check_plan(N: int, M: int, K: int, TH: int, TW: int):
    """Raise ``ValueError`` unless the kernel can run this tiling."""
    if K < 1:
        raise ValueError(f"sweep depth K must be >= 1, got {K}")
    for n, T, name in ((N, TH, "TH"), (M, TW, "TW")):
        if not _tile_ok(n, T):
            raise ValueError(f"{name}={T} for {n} cells: every tile must own at "
                             f"least {S} cells (T >= {S}, and n % T == 0 or >= {S})")
    if N * row_stride(M) > MAX_CELLS:
        raise ValueError(f"a {(N, M)} grid has more cells than the kernel's 32-bit "
                         f"indexing reaches ({MAX_CELLS})")
    if interior_tiles(N, M, K, TH, TW) and (TH + 2 * K > WINDOW[0]
                                           or TW + 2 * K > WINDOW[1]):
        raise ValueError(f"interior windows of K={K}, tiles {(TH, TW)} exceed the "
                         f"{WINDOW} cells the kernel's register body holds")
    need = smem_bytes(window_extent(N, TH, K), window_extent(M, TW, K))
    if need > SMEM_BUDGET:
        raise ValueError(f"windows of K={K}, tiles {(TH, TW)} need {need} B of "
                         f"shared memory, more than {SMEM_BUDGET} B")


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
    redundant compute at or below :data:`MAX_REDUNDANCY` and fits the
    kernel (:func:`check_plan`). Raises ``ValueError`` when no depth admits
    the grid."""
    for K in DEPTHS:
        try:
            TH, TW = plan_tiles(N, M, K)
            check_plan(N, M, K, TH, TW)
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
    as one batch, in the kernel's :func:`tile_order`), the plain
    :func:`multistep` runs the sweep's steps on it, and each cell is taken
    from the tile that owns it. The band, corner and source stages of the
    plain step act in domain coordinates, so they apply wherever they fall
    in a window, as in the kernel's edge body; in an interior window none
    falls, which is what lets the kernel's register body leave them out."""
    N, M = Ez.shape
    K, TH, TW = resolve_plan(N, M, K, tile)
    fields = fdtd_fused.pad_state(Ez, Hx, Hy)
    chp = fdtd_fused.pad_field(ch, N, M)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             Ez.dtype, Ez.device)
    rows, cols = tile_spans(N, TH, K), tile_spans(M, TW, K)
    order, _ = tile_order(N, M, K, TH, TW)
    inside = torch.zeros((len(order), N, M), dtype=torch.bool, device=Ez.device)
    owner = torch.empty((1, N, M), dtype=torch.long, device=Ez.device)
    for t, (a, b) in enumerate(order):
        (o0, o1, w0, w1), (p0, p1, v0, v1) = rows[a], cols[b]
        inside[t, w0:w1, v0:v1] = True
        owner[0, o0:o1, p0:p1] = t
    for start in range(0, nsteps, K):
        tiles = [torch.where(inside, f, 0.0) for f in fields]
        multistep(*tiles, ce, chp, coef, amps[start : start + K], sx, sy)
        fields = [t.gather(0, owner)[0] for t in tiles]
    return fdtd_fused.unpad_state(*fields)


@functools.lru_cache(maxsize=16)
def _device_tiles(N: int, M: int, K: int, TH: int, TW: int, device: torch.device):
    """:func:`tile_order`'s list as an int32 tensor on ``device``, built once
    per plan: at 8192^2 the list holds 13,184 tiles, some milliseconds of
    host time that every launch would otherwise pay. The kernel only reads
    it."""
    order, _ = tile_order(N, M, K, TH, TW)
    return torch.tensor(order, dtype=torch.int32).to(device)


@functools.lru_cache(maxsize=16)
def _check_layout(WH: int, WW: int):
    """Raise ``RuntimeError`` unless the built kernel's static and dynamic
    shared memory for a largest window of WH x WW, and its interior window,
    are those the planner admitted the plan with."""
    out = (ctypes.c_int * 4)()
    err = _build.load().fdtd_ttiled_layout(WH, WW, out)
    if err != 0:
        raise RuntimeError(f"fdtd_ttiled_layout failed: CUDA error {err}")
    planned = (STATIC_SMEM_BYTES, smem_bytes(WH, WW), *WINDOW)
    if tuple(out) != planned:
        raise RuntimeError(
            f"ttiled_sweep's layout (static, dynamic shared memory, window rows, "
            f"columns) is {tuple(out)}, the planner's {planned}: update "
            f"ops/fdtd_ttiled.py to match ops/csrc/fdtd_ttiled.cu")


def _strided(a, N: int, ldg: int):
    """A new (N, ldg) tensor (16-byte aligned rows) holding ``a`` at its top
    left, zero elsewhere: the layout of every array the kernel reads."""
    out = a.new_zeros((N, ldg))
    out[: a.shape[0], : a.shape[1]] = a
    return out


def launch(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps: int,
           source_kind: str, step_offset: int, K: int, TH: int, TW: int):
    """Run ``ttiled_sweep`` over ``nsteps`` steps on CUDA tensors; returns the
    fields in the staggered shapes. Counts nothing: its callers do."""
    fdtd_fused.check_kernel_inputs(Ez, Hx, Hy, ce, ch, sx, sy, nsteps)
    check_plan(*Ez.shape, K, TH, TW)
    lib = _build.load()
    N, M = Ez.shape
    ldg = row_stride(M)
    a = tuple(_strided(f, N, ldg) for f in (Ez, Hx, Hy))
    b = tuple(torch.empty_like(f) for f in a)
    cep, chp = _strided(ce, N, ldg), _strided(ch, N, ldg)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             torch.float32, Ez.device)
    WH, WW = window_extent(N, TH, K), window_extent(M, TW, K)
    with torch.cuda.device(Ez.device):
        _check_layout(WH, WW)
    tiles = _device_tiles(N, M, K, TH, TW, Ez.device)
    counters = torch.zeros(-(-nsteps // K), dtype=torch.int32, device=Ez.device)
    # The launches run after this function returns. Freeing amps, cep, chp
    # and counters then is safe: the caching allocator hands their memory
    # only to work queued later on the same stream.
    with torch.cuda.device(Ez.device):
        err = lib.fdtd_ttiled_run(
            *(f.data_ptr() for f in (*a, *b)), cep.data_ptr(), chp.data_ptr(),
            amps.data_ptr(), tiles.data_ptr(), tiles.shape[0], counters.data_ptr(),
            N, M, ldg, TH, TW, K, nsteps, WH, WW, int(sx), int(sy), float(coef),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fdtd_ttiled_run failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")
    sweeps = -(-nsteps // K)
    return fdtd_fused.unpad_state(*(f[:, :M] for f in (b if sweeps % 2 else a)))


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
