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

**Block mode** (the TPU kernel's sharded mode). The kernel's array need not
be the whole domain: a :class:`Block` is a sub-rectangle of an N x M domain,
given by the cells it owns in domain coordinates and a ghost depth G. On a
side where the block does not reach the domain's edge its array holds G >= K
ghost cells beyond the owned ones (the neighbour's cells, which lose one
cell of validity a step); on a side where it does, the array ends at the
edge. Tiles cover the owned cells only; everything else (windows, Mur
bands, corners, the source) is in domain coordinates, so a band or corner
is applied in every window that holds it, in a neighbour's ghost cells too,
and a source outside the array injects nothing. The single-device call is
the block that owns the whole domain. :func:`fdtd_block_sweep` runs one
sweep of a block on buffers kept in the kernel's layout; the sharded rollout
(``parallel/fdtd_sharded.py``) calls it once a block a sweep, with a halo
exchange in between.

:func:`fdtd_multistep_ttiled` and :func:`fdtd_block_sweep` dispatch on the
device of their tensors: a CPU tensor goes to the emulation; a CUDA tensor
launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
MAX_CELLS = 2**31 - 1  # the kernel indexes its (rows, row_stride(cols)) arrays with 32-bit ints
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

# Kernel launches made by fdtd_multistep_ttiled (one per sweep) and by
# fdtd_block_sweep (one per call); a run shows it went through the kernel by
# reading these before and after.
launches = 0
block_launches = 0


def array_extent(n: int, lo: int, hi: int, G: int):
    """``(a0, a1)``: the cells along one axis of ``n`` that the array of a
    block owning ``[lo, hi)`` holds. It reaches G cells past the owned ones,
    except that an end that would lie less than S cells inside the domain
    lies at its edge instead (the rule of :func:`tile_spans`' windows: a Mur
    chain or corner block is whole in the array or not in it at all)."""
    return (lo - G if lo - G >= S else 0), (hi + G if hi + G <= n - S else n)


@dataclasses.dataclass(frozen=True)
class Block:
    """A kernel array as a sub-rectangle of an N x M domain: the cells it
    owns, rows ``[r0, r1)`` and columns ``[c0, c1)`` in domain coordinates,
    and the ghost depth ``G`` on the sides that are not domain edges. The
    array holds rows ``rows`` and columns ``cols`` (:func:`array_extent`);
    a side is a domain edge exactly when the array ends there."""

    N: int
    M: int
    r0: int
    r1: int
    c0: int
    c1: int
    G: int = 0

    @classmethod
    def whole(cls, N: int, M: int) -> "Block":
        """The block of a single-device call: it owns the whole domain."""
        return cls(N, M, 0, N, 0, M)

    @property
    def rows(self):
        return array_extent(self.N, self.r0, self.r1, self.G)

    @property
    def cols(self):
        return array_extent(self.M, self.c0, self.c1, self.G)

    @property
    def shape(self):
        """(rows, columns) of the array."""
        (a0, a1), (b0, b1) = self.rows, self.cols
        return a1 - a0, b1 - b0

    @property
    def array(self):
        """The array's cells as slices of a domain-shaped tensor."""
        return slice(*self.rows), slice(*self.cols)

    @property
    def owned(self):
        """The owned cells as slices of the array."""
        a0, b0 = self.rows[0], self.cols[0]
        return slice(self.r0 - a0, self.r1 - a0), slice(self.c0 - b0, self.c1 - b0)

    @property
    def owned_in_domain(self):
        return slice(self.r0, self.r1), slice(self.c0, self.c1)


def tile_spans(n: int, T: int, K: int, lo: int = 0, hi=None):
    """``[(own0, own1, win0, win1), ...]`` of the tiles along one axis of a
    domain of ``n`` cells, in domain coordinates: tiles of ``T`` owned cells
    (the last one may be shorter) over the owned cells ``[lo, hi)`` (the
    whole axis by default), windows of a halo ``K`` on each side. A window
    that would start less than S cells inside the domain starts at its edge
    instead, and likewise at the far end, so a Mur chain or corner block is
    whole in a window or not in it at all. At an end of the owned cells that
    is not a domain edge the window reaches K cells into the ghost cells.
    ``ttiled_sweep``'s ``tile_span`` computes the same."""
    hi = n if hi is None else hi
    spans = []
    for own0 in range(lo, hi, T):
        own1 = min(own0 + T, hi)
        win0 = own0 - K if own0 - K >= S else 0
        win1 = own1 + K if own1 + K <= n - S else n
        spans.append((own0, own1, win0, win1))
    return spans


def block_spans(block: Block, K: int, TH: int, TW: int):
    """(row spans, column spans) of a block's tiles (:func:`tile_spans`)."""
    return (tile_spans(block.N, TH, K, block.r0, block.r1),
            tile_spans(block.M, TW, K, block.c0, block.c1))


def row_stride(M: int) -> int:
    """Floats a row of the kernel's arrays holds: M rounded up to a multiple
    of 4, so that every row starts on 16 bytes, as TMA requires."""
    return -(-M // 4) * 4


def window_extent(n: int, T: int, K: int, lo: int = 0, hi=None) -> int:
    """The longest window along one axis."""
    return max(w1 - w0 for _, _, w0, w1 in tile_spans(n, T, K, lo, hi))


def interior_span(span, n: int) -> bool:
    """Whether a window ``(own0, own1, win0, win1)`` along an axis of a
    domain of ``n`` cells lies at least S cells inside the domain at both
    ends (by the rule of :func:`tile_spans`, one that does not start or end
    at the domain's edge). A window at a block's ghost boundary is inside."""
    return span[2] > 0 and span[3] < n


def interior_tiles(N: int, M: int, K: int, TH: int, TW: int, block=None) -> int:
    """Tiles whose window holds no Mur band, corner or domain edge: the
    tiles the kernel's register body steps."""
    rspans, cspans = block_spans(block or Block.whole(N, M), K, TH, TW)
    return (sum(interior_span(s, N) for s in rspans)
            * sum(interior_span(s, M) for s in cspans))


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


def tile_order(N: int, M: int, K: int, TH: int, TW: int, block=None):
    """``(tiles, n_edge)``: every (row tile, column tile) pair once, the
    edge tiles first, then the interior tiles (:func:`interior_tiles`), each
    group in row-major order. The kernel's persistent blocks walk this list,
    so the staged edge bodies run first and interior windows follow one
    another, each copied in while the previous one steps."""
    rows, cols = block_spans(block or Block.whole(N, M), K, TH, TW)
    edge, inner = [], []
    for a, rspan in enumerate(rows):
        for b, cspan in enumerate(cols):
            inside = interior_span(rspan, N) and interior_span(cspan, M)
            (inner if inside else edge).append((a, b))
    return edge + inner, len(edge)


def redundancy(N: int, M: int, K: int, TH: int, TW: int, block=None) -> float:
    """Cells stepped over all windows per owned cell, minus one."""
    block = block or Block.whole(N, M)
    rspans, cspans = block_spans(block, K, TH, TW)
    rows = sum(w1 - w0 for _, _, w0, w1 in rspans)
    cols = sum(w1 - w0 for _, _, w0, w1 in cspans)
    return rows * cols / ((block.r1 - block.r0) * (block.c1 - block.c0)) - 1.0


def _tile_ok(n: int, T: int) -> bool:
    # every tile owns at least S cells: the kernel's validity argument
    return T >= n or (T >= S and (n % T == 0 or n % T >= S))


def check_plan(N: int, M: int, K: int, TH: int, TW: int, block=None):
    """Raise ``ValueError`` unless the kernel can run this tiling (of the
    block's owned cells where ``block`` is given, else of the whole N x M
    domain)."""
    block = block or Block.whole(N, M)
    if (block.N, block.M) != (N, M):
        raise ValueError(f"the block's domain {(block.N, block.M)} is not {(N, M)}")
    if K < 1:
        raise ValueError(f"sweep depth K must be >= 1, got {K}")
    owned = (block.r1 - block.r0, block.c1 - block.c0)
    for n, T, name in ((owned[0], TH, "TH"), (owned[1], TW, "TW")):
        if n < 1 or not _tile_ok(n, T):
            raise ValueError(f"{name}={T} for {n} cells: every tile must own at "
                             f"least {S} cells (T >= {S}, and n % T == 0 or >= {S})")
    AN, AM = block.shape
    if AN * row_stride(AM) > MAX_CELLS:
        raise ValueError(f"a {(AN, AM)} grid has more cells than the kernel's 32-bit "
                         f"indexing reaches ({MAX_CELLS})")
    rspans, cspans = block_spans(block, K, TH, TW)
    for spans, (a0, a1), axis in ((rspans, block.rows, "rows"), (cspans, block.cols, "columns")):
        if spans[0][2] < a0 or spans[-1][3] > a1:
            raise ValueError(f"windows of halo K={K} reach past the block's {axis} "
                             f"{(a0, a1)}: its ghost depth G={block.G} must be >= K")
    if interior_tiles(N, M, K, TH, TW, block) and (TH + 2 * K > WINDOW[0]
                                                  or TW + 2 * K > WINDOW[1]):
        raise ValueError(f"interior windows of K={K}, tiles {(TH, TW)} exceed the "
                         f"{WINDOW} cells the kernel's register body holds")
    need = smem_bytes(max(w1 - w0 for _, _, w0, w1 in rspans),
                      max(w1 - w0 for _, _, w0, w1 in cspans))
    if need > SMEM_BUDGET:
        raise ValueError(f"windows of K={K}, tiles {(TH, TW)} need {need} B of "
                         f"shared memory, more than {SMEM_BUDGET} B")


def fit_tile(n, target: int) -> int:
    """The largest tile of at most ``target`` cells that tiles ``n`` cells
    with every tile owning at least S; ``n`` itself when it fits. ``n`` may
    be a tuple of extents (the blocks of a sharded axis): the tile then
    fits each of them."""
    extents = (n,) if isinstance(n, int) else tuple(n)
    if max(extents) <= target:
        return max(extents)
    for T in range(target, S - 1, -1):
        if all(_tile_ok(e, T) for e in extents):
            return T
    raise ValueError(f"no tile of {S}..{target} cells tiles {extents} cells")


def plan_tiles(N, M, K: int):
    """(TH, TW) whose windows at halo ``K`` are about :data:`WINDOW`; ``N``
    and ``M`` are the owned extents (each an int or a tuple of them)."""
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


def block_sweep_reference(block: Block, src, dst, ce, ch, coef, amps, sx, sy,
                          K: int, TH: int, TW: int):
    """Plain torch emulation of one sweep of ``len(amps)`` <= K steps on a
    block, in the dtype and on the device of ``src``. ``src`` and ``dst``
    are (3, rows, >= columns) stacks of Ez, Hx, Hy over the block's array
    (padded layout: Hx's last domain column and Hy's last domain row are
    phantom cells), ``ce`` and ``ch`` (rows, >= columns) likewise. Each
    tile's window is set into a zero grid of the domain's shape (all tiles
    as one batch, in the kernel's :func:`tile_order`), the plain
    :func:`multistep` runs the sweep's steps on it, and each owned cell of
    ``dst`` is taken from the tile that owns it; no other cell of ``dst`` is
    written, as in the kernel. The band, corner and source stages of the
    plain step act in domain coordinates, so they apply wherever they fall
    in a window, ghost cells included, as in the kernel's edge body; in an
    interior window none falls, which is what lets the kernel's register
    body leave them out."""
    N, M = block.N, block.M
    AN, AM = block.shape
    rows, cols = block_spans(block, K, TH, TW)
    order, _ = tile_order(N, M, K, TH, TW, block)
    inside = torch.zeros((len(order), N, M), dtype=torch.bool, device=src.device)
    owner = torch.zeros((1, N, M), dtype=torch.long, device=src.device)
    for t, (a, b) in enumerate(order):
        (o0, o1, w0, w1), (p0, p1, v0, v1) = rows[a], cols[b]
        inside[t, w0:w1, v0:v1] = True
        owner[0, o0:o1, p0:p1] = t

    def in_domain(a):
        full = a.new_zeros((N, M))
        full[block.array] = a[:, :AM]
        return full

    tiles = [torch.where(inside, in_domain(f), 0.0) for f in src]
    multistep(*tiles, in_domain(ce), in_domain(ch), coef, amps, sx, sy)
    for f, t in zip(dst, tiles):
        f[block.owned] = t.gather(0, owner)[0][block.owned_in_domain]


def fdtd_multistep_ttiled_reference(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy,
                                    nsteps: int, source_kind: str, step_offset: int,
                                    K=None, tile=None):
    """Plain torch emulation of the tiling, in the dtype and on the device of
    ``Ez``: :func:`block_sweep_reference` on the block that owns the whole
    domain, once a sweep, between two sets of buffers, as the kernel's
    sweeps run."""
    N, M = Ez.shape
    K, TH, TW = resolve_plan(N, M, K, tile)
    cur = torch.stack(fdtd_fused.pad_state(Ez, Hx, Hy))
    other = torch.empty_like(cur)
    chp = fdtd_fused.pad_field(ch, N, M)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             Ez.dtype, Ez.device)
    block = Block.whole(N, M)
    for start in range(0, nsteps, K):
        block_sweep_reference(block, cur, other, ce, chp, coef, amps[start : start + K],
                              sx, sy, K, TH, TW)
        cur, other = other, cur
    return fdtd_fused.unpad_state(*cur)


@functools.lru_cache(maxsize=64)
def _device_tiles(block: Block, K: int, TH: int, TW: int, device: torch.device):
    """:func:`tile_order`'s list as an int32 tensor on ``device``, built once
    per plan: at 8192^2 the list holds 13,184 tiles, some milliseconds of
    host time that every launch would otherwise pay. The kernel only reads
    it."""
    order, _ = tile_order(block.N, block.M, K, TH, TW, block)
    return torch.tensor(order, dtype=torch.int32).to(device)


@functools.lru_cache(maxsize=64)
def _checked_windows(block: Block, K: int, TH: int, TW: int):
    """(WH, WW), the largest window of the tiling, after :func:`check_plan`;
    cached, so that a rollout's launch a sweep does not walk the tiles."""
    check_plan(block.N, block.M, K, TH, TW, block)
    return (window_extent(block.N, TH, K, block.r0, block.r1),
            window_extent(block.M, TW, K, block.c0, block.c1))


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


def check_block_buffers(block: Block, src, dst, ce, ch, amps, counters):
    """Raise ``ValueError`` unless the buffers are what the kernel takes for
    ``block``: float32 on one CUDA device, the field sets (3, rows, ld) and
    ``ce``/``ch`` (rows, ld) contiguous with ld = :func:`row_stride` of the
    array's columns, ``counters`` int32 with an element a sweep."""
    AN, AM = block.shape
    ldg = row_stride(AM)
    for name, t, shape in (("src", src, (3, AN, ldg)), ("dst", dst, (3, AN, ldg)),
                           ("ce", ce, (AN, ldg)), ("ch", ch, (AN, ldg))):
        if t.device != src.device or t.dtype != torch.float32:
            raise ValueError(f"the CUDA kernels take float32 tensors on one device; "
                             f"{name} is {t.dtype} on {t.device}, src on {src.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor for a block "
                             f"of {(AN, AM)} cells, got {tuple(t.shape)}")
    if src.data_ptr() == dst.data_ptr():
        raise ValueError("src and dst must be two sets of buffers")
    if amps.device != src.device or amps.dtype != torch.float32 or not amps.is_contiguous():
        raise ValueError("amps must be a contiguous float32 tensor on the fields' device")
    if (counters.device != src.device or counters.dtype != torch.int32
            or not counters.is_contiguous()):
        raise ValueError("counters must be a contiguous int32 tensor on the fields' device")


def launch_block(block: Block, a, b, ce, ch, coef: float, amps, counters, sx: int, sy: int,
                 K: int, TH: int, TW: int):
    """Run ``ttiled_sweep`` over ``len(amps)`` steps of ``block`` on CUDA
    buffers in the kernel's layout (:func:`check_block_buffers`):
    ``ceil(len(amps) / K)`` sweeps, the first reading set ``a`` and writing
    the owned cells of set ``b``, the next the other way round. ``counters``
    holds a zero for each sweep. ``(sx, sy)`` is the source in domain
    coordinates; it may lie outside the array. Counts nothing: its callers
    do."""
    nsteps = amps.shape[0]
    sweeps = -(-nsteps // K)
    if counters.shape[0] < sweeps:
        raise ValueError(f"{sweeps} sweeps need as many counters, got {counters.shape[0]}")
    check_block_buffers(block, a, b, ce, ch, amps, counters)
    WH, WW = _checked_windows(block, K, TH, TW)
    lib = _build.load()
    AN, AM = block.shape
    with torch.cuda.device(a.device):
        _check_layout(WH, WW)
        tiles = _device_tiles(block, K, TH, TW, a.device)
        # the six fields' addresses by arithmetic: indexing the stacks would
        # make six view tensors a launch
        field_bytes = AN * a.shape[2] * 4
        err = lib.fdtd_ttiled_run(
            *(s.data_ptr() + k * field_bytes for s in (a, b) for k in range(3)),
            ce.data_ptr(), ch.data_ptr(),
            amps.data_ptr(), tiles.data_ptr(), tiles.shape[0], counters.data_ptr(),
            block.N, block.M, a.shape[2], block.r0, block.r1, block.c0, block.c1,
            block.rows[0], block.cols[0], AN, AM, TH, TW, K, nsteps, WH, WW,
            int(sx), int(sy), float(coef), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fdtd_ttiled_run failed: CUDA error {err} "
                           f"({lib.fdtd_error_string(err).decode()})")


def launch(Ez, Hx, Hy, ce, ch, coef, dt, fc, sx, sy, nsteps: int,
           source_kind: str, step_offset: int, K: int, TH: int, TW: int):
    """Run ``ttiled_sweep`` over ``nsteps`` steps on CUDA tensors, as the
    block that owns the whole domain; returns the fields in the staggered
    shapes. Counts nothing: its callers do."""
    fdtd_fused.check_kernel_inputs(Ez, Hx, Hy, ce, ch, sx, sy, nsteps)
    N, M = Ez.shape
    ldg = row_stride(M)
    a = torch.stack([_strided(f, N, ldg) for f in (Ez, Hx, Hy)])
    b = torch.empty_like(a)
    cep, chp = _strided(ce, N, ldg), _strided(ch, N, ldg)
    amps = source_amplitudes(source_kind, step_offset, nsteps, dt, fc,
                             torch.float32, Ez.device)
    sweeps = -(-nsteps // K)
    counters = torch.zeros(sweeps, dtype=torch.int32, device=Ez.device)
    # The launches run after this function returns. Freeing amps, cep, chp
    # and counters then is safe: the caching allocator hands their memory
    # only to work queued later on the same stream.
    if nsteps:
        launch_block(Block.whole(N, M), a, b, cep, chp, coef, amps, counters, sx, sy,
                     K, TH, TW)
    return fdtd_fused.unpad_state(*(f[:, :M] for f in (b if sweeps % 2 else a)))


def fdtd_block_sweep(block: Block, src, dst, ce, ch, coef: float, amps, counter,
                     sx: int, sy: int, K: int, tile):
    """One sweep of ``len(amps)`` <= K steps of ``block``, with tiles of
    ``tile`` = (TH, TW) owned cells: reads the field set ``src``, writes the
    owned cells of ``dst`` and no other. The buffers stay in the kernel's
    layout across calls (:func:`check_block_buffers`: stacks of Ez, Hx, Hy
    over the block's array with rows of :func:`row_stride` floats, ``ce``
    and ``ch`` likewise, ``ch`` padded with zeros to the domain's shape);
    ``counter`` is a zeroed int32 element that the kernel's blocks claim
    tiles from (unused on the CPU). The ghost cells of ``src`` must hold the
    neighbours' values K deep; the source ``(sx, sy)``, in domain
    coordinates, may lie outside the array. CPU tensors run the emulation
    in their own dtype; CUDA tensors launch the kernel (float32) or raise."""
    global block_launches
    TH, TW = tile
    if not 0 < amps.shape[0] <= K:
        raise ValueError(f"a sweep takes 1..K={K} steps, got {amps.shape[0]}")
    if src.device.type == "cpu":
        _checked_windows(block, K, TH, TW)
        return block_sweep_reference(block, src, dst, ce, ch, coef, amps, sx, sy, K, TH, TW)
    if src.device.type != "cuda":
        raise ValueError(f"no K2 kernel for device {src.device}")
    launch_block(block, src, dst, ce, ch, coef, amps, counter, sx, sy, K, TH, TW)
    block_launches += 1


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
