"""Sharded FDTD rollout: one block of the grid a mesh entry, a halo exchange
and one K-step sweep of the temporally tiled kernel (K2, block mode) a block
a sweep.

Counterpart of ``fdtd2d_tpu/parallel/fdtd_sharded.py``. The JAX package runs
one SPMD program over a mesh (``shard_map`` + ``ppermute``); the port is one
process that holds every block and drives them in turn:

- The N x M grid is cut into Dr x Dc blocks (:func:`mesh_blocks`), block
  (r, c) on ``mesh.devices[r, c]`` (a 1D mesh is Dc = 1). Each block keeps
  two sets of Ez, Hx, Hy and its ce and ch over its array — its owned cells
  plus G >= K ghost cells on every side that is not a domain edge
  (``ops/fdtd_ttiled.py::Block``) — in the kernel's layout for the whole
  rollout; nothing is padded or copied per sweep but the halos.
- Per sweep: the exchange, **columns first, then full-width rows**, so that
  the corner ghost cells arrive with the row strips; one strided copy moves
  a strip of all three fields. Then one :func:`~fdtd2d_tpu_torch.ops.
  fdtd_ttiled.fdtd_block_sweep` a block, which reads one set and writes the
  owned cells of the other. The kernel never writes a ghost cell: the
  exchange fills every one of them before the sweep that reads it. The
  coefficients' ghost cells hold the neighbours' true values from set-up on
  and are never exchanged.
- The last sweep has depth ``nsteps % K``; frames land on sweep multiples.

On one device all blocks share the current stream and the order is the
program's. Where two blocks lie on different CUDA devices, a strip copy is
ordered against both devices' streams with events (:func:`_copy_strip`).
There is no ``torch.distributed`` here: one process drives every device.

With ``kernel=False`` the same rollout loop steps each block with the plain step
instead (:func:`~fdtd2d_tpu_torch.ops.fdtd_ttiled.block_sweep_reference`, any
dtype and device): over the kernel's tiles it is the kernel's emulation on
whatever device holds the blocks; with one window a block
(:func:`simulate_sharded_plain`) it is the port's form of the JAX package's
GSPMD path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from fdtd2d_tpu_torch.core.sources import source_amplitudes
from fdtd2d_tpu_torch.fdtd.step import precompute_coefficients
from fdtd2d_tpu_torch.ops import fdtd_fused, fdtd_ttiled
from fdtd2d_tpu_torch.ops.fdtd_ttiled import Block, S
from fdtd2d_tpu_torch.parallel.mesh import Mesh, block_bounds

# Strip copies made by the halo exchanges of the last rollout; a run shows
# what an exchange costs by reading it beside the kernel's launch counter.
exchange_copies = 0


def mesh_blocks(N: int, M: int, Dr: int, Dc: int, G: int) -> List[List[Block]]:
    """The Dr x Dc blocks of an N x M grid at ghost depth ``G``; entry
    ``[r][c]`` owns rows ``block_bounds(N, Dr)[r]`` and columns
    ``block_bounds(M, Dc)[c]``, and its ``rows``, ``cols`` and ``owned`` give
    the ghosted and the owned spans."""
    return [[Block(N, M, r0, r1, c0, c1, G) for c0, c1 in block_bounds(M, Dc)]
            for r0, r1 in block_bounds(N, Dr)]


def _resolve_plan(N: int, M: int, Dr: int, Dc: int, K=None, tile=None):
    """(K, G, TH, TW) for a Dr x Dc decomposition, ``K`` and ``tile``
    overriding the planner where given; raises ``ValueError`` when the
    kernel cannot run it."""
    rows, cols = block_bounds(N, Dr), block_bounds(M, Dc)
    extents = (tuple({hi - lo for lo, hi in rows}), tuple({hi - lo for lo, hi in cols}))
    reason = f"no temporally tiled plan for a {(N, M)} grid over {Dr} x {Dc} blocks"
    for depth in (fdtd_ttiled.DEPTHS if K is None else (K,)):
        G = depth
        # a block's ghost cells must all be its adjacent neighbour's owned cells
        if any(D > 1 and min(ext) < max(G, S) for D, ext in zip((Dr, Dc), extents)):
            reason = (f"blocks of {min(extents[0])} x {min(extents[1])} cells own fewer "
                      f"than max(G, {S}) = {max(G, S)} cells along a sharded axis")
            continue
        try:
            TH, TW = tile if tile is not None else fdtd_ttiled.plan_tiles(*extents, depth)
            blocks = [b for row in mesh_blocks(N, M, Dr, Dc, G) for b in row]
            for block in blocks:
                fdtd_ttiled.check_plan(N, M, depth, TH, TW, block)
        except ValueError as err:
            reason = str(err)
            continue
        stepped = sum((fdtd_ttiled.redundancy(N, M, depth, TH, TW, b) + 1)
                      * (b.r1 - b.r0) * (b.c1 - b.c0) for b in blocks)
        if K is not None or stepped / (N * M) - 1.0 <= fdtd_ttiled.MAX_REDUNDANCY:
            return depth, G, TH, TW
        reason = f"every depth steps more than {1 + fdtd_ttiled.MAX_REDUNDANCY} x the grid"
    raise ValueError(reason)


def plan_sharded_ttiled_2d(N: int, M: int, Dr: int, Dc: int):
    """``(K, G, TH, TW)`` admitting the sharded kernel path on Dr x Dc
    blocks, or None: the sweep depth, the ghost depth (G = K) and the tile
    every block is cut into. (The JAX package's tuple is (K, GH, PH, GW): its
    panel height PH means nothing here, as in ``pick_sweep_depth``.) Blocks
    need not divide the grid evenly; each must own at least max(G, 6) cells
    along a sharded axis, and the deepest K is taken whose redundant compute
    stays under the single-device cap."""
    try:
        return _resolve_plan(N, M, Dr, Dc)
    except ValueError:
        return None


def plan_sharded_ttiled(N: int, M: int, D: int):
    """:func:`plan_sharded_ttiled_2d` for D row blocks (a 1D mesh)."""
    return plan_sharded_ttiled_2d(N, M, D, 1)


def _copy_strip(dst: torch.Tensor, src: torch.Tensor):
    """``dst.copy_(src)`` for one halo strip. On one device (or the CPU) the
    current stream orders it. Between two CUDA devices it is ordered against
    both blocks' kernels with events on their current streams: the copy
    waits for the sweep that wrote ``src``, and the sweep that will
    overwrite ``src`` waits for the copy. (No machine with two cards has run
    this branch yet.)"""
    if dst.device == src.device or dst.device.type != "cuda":
        dst.copy_(src, non_blocking=True)
        return
    src_stream = torch.cuda.current_stream(src.device)
    dst_stream = torch.cuda.current_stream(dst.device)
    dst_stream.wait_event(src_stream.record_event())
    with torch.cuda.device(dst.device):
        dst.copy_(src, non_blocking=True)
    src_stream.wait_event(dst_stream.record_event())


def exchange_plan(blocks: List[List[Block]]):
    """The strip copies of one exchange, in order: ``(dst, dst_slices, src,
    src_slices)`` with ``dst`` and ``src`` as (r, c) block indices and the
    slices into their arrays. First every block's ghost columns, over the
    array's full height, from its left and right neighbours' owned columns;
    then its ghost rows, over the array's full width, from the neighbours
    above and below, whose ghost columns the first phase has just filled."""
    def local(block, rows, cols):
        a0, b0 = block.rows[0], block.cols[0]
        return slice(rows[0] - a0, rows[1] - a0), slice(cols[0] - b0, cols[1] - b0)

    copies = []
    for r, row in enumerate(blocks):
        for c, blk in enumerate(row):
            for cols, nc in (((blk.cols[0], blk.c0), c - 1), ((blk.c1, blk.cols[1]), c + 1)):
                if cols[0] < cols[1]:
                    copies.append(((r, c), local(blk, blk.rows, cols),
                                   (r, nc), local(row[nc], blk.rows, cols)))
    for r, row in enumerate(blocks):
        for c, blk in enumerate(row):
            for rows, nr in (((blk.rows[0], blk.r0), r - 1), ((blk.r1, blk.rows[1]), r + 1)):
                if rows[0] < rows[1]:
                    copies.append(((r, c), local(blk, rows, blk.cols),
                                   (nr, c), local(blocks[nr][c], rows, blk.cols)))
    return copies


def _schedule(nsteps: int, nframes: int, K: int, by_sweeps: bool):
    """``[(steps, snapshot after it), ...]``, the sweeps of a rollout. With
    ``by_sweeps`` frames land on sweep multiples, as in the JAX sharded
    kernel path: ``nsteps // K`` full sweeps, a frame every ``sweeps //
    nframes`` of them, then a sweep of ``nsteps % K``. Otherwise frames are
    ``simulate``'s, every ``nsteps // nframes`` steps, each cut into sweeps
    of at most K."""
    if by_sweeps:
        full, rem = divmod(nsteps, K)
        frames = min(nframes, full) if nframes > 0 else 0
        per_frame = full // frames if frames else 0
        sweeps = [(K, frames > 0 and (s + 1) % per_frame == 0 and s < frames * per_frame)
                  for s in range(full)]
        return sweeps + ([(rem, False)] if rem else [])
    per_frame = max(nsteps // max(nframes, 1), 1)
    frames = nsteps // per_frame if nframes > 0 else 0
    segments = [(per_frame, True)] * frames
    if nsteps - frames * per_frame:
        segments.append((nsteps - frames * per_frame, False))
    sweeps = []
    for steps, snap in segments:
        cuts = [min(K, steps - done) for done in range(0, steps, K)]
        sweeps += [(n, snap and i == len(cuts) - 1) for i, n in enumerate(cuts)]
    return sweeps


@dataclasses.dataclass
class _BlockState:
    """One block's buffers, on its device, in the kernel's layout."""

    block: Block
    sets: List[torch.Tensor]        # two (3, rows, ld) stacks of Ez, Hx, Hy
    ce: torch.Tensor                # (rows, ld)
    ch: torch.Tensor                # (rows, ld), zero outside the staggered domain
    amps: torch.Tensor              # the rollout's source amplitudes
    counters: Optional[torch.Tensor]  # a zeroed int32 a sweep (CUDA only)


def _rollout(eps, mu, config, mesh: Mesh, state, K: int, G: int, tile, by_sweeps: bool,
             kernel: bool = True, fill: float = 0.0):
    """The rollout loop behind every entry point. With ``kernel`` each sweep is K2's
    block mode (:func:`~fdtd2d_tpu_torch.ops.fdtd_ttiled.fdtd_block_sweep`:
    the CUDA kernel on CUDA blocks, its emulation on CPU blocks); without, the
    plain step on the windows of ``tile`` (one window a block when ``tile`` is
    None) on whatever device holds the block. ``fill`` is what the buffers
    hold before set-up writes them (a test passes NaN to show that no sweep
    reads a cell the exchange has not filled)."""
    global exchange_copies
    Dr, Dc = mesh.grid_shape
    devices = mesh.devices.reshape(Dr, Dc)
    first = devices[0, 0]
    dtype = config.dtype
    eps = torch.as_tensor(eps, dtype=dtype, device=first)
    mu = torch.as_tensor(mu, dtype=dtype, device=first)
    N, M = eps.shape
    ce, ch, coef = precompute_coefficients(eps, mu, config.dt, config.dx, dtype)
    coef = float(coef)
    if state is None:
        fields = torch.zeros((3, N, M), dtype=dtype, device=first)
    else:
        fields = torch.stack([fdtd_fused.pad_field(
            torch.as_tensor(f, dtype=dtype, device=first), N, M) for f in state])
    coeffs = torch.stack([ce, fdtd_fused.pad_field(ch, N, M)])
    del eps, mu, ce, ch

    blocks = mesh_blocks(N, M, Dr, Dc, G)
    sweeps = _schedule(config.nsteps, config.nframes, K, by_sweeps)
    sx, sy = config.source_xy
    states = {}
    for r in range(Dr):
        for c in range(Dc):
            blk, dev = blocks[r][c], devices[r, c]
            AN, AM = blk.shape
            shape = (AN, fdtd_ttiled.row_stride(AM))
            sets = [torch.full((3, *shape), fill, dtype=dtype, device=dev) for _ in range(2)]
            sets[0][:, :, :AM] = fields[(slice(None), *blk.array)]
            cc = torch.zeros((2, *shape), dtype=dtype, device=dev)
            cc[:, :, :AM] = coeffs[(slice(None), *blk.array)]
            states[r, c] = _BlockState(
                blk, sets, cc[0], cc[1],
                source_amplitudes(config.source_kind, 0, config.nsteps, config.dt,
                                  config.source_fc, dtype, dev),
                torch.zeros(len(sweeps), dtype=torch.int32, device=dev)
                if dev.type == "cuda" else None)
    del fields, coeffs
    # the strips of both buffer sets, sliced once for the whole rollout
    strips = [[(states[d].sets[k][(slice(None), *dsl)], states[s].sets[k][(slice(None), *ssl)])
               for d, dsl, s, ssl in exchange_plan(blocks)] for k in range(2)]

    def gather(cur: int, field=None):
        """Every block's owned cells of set ``cur`` (of one field, or all
        three stacked) as one domain-shaped tensor on the first device."""
        out = torch.empty((N, M) if field is not None else (3, N, M), dtype=dtype, device=first)
        for st in states.values():
            part = st.sets[cur] if field is None else st.sets[cur][field]
            out[(..., *st.block.owned_in_domain)] = part[(..., *st.block.owned)]
        return out

    snaps = []
    exchange_copies, cur, done = 0, 0, 0
    for s, (steps, snap) in enumerate(sweeps):
        for dst, src in strips[cur]:
            _copy_strip(dst, src)
        exchange_copies += len(strips[cur])
        for st in states.values():
            amps = st.amps[done : done + steps]
            src, dst = st.sets[cur], st.sets[1 - cur]
            if kernel:
                fdtd_ttiled.fdtd_block_sweep(
                    st.block, src, dst, st.ce, st.ch, coef, amps,
                    None if st.counters is None else st.counters[s:], sx, sy, K, tile)
            else:
                own = (st.block.r1 - st.block.r0, st.block.c1 - st.block.c0)
                fdtd_ttiled.block_sweep_reference(st.block, src, dst, st.ce, st.ch, coef,
                                                  amps, sx, sy, K, *(tile or own))
        cur, done = 1 - cur, done + steps
        if snap:
            snaps.append(gather(cur, 0))
    Ez, Hx, Hy = gather(cur)
    return fdtd_fused.unpad_state(Ez, Hx, Hy), (torch.stack(snaps) if snaps else None)


def simulate_sharded_ttiled(eps, mu, config, mesh: Mesh, state=None, K=None, tile=None):
    """FDTD rollout sharded over a 1D (row) or 2D (rows x columns) mesh, each
    block stepped by the temporally tiled kernel in block mode (see the
    module docstring). ``eps``, ``mu`` and ``state`` are arrays or tensors,
    ``state`` in the staggered or the padded layout; the fields run in
    ``config.dtype`` on the mesh's devices (``config.device`` is not read),
    float32 only on CUDA blocks.

    Returns ``((Ez, Hx, Hy), snapshots)`` on the mesh's first device, in the
    single-device staggered shapes; ``snapshots`` is (nframes, N, M) or None,
    and frame boundaries land on K-step sweep multiples. ``K`` and ``tile``
    = (TH, TW) override :func:`plan_sharded_ttiled_2d`'s choice. Raises
    ``ValueError`` when the shape does not admit the decomposition."""
    Dr, Dc = mesh.grid_shape
    N, M = torch.as_tensor(eps).shape
    K, G, TH, TW = _resolve_plan(N, M, Dr, Dc, K, tile)
    return _rollout(eps, mu, config, mesh, state, K, G, (TH, TW), by_sweeps=True)


def simulate_sharded_ttiled_2d(eps, mu, config, mesh: Mesh, state=None, K=None, tile=None):
    """:func:`simulate_sharded_ttiled` under the JAX package's name for a 2D
    mesh. As there, snapshots are not taken on this path (``config.nframes``
    must be 0) and the mesh must have two axes."""
    if mesh.devices.ndim != 2:
        raise ValueError("use simulate_sharded_ttiled for 1D meshes")
    if config.nframes:
        raise ValueError("snapshots are not supported on the 2D ttiled path")
    return simulate_sharded_ttiled(eps, mu, config, mesh, state, K, tile)


def simulate_sharded_plain(eps, mu, config, mesh: Mesh, state=None):
    """The same decomposition and exchange with the plain step as each
    block's engine, in any dtype, on any device; frames are ``simulate``'s.
    The sweep depth is the kernel's deepest, cut to what the smallest block
    owns; a block must own at least 6 cells along a sharded axis."""
    Dr, Dc = mesh.grid_shape
    N, M = torch.as_tensor(eps).shape
    sharded = [min(hi - lo for lo, hi in block_bounds(n, D))
               for n, D in ((N, Dr), (M, Dc)) if D > 1]
    if sharded and min(sharded) < S:
        raise ValueError(f"grid {(N, M)} over {Dr} x {Dc} blocks: a block owns "
                         f"{min(sharded)} cells along a sharded axis, fewer than {S}")
    K = min([fdtd_ttiled.DEPTHS[0], *sharded])
    return _rollout(eps, mu, config, mesh, state, K, K, None, by_sweeps=False, kernel=False)
