"""The HPS sweeps — CUDA level-kernel wrapper, planner and plain version.

For the nested-dissection factors of fdfd/hps.py, a leaf ``(Y, E, table)``
(Y (..., B, nI, nI), E (..., B, nI, rho), table (B, nI + rho): each leaf
box's interior, then ring, points in the sublattice grid), the merge levels
``(Y, E, table, order)`` bottom up (Y (..., P, nJ, nJ), E (..., P, nJ, nR),
table (P, nJ + nR): where each eliminated (J), then kept (R), point of a
parent lies among its two children's skeletons, child box x rho + position;
order (2 P rho,): the inverse, each child point's place p (nJ + nR) + t)
and the root's inverse ``Yroot`` (..., rho, rho), the two sweeps

    up    g = Y b_J,        b_parent = b_R - E^T b_J     (leaf, then each level)
    root  x_R = Yroot b_root
    down  x_J = g - E x_R,  x_J and x_R to the children  (each level, then the leaf)

give x = A^{-1} b for right-hand sides b (..., K, nr nc), the layout that
``direct.split_sublattices`` gives stacked, so no transpose is needed. The
leading axes are groups (the four sublattices). :func:`hps_sweeps` runs each
level and direction as one launch of ``ops/csrc/fdfd_hps.cu`` (its header
gives the design and what bounds it), the root as one ``torch.matmul``, on
CUDA complex64 contiguous tensors only, and raises on anything else: there
is no fallback. :func:`hps_sweeps_reference` is its plain version, the same
tables, buffers and layouts walked by torch ops; fdfd/hps.py keeps its own
torch path, ``_solve_cols``, for every other input (CPU tensors, complex128
factors).

Right-hand sides run in chunks of at most 16, each padded to 1, 4, 8 or 16
(the kernel's instantiations). The children's skeletons of a chunk live in
two buffers, (groups, points, kp) each, that the levels take in turn (level
l's children in buffer l mod 2), and every level's g stays for the way down.
On the way up each level writes its parents' rows where the next level reads
them, in that level's J-then-R order (``order``), so a merge reads its
vectors in order and only the leaf gathers (from the grid); on the way down
each level scatters x_J and x_R to the children's ring order (``table``).
:func:`plan_level` cuts a launch from its shapes alone. Spans (utils/trace.py):
``fdfd.hps.up``, ``fdfd.hps.root`` and ``fdfd.hps.down`` a chunk, and the
counters ``fdfd.hps.levels`` (merge levels walked, up plus down) and
``fdfd.kernels.hps_sweeps``, one a launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence, Tuple

import torch

from fdtd2d_tpu_torch.ops import _build, fdtd_fused
from fdtd2d_tpu_torch.utils.trace import count, span

THREADS = 256       # a CTA
STAGES = 2          # the ring: the next chunk in flight while one is computed
KPADS = (1, 4, 8, 16)   # the right-hand sides of a chunk, padded: the kernel's instantiations
KCHUNK = KPADS[-1]
MAX_TERMS = 128     # terms a ring stage may hold
# SMs and shared memory a block of an H100: what the CPU tests plan with
H100 = (132, 232_448)

Operands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # the leaf's (Y, E, table)
LevelOperands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # and its order


def kpad(k: int) -> int:
    """The instantiation a chunk of k right-hand sides runs in."""
    return next(p for p in KPADS if k <= p)


def rows_a_block(kp: int) -> int:
    """Rows a CTA owns: a thread a row and 4 of its kp right-hand sides (all 1 at kp = 1)."""
    return THREADS // max(1, kp // 4)


def smem_bytes(kp: int, tc: int, ni: int, down: bool) -> int:
    """Dynamic shared memory of a CTA: two ring stages, each the block's
    tc-term factor segments (term by term up; row by row at a stride of
    tc + 1 down) and ni items' tc x kp vector chunks, rows padded to kp + 2
    (kp at kp = 1)."""
    vs = kp if kp < 4 else kp + 2
    rows = rows_a_block(kp)
    factor = rows * (tc + 1) if down else tc * rows
    return 8 * STAGES * (factor + ni * tc * vs)


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    down: bool
    items: int    # groups x parents (boxes at the leaf)
    nJ: int
    nR: int
    kp: int
    tc: int       # terms a ring stage
    ni: int       # the most items a CTA meets

    @property
    def rows(self) -> int:
        """Output rows an item: the rows of Y and of E^T up, of E down."""
        return self.nJ if self.down else self.nJ + self.nR

    @property
    def blocks(self) -> int:
        return -(-self.items * self.rows // rows_a_block(self.kp))

    @property
    def smem(self) -> int:
        return smem_bytes(self.kp, self.tc, self.ni, self.down)


@functools.lru_cache(maxsize=1024)
def plan_level(items: int, nJ: int, nR: int, kp: int, down: bool, sms: int = H100[0],
               smem: int = H100[1]) -> LevelPlan:
    """The launch of one level and direction for ``items`` parents of nJ
    eliminated and nR kept points and a chunk padded to kp, on a device of
    ``sms`` SMs and ``smem`` bytes of shared memory a block: consecutive
    rows to a block (:func:`rows_a_block`), and the even term chunk that
    splits the terms most evenly among the fewest chunks whose ring fits
    two CTAs an SM, or one where the level's blocks do not fill the SMs
    once. Raises ``ValueError`` where not even 2 terms fit."""
    if min(items, nJ, nR) < 1 or kp not in KPADS:
        raise ValueError(f"no HPS level of {items} items, nJ {nJ}, nR {nR}, kp {kp}")
    R, T = (nJ, nR) if down else (nJ + nR, nJ)
    rows = rows_a_block(kp)
    ni = min(items, (rows - 1) // R + 2)
    blocks = -(-items * R // rows)
    budget = smem if blocks <= sms else (smem + 1024) // 2 - 1024
    fits = [tc for tc in range(2, min(MAX_TERMS, T + (T & 1)) + 1, 2)
            if smem_bytes(kp, tc, ni, down) <= budget]
    if not fits:
        raise ValueError(f"an HPS level of nJ {nJ}, nR {nR} at kp {kp} does not fit "
                         f"{smem} bytes of shared memory")
    per = -(-T // -(-T // fits[-1]))   # the terms a chunk, the fewest chunks
    return LevelPlan(down, items, nJ, nR, kp, per + (per & 1), ni)


def _check_operands(leaf: Operands, levels: Sequence[LevelOperands], Yroot, b, *, device):
    """Shapes of the factors, tables and right-hand sides; raise ``ValueError``
    on a mismatch. Returns (lead, [(parents, nJ, nR) a level, the leaf first])."""
    lead = tuple(Yroot.shape[:-2])
    dims = []
    boxes_points = None     # points of the level's children: boxes x rho
    for depth, op in enumerate((leaf, *levels)):
        Y, E, table = op[:3]
        name = "the leaf" if depth == 0 else f"level {depth - 1}"
        if E.dim() != len(lead) + 3 or tuple(E.shape[:len(lead)]) != lead:
            raise ValueError(f"{name}: E has shape {tuple(E.shape)}, leading axes {lead} expected")
        P, nJ, nR = E.shape[-3:]
        if tuple(Y.shape) != lead + (P, nJ, nJ):
            raise ValueError(f"{name}: Y has shape {tuple(Y.shape)}, {lead + (P, nJ, nJ)} expected")
        if tuple(table.shape) != (P, nJ + nR) or table.dtype != torch.int32:
            raise ValueError(f"{name}: the table must be int32 ({P}, {nJ + nR}), got "
                             f"{table.dtype} {tuple(table.shape)}")
        if table.device != device:
            raise ValueError(f"{name}: the table is on {table.device}, not {device}")
        if depth and (tuple(op[3].shape) != (P * (nJ + nR),) or op[3].dtype != torch.int32
                      or op[3].device != device):
            raise ValueError(f"{name}: the order must be int32 ({P * (nJ + nR)},) on {device}")
        if depth and (2 * P * dims[-1][2] != boxes_points or nJ + nR != 2 * dims[-1][2]):
            raise ValueError(f"{name}: {P} parents of {nJ} + {nR} points do not merge the "
                             f"{boxes_points} points below")
        dims.append((P, nJ, nR))
        boxes_points = P * nR
    if tuple(Yroot.shape[-2:]) != (dims[-1][2], dims[-1][2]) or dims[-1][0] != 1:
        raise ValueError(f"Yroot has shape {tuple(Yroot.shape)}: the top level keeps "
                         f"{dims[-1][2]} points of {dims[-1][0]} parents")
    B, nI, rho = dims[0]
    if b.dim() != len(lead) + 2 or tuple(b.shape[:len(lead)]) != lead or b.shape[-1] != B * (nI + rho):
        raise ValueError(f"b has shape {tuple(b.shape)}, {lead + ('K', B * (nI + rho))} expected")
    return lead, dims


def check_inputs(leaf: Operands, levels: Sequence[LevelOperands], Yroot, b):
    """Raise ``ValueError`` on anything the kernel does not take: factors or
    right-hand sides other than complex64, tables other than int32, not
    contiguous (a Y may be each item's transpose, the root any layout), not
    on one CUDA device, or shapes that do not match.
    Returns (lead, dims) as ``_check_operands``."""
    tensors = {"Yroot": Yroot, "b": b}
    for depth, op in enumerate((leaf, *levels)):
        tensors[f"Y[{depth}]"], tensors[f"E[{depth}]"] = op[0], op[1]
    for name, t in tensors.items():
        if t.dtype != torch.complex64:
            raise ValueError(f"the HPS level kernel takes complex64 only; {name} is {t.dtype}")
    tensors.update({f"table[{d}]": op[2] for d, op in enumerate((leaf, *levels))})
    tensors.update({f"order[{d}]": op[3] for d, op in enumerate(levels)})
    for name, t in tensors.items():
        # Y may lie transposed, as torch.linalg.inv leaves it on the card; the
        # root's product takes any layout
        laid = t.is_contiguous() or (name[0] == "Y" and t.mT.is_contiguous()) or name == "Yroot"
        if not laid:
            raise ValueError(f"the HPS level kernel takes contiguous tensors; {name} is not")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != b.device:
            raise ValueError(f"no HPS level kernel for {name} on {t.device} (b on {b.device})")
    lead, dims = _check_operands(leaf, levels, Yroot, b, device=b.device)
    if b.shape[-1] >= 2**31 or max(P * (nJ + nR) for P, nJ, nR in dims) >= 2**31:
        raise ValueError("the kernel indexes points and rows with 32-bit ints")
    return lead, dims


@functools.lru_cache(maxsize=256)
def ctas_an_sm(down: bool, kp: int, tc: int, ni: int, device: torch.device) -> int:
    """The CTAs of the built kernel that an SM of ``device`` holds at once.
    Raises ``RuntimeError`` unless the kernel asks for the shared memory
    that the planner counted and an SM holds one of its CTAs."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = _build.load().fdfd_hps_level_layout(int(down), kp, tc, ni, out)
    if err != 0:
        raise RuntimeError(f"fdfd_hps_level_layout failed: CUDA error {err}")
    if out[0] != smem_bytes(kp, tc, ni, down) or out[2] < 1:
        raise RuntimeError(
            f"hps_level<{kp}, {'down' if down else 'up'}> at tc {tc}, ni {ni} asks for "
            f"{out[0]} bytes of shared memory (the planner counts "
            f"{smem_bytes(kp, tc, ni, down)}) and fits "
            f"{out[2]} CTAs an SM: update ops/fdfd_hps.py to match ops/csrc/fdfd_hps.cu")
    return out[2]


@dataclasses.dataclass(frozen=True)
class Space:
    """Where a level's children lie: a base pointer and the strides, in
    complex64 values, of a group, a point and a right-hand side, and the
    right-hand sides it holds (reads past them are 0, writes stop)."""
    ptr: int
    group: int
    point: int
    column: int
    held: int


def launch(plan: LevelPlan, Y, E, table, order, child: Space, parent, g, P: int):
    """One launch of one level and direction, a CTA a block of rows: up,
    the children through ``table`` (the leaf) or in J-then-R order
    (``table`` None), parent rows to ``order``'s places (None: in order);
    down, through ``table``. Raises ``RuntimeError`` when the runtime
    refuses it. Checks neither the operands nor ``plan``: its callers do."""
    lib = _build.load()
    stream = torch.cuda.current_stream(E.device).cuda_stream
    with torch.cuda.device(E.device):
        err = lib.fdfd_hps_level_run(
            int(plan.down), plan.kp, 0 if Y is None else Y.data_ptr(), E.data_ptr(),
            0 if table is None else table.data_ptr(), 0 if order is None else order.data_ptr(),
            child.ptr, child.group, child.point, child.column, child.held,
            parent.data_ptr(), g.data_ptr(), int(Y is not None and not Y.is_contiguous()),
            plan.items, P, plan.nJ, plan.nR, plan.tc, plan.ni, stream)
    if err != 0:
        raise RuntimeError(f"fdfd_hps_level_run refused {plan.blocks} CTAs of "
                           f"{'down' if plan.down else 'up'}, kp {plan.kp}, nJ {plan.nJ}, nR "
                           f"{plan.nR}: CUDA error {err} ({lib.fdtd_error_string(err).decode()})")
    count("fdfd.kernels.hps_sweeps")


def hps_sweeps(leaf: Operands, levels: Sequence[LevelOperands], Yroot, b):
    """x = A^{-1} b, b (..., K, nr nc), by the level kernels: a new tensor
    of b's shape. CUDA complex64 contiguous factors and right-hand sides and
    int32 tables only; raises ``ValueError`` on anything else."""
    lead, dims = check_inputs(leaf, levels, Yroot, b)
    x = torch.empty_like(b)
    K, N = b.shape[-2:]
    if b.numel() == 0:
        return x
    G = math.prod(lead)
    sms, _, smem = fdtd_fused.device_numbers(b.device)
    top = dims[-1][2]
    skel = [P * nR for P, _, nR in dims]         # points of each level's parents' skeletons
    kmax = kpad(min(K, KCHUNK))
    bufs = [torch.empty(G * max(skel[i::2], default=0) * kmax, dtype=torch.complex64,
                        device=b.device) for i in (0, 1)]
    g_sizes = [P * nJ for P, nJ, _ in dims]
    gbuf = torch.empty(G * sum(g_sizes) * kmax, dtype=torch.complex64, device=b.device)
    ops = (leaf, *levels)
    orders = [lev[3] for lev in levels] + [None]   # where level d's parent rows go
    # the launches run after this returns; freeing the buffers then is safe: the
    # caching allocator hands their memory only to work queued later on the stream
    for k0 in range(0, K, KCHUNK):
        kn = min(KCHUNK, K - k0)
        kp = kpad(kn)
        # level d's parents' skeletons: up in level d + 1's J-then-R order, down in ring order
        S = [bufs[d % 2][: G * n * kp].view(G, n, kp) for d, n in enumerate(skel)]
        offs = [0]
        for n in g_sizes:
            offs.append(offs[-1] + G * n * kp)
        gs = [gbuf[offs[d] : offs[d + 1]] for d in range(len(dims))]
        grid = [Space(t.data_ptr() + 8 * k0 * N, K * N, 1, N, kn) for t in (b, x)]

        def child(d: int, grid_side: Space) -> Space:   # the children of level d - 1
            if d == 0:
                return grid_side
            return Space(S[d - 1].data_ptr(), skel[d - 1] * kp, kp, 1, kp)

        def run(d: int, down: bool, Y, E, table, order, space: Space, parent):
            P, nJ, nR = dims[d]
            p = plan_level(G * P, nJ, nR, kp, down, sms, smem)
            ctas_an_sm(down, kp, p.tc, p.ni, b.device)
            launch(p, Y, E, table, order, space, parent, gs[d], P)

        with span("fdfd.hps.up"):
            for d, op in enumerate(ops):
                run(d, False, op[0], op[1], None if d else op[2], orders[d], child(d, grid[0]),
                    S[d])
            count("fdfd.hps.levels", len(levels))
        with span("fdfd.hps.root"):
            x_top = torch.matmul(Yroot.reshape(G, top, top), S[-1].view(G, top, kp))
        with span("fdfd.hps.down"):
            parent = x_top
            for d in range(len(ops) - 1, -1, -1):
                run(d, True, None, ops[d][1], ops[d][2], None, child(d, grid[1]), parent)
                parent = S[d - 1] if d else None
            count("fdfd.hps.levels", len(levels))
    return x


def hps_sweeps_reference(leaf: Operands, levels: Sequence[LevelOperands], Yroot, b):
    """Plain torch ops: x = A^{-1} b, b (..., K, nr nc), in the dtype and on
    the device of the inputs, through the kernel's tables, chunks of at most
    16 right-hand sides padded as the kernel pads them, and layouts (points,
    kp): up, the leaf's vectors gathered from the grid through its table and
    every level's parent rows put in the next level's J-then-R order;
    down, x_J and x_R scattered to the children through the tables; one
    product for g and one for E^T b_J up, one for E x_R down."""
    lead, dims = _check_operands(leaf, levels, Yroot, b, device=b.device)
    K, N = b.shape[-2:]
    x = torch.empty_like(b)
    ops = (leaf, *levels)
    orders = [lev[3].long() for lev in levels]
    for k0 in range(0, K, KCHUNK):
        kn = min(KCHUNK, K - k0)
        kp = kpad(kn)
        pts = b.new_zeros(*lead, N, kp)
        pts[..., :kn] = b[..., k0 : k0 + kn, :].movedim(-1, -2)
        children = pts[..., leaf[2].long(), :]   # (..., P, nJ + nR, kp), J then R
        gs = []
        for d, (op, (P, nJ, nR)) in enumerate(zip(ops, dims)):
            b_J = children[..., :nJ, :]
            gs.append(op[0] @ b_J)
            children = (children[..., nJ:, :] - op[1].mT @ b_J).flatten(-3, -2)
            if d + 1 < len(ops):              # to the next level's J-then-R order
                up, children = children, torch.empty_like(children)
                children[..., orders[d], :] = up
                children = children.unflatten(-2, (dims[d + 1][0], -1))
        xs = Yroot @ children
        for op, (P, nJ, nR), g in zip(ops[::-1], dims[::-1], gs[::-1]):
            idx = op[2].long()
            below = xs.new_empty(*lead, idx.numel(), kp)
            below[..., idx[:, :nJ], :] = g - op[1] @ xs.unflatten(-2, (P, nR))
            below[..., idx[:, nJ:], :] = xs.unflatten(-2, (P, nR))
            xs = below
        x[..., k0 : k0 + kn, :] = xs[..., :kn].movedim(-1, -2)
    return x
