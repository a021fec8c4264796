"""HPS-style nested-dissection direct solve: dense batched fronts,
O(N^2 log N) memory, log-depth batched solves.

Counterpart of ``fdtd2d_tpu/fdfd/hps.py``. Each of the four decoupled
(i mod 2, j mod 2) sublattices (fdfd/direct.py) carries a 5-point complex
Helmholtz system on an (nr, nc) grid. The grid is tiled by m x m leaf boxes
that merge pairwise up a binary tree, alternating axes. A box's ACTIVE
points are its outer layer; merging two boxes eliminates the two interface
layers that become interior. With J the eliminated and R the kept
(parent-ring) points of a merge,

    Y = A_JJ^{-1},   E = Y A_JR,   S_parent = A_RR - A_JR^T E,

where A is assembled from the children's Schur complements plus the
interface couplings. The operator is complex SYMMETRIC and the assembly
uses one coefficient per edge, so every Schur complement stays symmetric
and only (Y, E) are stored per node. A solve is an upward and a downward
sweep of ~2 log2(N/2m) batched dense products.

Accuracy (the JAX package's measurements, hard 50%-duty binary 5x scene,
17 GHz, m = 8): exact in complex128, while the raw complex64 error grows
about 10x a grid doubling (the interface Schur systems of the indefinite
operator are near-resonant), so its refinement contracts slowly (about 0.5
a round at 1024^2; :class:`DirectSolver` then defaults to 40 rounds) and
stalls at 2048^2. The port's wider eliminations (below) move that wall:
on an H100, 2048^2 sweeps of 16 sources refine to 1e-6 (the benchmark's
``fdfd-hps`` cell), and :class:`DirectSolver` warns from 4096^2, the first
size not measured.

Each elimination (the inverse, E and the Schur complement) runs in
complex128 and its results are stored in the operator's dtype
(:func:`_eliminate`), where the JAX package computes them in complex64.
Computed in complex64 on an H100, the 1024^2 hard scene's factor left raw
residuals up to 0.2 (the JAX package's complex64 factor on a CPU: 0.03),
and the refinement of a sweep of sources diverged; computed wide, its raw
residuals are about 1e-4 and the sweep refines to 1e-8 in a few rounds.
The stored factors, and so the solves, stay complex64.

The plans (:func:`build_plan`) are numpy copies of the JAX package's, with
its static per-level index maps. The port assembles the leaf systems and
the interface couplings by index assignment into the (boxes, m^2, m^2) and
(parents, 2 rho, 2 rho) blocks; the JAX package multiplies by one-hot
matrices there (a batched scatter overflowed its TPU compiler's scoped
memory). The entry positions are static and unique, so both write the same
values. Each plan's index tensors go to a device once (``_device_plan``).
The four sublattices factor and solve as one batch on a leading axis of 4:
the plans need their common shape, so N is even (as for the JAX package,
whose plans reject the shapes an odd N gives for any leaf above 1).

On the card a complex64 factor's sweeps run as the level kernels of
ops/fdfd_hps.py (:func:`_on_card`): a launch a level and direction, the
indices of each level's gathers composed into one int32 table when
``_device_plan`` is built. :func:`_solve_cols`, the torch path, runs every
other input (CPU tensors, complex128 factors).

Spans and counters (utils/trace.py): ``fdfd.hps.factor`` around
:func:`hps_factor`; in :func:`hps_solve`, ``fdfd.hps.split`` (the parity
split in, the merge back out; the torch path's transposes), ``fdfd.hps.up``
(the leaf fold and the upward merges), ``fdfd.hps.root`` and
``fdfd.hps.down`` (the downward back-substitution to grid order); counters
``fdfd.hps.solves``, one an inner solve, ``fdfd.hps.levels``, merge
levels walked, up plus down, and ``fdfd.hps.factors``, one a member
factored. None of them synchronizes with the device.

An operator stacked over omega (ops/helmholtz.py ``stack_operators``)
factors as one batch on a member axis behind the sublattices' (the
adjoint inverse design of apps/inverse_design.py, one factor a frequency);
:func:`hps_solve` then takes each member's right-hand sides to its own
factor, and the level kernels take the (4, F) leading axes as groups.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import numpy as np
import torch

from fdtd2d_tpu_torch.fdfd.direct import (five_point_coefficients, merge_sublattices,
                                          split_sublattices)
from fdtd2d_tpu_torch.ops import fdfd_hps
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator
from fdtd2d_tpu_torch.utils.trace import count, span


# ---------------------------------------------------------------------------
# Plans (pure numpy, cached per geometry; a copy of the JAX package's)
# ---------------------------------------------------------------------------


def _ring_pts(p: int, q: int) -> List[Tuple[int, int]]:
    """Outer-layer coords of a p x q box, row-major (the canonical skeleton
    ordering used everywhere in this module)."""
    return [(r, c) for r in range(p) for c in range(q)
            if r in (0, p - 1) or c in (0, q - 1)]


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    m: int
    n_boxes: int
    origins: np.ndarray      # (n_boxes, 2) box origin in sublattice coords
    idx_I: np.ndarray        # interior positions within the m^2 row-major box
    idx_R: np.ndarray        # ring positions (canonical order)
    ent_r: np.ndarray        # dense-assembly rows (within m^2 x m^2)
    ent_c: np.ndarray        # dense-assembly cols
    ent_src: np.ndarray      # 0=d, 1=col-edge (E_col), 2=row-edge (E_row)
    ent_loc: np.ndarray      # local flat index of the coefficient to gather


@dataclasses.dataclass(frozen=True)
class MergePlan:
    axis: int                   # 1: children side-by-side in columns
    child_shape: Tuple[int, int]
    parent_shape: Tuple[int, int]
    n_parents: int
    pair1: np.ndarray           # (n_parents,) indices into the child batch
    pair2: np.ndarray
    origins: np.ndarray         # (n_parents, 2) parent box origins
    idx_J: np.ndarray           # positions in the concatenated child skeleton
    idx_R: np.ndarray           # ... ordered to the parent's canonical ring
    coup_a: np.ndarray          # interface pairs: position of the first point
    coup_b: np.ndarray          # ... of the second (in the concatenated skel)
    coup_loc: np.ndarray        # parent-local flat coord of the edge value
    J_coords: np.ndarray        # (nJ, 2) parent-local coords of J points


@dataclasses.dataclass(frozen=True)
class HPSPlan:
    nr: int
    nc: int
    leaf: LeafPlan
    merges: Tuple[MergePlan, ...]
    root_coords: np.ndarray     # (rho_root, 2) coords of the root skeleton


@functools.lru_cache(maxsize=8)
def build_plan(nr: int, nc: int, m: int = 8) -> HPSPlan:
    """Nested-dissection plan for an (nr, nc) 5-point grid with m x m
    leaves. Requires nr, nc divisible by m with power-of-two box counts."""
    if nr % m or nc % m:
        raise ValueError(f"grid ({nr},{nc}) not divisible by leaf {m}")
    Br, Bc = nr // m, nc // m
    if Br & (Br - 1) or Bc & (Bc - 1):
        raise ValueError(f"box grid ({Br},{Bc}) must be powers of two")

    # --- leaf plan ---
    pts = [(r, c) for r in range(m) for c in range(m)]
    ring = set(_ring_pts(m, m))
    idx_I = np.array([k for k, pt in enumerate(pts) if pt not in ring], np.int32)
    idx_R = np.array([k for k, pt in enumerate(pts) if pt in ring], np.int32)
    er, ec, esrc, eloc = [], [], [], []
    for k, (r, c) in enumerate(pts):
        er.append(k); ec.append(k); esrc.append(0); eloc.append(k)
        if c < m - 1:   # edge (r,c)-(r,c+1), value E_col at (r,c)
            for a, b in ((k, k + 1), (k + 1, k)):
                er.append(a); ec.append(b); esrc.append(1); eloc.append(k)
        if r < m - 1:   # edge (r,c)-(r+1,c), value E_row at (r,c)
            for a, b in ((k, k + m), (k + m, k)):
                er.append(a); ec.append(b); esrc.append(2); eloc.append(k)
    origins = np.array([(br * m, bc * m) for br in range(Br) for bc in range(Bc)], np.int32)
    leaf = LeafPlan(m=m, n_boxes=Br * Bc, origins=origins, idx_I=idx_I, idx_R=idx_R,
                    ent_r=np.array(er, np.int32), ent_c=np.array(ec, np.int32),
                    ent_src=np.array(esrc, np.int32), ent_loc=np.array(eloc, np.int32))

    # --- merge levels ---
    merges = []
    cur_pts = [pts[k] for k in idx_R]        # skeleton coords, canonical order
    shape = (m, m)
    while Br * Bc > 1:
        axis = 1 if Bc >= Br else 0          # alternates for square domains
        p, q = shape
        if axis == 1:
            parent_shape, off2 = (p, 2 * q), (0, q)
            nBr, nBc = Br, Bc // 2
            pair1 = np.array([r * Bc + 2 * c for r in range(nBr) for c in range(nBc)], np.int32)
        else:
            parent_shape, off2 = (2 * p, q), (p, 0)
            nBr, nBc = Br // 2, Bc
            pair1 = np.array([2 * r * Bc + c for r in range(nBr) for c in range(nBc)], np.int32)
        pair2 = pair1 + (1 if axis == 1 else Bc)
        allpts = cur_pts + [(r + off2[0], c + off2[1]) for r, c in cur_pts]
        pos = {pt: i for i, pt in enumerate(allpts)}
        pring = set(_ring_pts(*parent_shape))
        J = sorted((pt for pt in allpts if pt not in pring))
        parent_pts = _ring_pts(*parent_shape)
        assert sorted(allpts) == sorted(J + parent_pts)
        idxJ = np.array([pos[pt] for pt in J], np.int32)
        idxR = np.array([pos[pt] for pt in parent_pts], np.int32)
        if axis == 1:
            ca = [pos[(r, q - 1)] for r in range(p)]
            cb = [pos[(r, q)] for r in range(p)]
            cloc = [r * parent_shape[1] + (q - 1) for r in range(p)]
        else:
            ca = [pos[(p - 1, c)] for c in range(q)]
            cb = [pos[(p, c)] for c in range(q)]
            cloc = [(p - 1) * parent_shape[1] + c for c in range(q)]
        porig = (origins[pair1]).astype(np.int32)
        merges.append(MergePlan(
            axis=axis, child_shape=shape, parent_shape=parent_shape,
            n_parents=nBr * nBc, pair1=pair1, pair2=pair2, origins=porig,
            idx_J=idxJ, idx_R=idxR,
            coup_a=np.array(ca, np.int32), coup_b=np.array(cb, np.int32),
            coup_loc=np.array(cloc, np.int32),
            J_coords=np.array(J, np.int32)))
        cur_pts, shape, Br, Bc, origins = parent_pts, parent_shape, nBr, nBc, porig

    return HPSPlan(nr=nr, nc=nc, leaf=leaf, merges=tuple(merges),
                   root_coords=np.array(cur_pts, np.int32))


def _gidx(origins, local_flat, ncols, shape):
    """Global flat indices: box origins (B, 2) + local flat offsets (k,)
    within a box of ``shape`` -> (B, k)."""
    lr, lc = local_flat // shape[1], local_flat % shape[1]
    return ((origins[:, 0:1] + lr[None, :]) * ncols + (origins[:, 1:2] + lc[None, :]))


# ---------------------------------------------------------------------------
# A plan's index tensors on a device
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _DeviceMerge:
    coup_gather: torch.Tensor   # (P, ncoup) flat index of each coupling value
    coup_a: torch.Tensor        # (ncoup,) interface pairs in the (2 rho) block
    coup_b: torch.Tensor
    pair1: torch.Tensor         # (P,) first and second child of each parent
    pair2: torch.Tensor
    up_src: torch.Tensor        # (2P,) children in (parent, first/second) order
    idx_J: torch.Tensor
    idx_R: torch.Tensor
    xcat_perm: torch.Tensor     # cat([x_J, x_R]) -> the concatenated child skeleton
    child_src: torch.Tensor     # (2P,) child c's row in the (P, 2) parent-half order
    table: torch.Tensor         # (P, nJ + nR) int32: up_src, idx_J and idx_R composed, the
                                # point of each J, then R, point among the children's skeletons
    order: torch.Tensor         # (2 P rho,) int32: its inverse, each child point's place


@dataclasses.dataclass(frozen=True)
class _DevicePlan:
    leaf_gather: torch.Tensor   # (n_boxes, n_ent) flat index into stack(d, E_col, E_row)
    leaf_pos: torch.Tensor      # (n_ent,) flat position in the m^2 x m^2 leaf block
    leaf_I: torch.Tensor
    leaf_R: torch.Tensor
    box_I: torch.Tensor         # (n_boxes, nI) global flat index of interior points
    box_R: torch.Tensor         # (n_boxes, rho) of ring points
    merges: Tuple[_DeviceMerge, ...]
    out_perm: torch.Tensor      # cat(root, J of each level top-down, leaf I) -> grid
    leaf_table: torch.Tensor    # (n_boxes, nI + rho) int32: box_I, then box_R


@functools.lru_cache(maxsize=8)
def _device_plan(nr: int, nc: int, m: int, device: torch.device) -> _DevicePlan:
    plan = build_plan(nr, nc, m)
    lf = plan.leaf

    def t(a, dtype=np.int64):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    gi = _gidx(lf.origins, lf.ent_loc, nc, (m, m))
    merges, placed = [], []
    for mp in plan.merges:
        coup = _gidx(mp.origins, mp.coup_loc, nc, mp.parent_shape)
        child = np.empty(2 * mp.n_parents, np.int64)
        child[mp.pair1] = 2 * np.arange(mp.n_parents)
        child[mp.pair2] = 2 * np.arange(mp.n_parents) + 1
        rho = (len(mp.idx_J) + len(mp.idx_R)) // 2
        cat = np.concatenate([mp.idx_J, mp.idx_R])
        box = np.where(cat < rho, mp.pair1[:, None], mp.pair2[:, None])
        merges.append(_DeviceMerge(
            coup_gather=t(coup), coup_a=t(mp.coup_a), coup_b=t(mp.coup_b),
            pair1=t(mp.pair1), pair2=t(mp.pair2),
            up_src=t(np.stack([mp.pair1, mp.pair2], axis=1).reshape(-1)),
            idx_J=t(mp.idx_J), idx_R=t(mp.idx_R),
            xcat_perm=t(np.argsort(cat)), child_src=t(child),
            table=t(box * rho + cat % rho, np.int32),
            order=t(np.argsort((box * rho + cat % rho).ravel()), np.int32)))
        placed.append(_gidx(mp.origins, mp.J_coords[:, 0] * mp.parent_shape[1]
                            + mp.J_coords[:, 1], nc, mp.parent_shape).ravel())
    root = plan.root_coords[:, 0].astype(np.int64) * nc + plan.root_coords[:, 1]
    leaf_I = _gidx(lf.origins, lf.idx_I, nc, (m, m))
    leaf_R = _gidx(lf.origins, lf.idx_R, nc, (m, m))
    order = np.concatenate([root, *placed[::-1], leaf_I.ravel()])
    assert np.array_equal(np.sort(order), np.arange(nr * nc))
    return _DevicePlan(
        leaf_gather=t(lf.ent_src[None, :].astype(np.int64) * (nr * nc) + gi),
        leaf_pos=t(lf.ent_r.astype(np.int64) * (m * m) + lf.ent_c),
        leaf_I=t(lf.idx_I), leaf_R=t(lf.idx_R), box_I=t(leaf_I), box_R=t(leaf_R),
        merges=tuple(merges), out_perm=t(np.argsort(order)),
        leaf_table=t(np.concatenate([leaf_I, leaf_R], axis=1), np.int32))


# ---------------------------------------------------------------------------
# Factorization and solve (all dense ops batched over boxes; any leading
# axes of the coefficients, e.g. the four stacked sublattices, ride along)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LevelFactors:
    Y: torch.Tensor    # (..., n_parents, nJ, nJ) = A_JJ^{-1}
    E: torch.Tensor    # (..., n_parents, nJ, nR) = Y @ A_JR


@dataclasses.dataclass(frozen=True)
class SubHPSFactors:
    leaf: LevelFactors          # leaf interior elimination (nI, rho)
    levels: Tuple[LevelFactors, ...]
    Yroot: torch.Tensor         # (..., rho_root, rho_root)


@dataclasses.dataclass(frozen=True)
class HPSFactors:
    """HPS factors of the four sublattices, stacked on a leading axis of 4
    (the JAX package keeps a tuple of four with the same leaves), then the
    operator's own batch axes (``batch``: (F,) for an operator stacked over
    omega, one factor a member)."""
    stacked: SubHPSFactors
    shape: Tuple[int, int]
    m: int
    batch: Tuple[int, ...] = ()


def _inv_wide(A):
    """A^{-1} computed in complex128, returned in A's dtype."""
    return torch.linalg.inv(A.to(torch.complex128)).to(A.dtype)


def _eliminate(A, iJ, iR):
    """(Y, E, S) of eliminating the J points of (..., nJ + nR)-square
    blocks, computed in complex128 and returned in A's dtype."""
    dtype, A = A.dtype, A.to(torch.complex128)
    A_JJ = A[..., iJ[:, None], iJ[None, :]]
    A_JR = A[..., iJ[:, None], iR[None, :]]
    A_RR = A[..., iR[:, None], iR[None, :]]
    Y = torch.linalg.inv(A_JJ)
    E = Y @ A_JR
    return Y.to(dtype), E.to(dtype), (A_RR - A_JR.mT @ E).to(dtype)


def hps_factor_sub(d, Ecol, Erow, plan: HPSPlan) -> SubHPSFactors:
    """Factor one sublattice 5-point system (or several stacked on leading
    axes). d/Ecol/Erow: (..., nr, nc) complex coefficient arrays (diagonal;
    column-edge; row-edge values)."""
    lf = plan.leaf
    dp = _device_plan(plan.nr, plan.nc, lf.m, d.device)
    lead, m2 = d.shape[:-2], lf.m * lf.m
    coef = torch.stack([d, Ecol, Erow], dim=-3).reshape(*lead, -1)
    A = d.new_zeros(*lead, lf.n_boxes, m2 * m2)
    A[..., dp.leaf_pos] = coef[..., dp.leaf_gather]
    Y, E, S = _eliminate(A.reshape(*lead, lf.n_boxes, m2, m2), dp.leaf_I, dp.leaf_R)
    leaf = LevelFactors(Y=Y, E=E)

    levels = []
    for mp, dm in zip(plan.merges, dp.merges):
        rho = S.shape[-1]
        cv = (Ecol if mp.axis == 1 else Erow).reshape(*lead, -1)[..., dm.coup_gather]
        Acat = d.new_zeros(*lead, mp.n_parents, 2 * rho, 2 * rho)
        Acat[..., :rho, :rho] = S[..., dm.pair1, :, :]
        Acat[..., rho:, rho:] = S[..., dm.pair2, :, :]
        # interface couplings: child1-ring x child2-ring entries and their
        # transposes (coup_a < rho <= coup_b by construction)
        Acat[..., dm.coup_a, dm.coup_b] = cv
        Acat[..., dm.coup_b, dm.coup_a] = cv
        Y, E, S = _eliminate(Acat, dm.idx_J, dm.idx_R)
        levels.append(LevelFactors(Y=Y, E=E))

    return SubHPSFactors(leaf=leaf, levels=tuple(levels), Yroot=_inv_wide(S[..., 0, :, :]))


def _solve_cols(f: SubHPSFactors, plan: HPSPlan, b):
    """x = A^{-1} b on factored sublattices; b (..., nr*nc, K) with the
    factors' leading axes and K right-hand sides. Upward sweep folds the
    right-hand side to the root; downward sweep back-substitutes."""
    dp = _device_plan(plan.nr, plan.nc, plan.leaf.m, b.device)
    lead, K = b.shape[:-2], b.shape[-1]
    with span("fdfd.hps.up"):
        b_I = b[..., dp.box_I, :]
        g_leaf = f.leaf.Y @ b_I
        bs = b[..., dp.box_R, :] - f.leaf.E.mT @ b_I
        gs = []
        for mp, lev, dm in zip(plan.merges, f.levels, dp.merges):
            bcat = bs[..., dm.up_src, :, :].reshape(*lead, mp.n_parents, -1, K)
            b_J = bcat[..., dm.idx_J, :]
            gs.append(lev.Y @ b_J)
            bs = bcat[..., dm.idx_R, :] - lev.E.mT @ b_J
        count("fdfd.hps.levels", len(plan.merges))

    with span("fdfd.hps.root"):
        x_R = f.Yroot @ bs[..., 0, :, :]

    with span("fdfd.hps.down"):
        pieces = [x_R]
        xs = x_R[..., None, :, :]
        for mp, lev, dm, g in zip(plan.merges[::-1], f.levels[::-1], dp.merges[::-1],
                                  gs[::-1]):
            x_J = g - lev.E @ xs
            pieces.append(x_J.flatten(-3, -2))
            xcat = torch.cat([x_J, xs], dim=-2)[..., dm.xcat_perm, :]
            xs = xcat.reshape(*lead, 2 * mp.n_parents, -1, K)[..., dm.child_src, :, :]
        pieces.append((g_leaf - f.leaf.E @ xs).flatten(-3, -2))
        count("fdfd.hps.levels", len(plan.merges))
        return torch.cat(pieces, dim=-2)[..., dp.out_perm, :]


def _on_card(f: SubHPSFactors, b) -> bool:
    """The level kernels' rule: right-hand sides on the card and complex64
    factors; every other input runs :func:`_solve_cols`."""
    return b.device.type == "cuda" and f.leaf.Y.dtype == torch.complex64


def _sweep_operands(f: SubHPSFactors, plan: HPSPlan, device):
    """(leaf, levels, Yroot) as ops/fdfd_hps.py takes them: each level's
    factors beside its composed int32 table (and a merge's order)."""
    dp = _device_plan(plan.nr, plan.nc, plan.leaf.m, device)
    return ((f.leaf.Y, f.leaf.E, dp.leaf_table),
            tuple((lev.Y, lev.E, dm.table, dm.order) for lev, dm in zip(f.levels, dp.merges)),
            f.Yroot)


def _solve(f: SubHPSFactors, plan: HPSPlan, b):
    """x = A^{-1} b, b (..., K, nr*nc) contiguous: the level kernels on the
    card (:func:`_on_card`), else the torch path, which carries K last."""
    if _on_card(f, b):
        return fdfd_hps.hps_sweeps(*_sweep_operands(f, plan, b.device), b)
    return _solve_cols(f, plan, b.movedim(-1, -2).contiguous()).movedim(-1, -2)


def hps_solve_sub(f: SubHPSFactors, plan: HPSPlan, b):
    """x = A^{-1} b on one factored sublattice (or several stacked); b
    (..., nr, nc) -> x (..., nr, nc)."""
    cols = b.reshape(*b.shape[:-2], 1, plan.nr * plan.nc).contiguous()
    return _solve(f, plan, cols).reshape(b.shape)


def _sub_coefficients(op: HelmholtzOperator):
    """The (d, E_col, E_row) coefficients, each the four sublattices stacked
    on a leading axis (w and n are the symmetric partners of e and s, equal
    to f32 rounding)."""
    d, e, _, s, _ = five_point_coefficients(op)
    return [torch.stack(split_sublattices(a)) for a in (d, e, s)]


def hps_factor(op: HelmholtzOperator, m: int = 8, dtype=None) -> HPSFactors:
    """Factor the full outrigger operator: four sublattice HPS trees as one
    batch (even N: the plans need the four sublattices' common shape). An
    operator stacked over omega factors every member in the same batch, on
    a member axis after the sublattices' ((4, F, ...) factors). ``dtype``:
    the coefficients' and so the store's dtype (default the operator's),
    e.g. complex64 factors of a complex128 operator. Counter
    ``fdfd.hps.factors``: one a member factored."""
    Nx, Ny = op.shape
    if Nx % 2 or Ny % 2:
        raise ValueError(f"HPS factors need even N, got {(Nx, Ny)}")
    with span("fdfd.hps.factor"):
        stacked = _sub_coefficients(op)
        if dtype is not None:
            stacked = [a.to(dtype) for a in stacked]
        plan = build_plan(*stacked[0].shape[-2:], m)
        count("fdfd.hps.factors", math.prod(op.batch_shape))
        return HPSFactors(stacked=hps_factor_sub(*stacked, plan), shape=op.shape, m=m,
                          batch=op.batch_shape)


def _tensors(f: SubHPSFactors):
    return [f.leaf.Y, f.leaf.E, *(t for lev in f.levels for t in (lev.Y, lev.E)), f.Yroot]


def factor_bytes(f: HPSFactors) -> int:
    """Total bytes of stored factors (the O(N^2 log N) footprint)."""
    return sum(t.numel() * t.element_size() for t in _tensors(f.stacked))


def predicted_factor_bytes(N: int, m: int = 8, itemsize: int = 8) -> int:
    """Exact stored-factor size for an N x N outrigger grid (4 sublattices
    of side N//2), computed from the plan alone — no factorization.
    Against the stored-W store 4*(N/2)^3*8 B the crossover sits at N ~ 256;
    the ratio grows as N / log N (~3.2x at 1024^2, ~5.6x at 2048^2)."""
    s = N // 2
    plan = build_plan(s, s, m)
    lf = plan.leaf
    tot = lf.n_boxes * (len(lf.idx_I) ** 2 + len(lf.idx_I) * len(lf.idx_R))
    for mp in plan.merges:
        tot += mp.n_parents * (len(mp.idx_J) ** 2 + len(mp.idx_J) * len(mp.idx_R))
    tot += len(plan.root_coords) ** 2
    return 4 * tot * itemsize


def hps_solve(f: HPSFactors, b) -> torch.Tensor:
    """x = A^{-1} b from HPS factors; b (Nx, Ny) complex, or (K, Nx, Ny)
    (K right-hand sides against the one factorization); for factors of a
    stacked operator, batch + (Nx, Ny) or batch + (K, Nx, Ny), each member's
    right-hand sides against its own factor."""
    count("fdfd.hps.solves")
    Nx, Ny = f.shape
    with span("fdfd.hps.split"):
        bk = b.reshape(f.batch + (-1, Nx, Ny))
        b4 = torch.stack(split_sublattices(bk))  # (4, K, nr, nc)
        plan = build_plan(b4.shape[-2], b4.shape[-1], f.m)
    x4 = _solve(f.stacked, plan, b4.flatten(-2))
    with span("fdfd.hps.split"):
        # the four sublattices of an even grid cover every point
        return merge_sublattices(x4.reshape(b4.shape), torch.empty_like(bk)).reshape(b.shape)
