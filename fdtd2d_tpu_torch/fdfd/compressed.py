"""Rank-structured (HODLR) storage for the block-Thomas inverses.

Counterpart of ``fdtd2d_tpu/fdfd/compressed.py``. The exact direct solver
(fdfd/direct.py) stores one dense (nc x nc) inverse per sublattice block
row: 4 * (N/2)^3 * 8 B in all, 34.4 GB at 2048^2. This module keeps the
factorization EXACT (the Schur recursion still carries the dense previous
inverse) but stores each computed inverse W_r in fixed-rank HODLR form:

    - dense diagonal leaf blocks (2^L blocks of size m = nc / 2^L), and
    - per level l = 1..L, the sibling off-diagonal blocks (size nc / 2^l)
      as rank-r factors U (b x r), V (r x b) from a randomized range finder
      U = qr(B @ Omega) (sharpened by ``q`` power iterations), V = U^H B.

With leaf 128 and rank 20 the store at 2048^2 is 8.32 GB (253,952 complex64
entries a row). The solve against compressed factors carries the
range finder's error in every W application; :class:`DirectSolver` wraps it
in complex128 iterative refinement (fdfd/refine.py), which contracts by the
application's accuracy each round.

Layout. A factor's ``rows`` hold the row axis FIRST: ``rows["D"]`` is
(nr, ..., 2^L, m, m) and level l's ``(U, V)`` are (nr, ..., 2, 2^(l-1), b, r)
and (nr, ..., 2, 2^(l-1), r, b), where ``...`` is the sublattice axis of
stacked factors (empty for one sublattice) and the axis of 2 holds the
upper sibling block (rows of the first half, columns of the second) before
the lower one. Row r of every leaf is then one contiguous block, so a
matvec reads it without a copy, and the two siblings of a level are one
batched product.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from fdtd2d_tpu_torch.fdfd.direct import (
    _PARITIES, _ROW_SOLVES, StackedFactors, _solve, _sublattice_coefficients, _w_step,
)
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator


def hodlr_plan(nc: int, *, leaf: int = 128, rank: int = 20) -> int:
    """Number of HODLR levels L for an (nc x nc) inverse: the deepest
    partition whose leaves still divide nc and stay above both the target
    leaf size and 2*rank (blocks must be meaningfully taller than the
    rank for the range finder to compress anything)."""
    L = 0
    while (nc % (1 << (L + 1))) == 0 and (nc >> (L + 1)) >= max(leaf, 2 * rank):
        L += 1
    return L


def make_test_matrices(nc: int, L: int, rank: int, seed: int = 0, dtype=torch.complex64,
                       device="cuda") -> Tuple[torch.Tensor, ...]:
    """Per-level random range-finder test matrices Omega_l (b_l x rank),
    complex standard Gaussian, drawn from ``np.random.default_rng(seed)``
    in the JAX package's order, so both packages get the same Omega_l."""
    rng = np.random.default_rng(seed)
    out = []
    for lev in range(1, L + 1):
        b = nc >> lev
        om = (rng.standard_normal((b, rank)) + 1j * rng.standard_normal((b, rank))) / np.sqrt(2.0)
        out.append(torch.tensor(om, dtype=dtype, device=device))
    return tuple(out)


def _nqr(Y):
    """Q of a batched QR, of the sketch scaled to max |Y| = 1 (Q is scale
    invariant; the JAX package normalizes because its TPU QR underflowed on
    tiny blocks, and the port keeps it for parity)."""
    s = Y.abs().amax(dim=(-2, -1), keepdim=True)
    return torch.linalg.qr(Y / torch.where(s > 0, s, torch.ones_like(s)))[0]


def _compress_row(W, omegas, L: int, q: int = 0) -> dict:
    """Dense (..., nc, nc) -> one HODLR row: {'D': (..., 2^L, m, m) diagonal
    leaves, 'levels': ((U, V), ...) sibling off-diagonal factors per level}.

    ``q``: randomized subspace (power) iterations on top of the one-pass
    range finder; each multiplies the sketch by B^H B (re-orthonormalized),
    which sharpens the captured range at factor-time cost only."""
    nc = W.shape[-1]
    nleaf, m = 1 << L, nc >> L
    lead = W.shape[:-2]
    D = torch.diagonal(W.reshape(*lead, nleaf, m, nleaf, m), dim1=-4, dim2=-2).movedim(-1, -3)
    levels = []
    for lev in range(1, L + 1):
        b, npair = nc >> lev, 1 << (lev - 1)
        W6 = W.reshape(*lead, npair, 2, b, npair, 2, b)
        pairs = torch.diagonal(W6, dim1=-6, dim2=-3)          # (..., 2, b, 2, b, npair)
        B = torch.stack([pairs[..., 0, :, 1, :, :], pairs[..., 1, :, 0, :, :]],
                        dim=-4).movedim(-1, -3)              # (..., 2, npair, b, b)
        Om = omegas[lev - 1]
        Q = _nqr(B @ Om)
        for _ in range(q):
            Q = _nqr(B @ _nqr(B.mH @ Q))
        levels.append((Q, Q.mH @ B))
    return {"D": D, "levels": tuple(levels)}


def _hodlr_matvec(row: dict, v):
    """y = W v from one compressed row; v (..., nc, K). Exact on the leaves,
    rank-r on the off-diagonal blocks."""
    D = row["D"]
    nleaf, m = D.shape[-3], D.shape[-1]
    nc, K = v.shape[-2:]
    lead = v.shape[:-2]
    y = (D @ v.reshape(*lead, nleaf, m, K)).reshape(*lead, nc, K)
    for U, V in row["levels"]:
        npair, b = U.shape[-3], U.shape[-2]
        vp = v.reshape(*lead, npair, 2, b, K)
        # the upper block takes the second half of the pair, the lower the first
        c = U @ (V @ vp.flip(-3).transpose(-4, -3))          # (..., 2, npair, b, K)
        y = y + c.transpose(-4, -3).reshape(*lead, nc, K)
    return y


def _row_of(rows: dict, r: int) -> dict:
    return {"D": rows["D"][r], "levels": tuple((U[r], V[r]) for U, V in rows["levels"])}


@dataclasses.dataclass(frozen=True)
class CompressedSublatticeFactors:
    """HODLR rows of one sublattice, or of four stacked (layout in the
    module docstring)."""
    rows: dict            # {"D": ..., "levels": ((U, V), ...)}, row axis first
    nvals: torch.Tensor   # (..., nr, nc) coupling to row r-1 (row 0 zero)
    svals: torch.Tensor   # (..., nr, nc) coupling to row r+1 (last row zero)
    wmax: torch.Tensor    # 0-d: max |D| (the element-growth diagnostic)


@dataclasses.dataclass(frozen=True)
class CompressedFactors:
    """Compressed factors of the four sublattices, order as DirectFactors."""
    subs: Tuple[CompressedSublatticeFactors, ...]
    shape: Tuple[int, int]
    batch: Tuple[int, ...] = ()


def _factor_rows_compressed(d, e, w, n, s, omegas, L: int, q: int = 0):
    """Block-Thomas recursion over the row axis of (..., nr, nc) arrays with
    a DENSE carry (the Schur updates stay exact), emitting compressed rows.
    Peak memory: one dense carry plus the compressed store."""
    nr = d.shape[-2]
    wmax = torch.zeros((), dtype=d.real.dtype, device=d.device)
    W, store = None, None
    for r in range(nr):
        W = _w_step(W, d, e, w, n, s, r)
        row = _compress_row(W, omegas, L, q)
        if store is None:
            store = {"D": row["D"].new_empty((nr,) + row["D"].shape),
                     "levels": tuple((U.new_empty((nr,) + U.shape), V.new_empty((nr,) + V.shape))
                                     for U, V in row["levels"])}
        store["D"][r] = row["D"]
        for (Us, Vs), (U, V) in zip(store["levels"], row["levels"]):
            Us[r], Vs[r] = U, V
        wmax = torch.maximum(wmax, row["D"].abs().amax())
    return CompressedSublatticeFactors(rows=store, nvals=n, svals=s, wmax=wmax)


def factor_compressed(op: HelmholtzOperator, omegas, *, L: int, q: int = 0) -> CompressedFactors:
    """HODLR-compressed factorization of the four sublattices, one at a time
    (any N). ``omegas`` from :func:`make_test_matrices` for nc = Ny // 2;
    ``q`` power iterations sharpen the range finder."""
    return CompressedFactors(
        subs=tuple(_factor_rows_compressed(*c, omegas, L, q) for c in _sublattice_coefficients(op)),
        shape=op.shape)


def factor_compressed_stacked(coeffs4, omegas, *, L: int, q: int = 0) -> CompressedSublatticeFactors:
    """HODLR factorization of the four sublattices as ONE batched recursion
    (even grids; ``coeffs4`` from fdfd.direct.stack_coefficients). Its
    leaves carry the sublattice axis after the row axis; solve it through
    ``StackedFactors`` (one pass of 4x-batched matvecs a row)."""
    return _factor_rows_compressed(*coeffs4, omegas, L, q)


def sublattice_views(f: CompressedSublatticeFactors, shape) -> CompressedFactors:
    """The four sublattices of stacked factors as CompressedFactors of views
    (no copy): the same factors solved one sublattice at a time."""
    def sub(k):
        rows = {"D": f.rows["D"][:, k],
                "levels": tuple((U[:, k], V[:, k]) for U, V in f.rows["levels"])}
        return CompressedSublatticeFactors(rows=rows, nvals=f.nvals[k], svals=f.svals[k],
                                           wmax=f.wmax)
    return CompressedFactors(subs=tuple(sub(k) for k in range(len(_PARITIES))),
                             shape=tuple(shape))


def _solve_rows_compressed(f: CompressedSublatticeFactors, b):
    """x ~= A^{-1} b from compressed rows; b (..., nr, nc, K). The forward
    and backward passes of the stored rows' torch loop
    (ops/fdfd_rowsweep.py::row_sweep_reference) with the dense W matvec
    replaced by the HODLR one."""
    nr = b.shape[-3]
    z = _hodlr_matvec(_row_of(f.rows, 0), b[..., 0, :, :])
    zs = [z]
    for r in range(1, nr):
        z = _hodlr_matvec(_row_of(f.rows, r), b[..., r, :, :] - f.nvals[..., r, :, None] * z)
        zs.append(z)
    x = zs[-1]
    xs = [x]
    for r in range(nr - 2, -1, -1):
        x = zs[r] - _hodlr_matvec(_row_of(f.rows, r), f.svals[..., r, :, None] * x)
        xs.append(x)
    return torch.stack(xs[::-1], dim=-3)


_ROW_SOLVES[CompressedSublatticeFactors] = _solve_rows_compressed


def solve_compressed(f, b) -> torch.Tensor:
    """x ~= A^{-1} b from CompressedFactors (or StackedFactors holding
    compressed rows), accurate to the range finder's tolerance: wrap it in
    refinement for exact residuals. b (Nx, Ny) complex, or (K, Nx, Ny)."""
    return _solve(f, b)


def compressed_bytes(f) -> int:
    """Bytes in the compressed store (compare the dense store's
    4 * nr * nc^2 * itemsize). Takes CompressedFactors, stacked
    CompressedSublatticeFactors or StackedFactors holding them."""
    if isinstance(f, StackedFactors):
        f = f.stacked
    subs = f.subs if isinstance(f, CompressedFactors) else (f,)
    return sum(t.numel() * t.element_size() for s in subs
               for t in (s.rows["D"], *(x for lev in s.rows["levels"] for x in lev)))
