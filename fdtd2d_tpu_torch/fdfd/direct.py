"""Exact Helmholtz solve: sublattice block-Thomas factorization.

Counterpart of ``fdtd2d_tpu/fdfd/direct.py``. The "outrigger" operator
couples only flat offsets {+-2, +-2N}: point (i, j) talks to (i+-2, j) and
(i, j+-2). Points therefore split by (i mod 2, j mod 2) into FOUR
independent half-resolution sublattices, each a standard 5-point complex
Helmholtz system, block-tridiagonal over sublattice rows with tridiagonal
diagonal blocks and DIAGONAL off-diagonal blocks. The block-Thomas recursion

    U_0 = A_0,   U_r = A_r - diag(n_r) U_{r-1}^{-1} diag(s_{r-1})

costs one dense (nc x nc) inverse per block row and no matmul (the diagonal
off-blocks make the Schur update a row/column scaling of the stored inverse
W_{r-1} = U_{r-1}^{-1}). A solve against the stored inverses is one matvec
per block row forward and one backward. complex64 block-LU without
pivoting loses a few digits; :class:`DirectSolver` wraps the solve in
complex128 iterative refinement (fdfd/refine.py).

The row recursions run over the row axis (-2) of (..., nr, nc) coefficient
arrays, so one code path serves one sublattice (odd N) and the four stacked
on a leading axis (even N: ``torch.linalg.inv`` and the solve batch the
four). The factor's recursion is a host loop of torch ops. The solve's two,
for a complex64 store on the card, are one launch a direction of the
row-sweep kernel (ops/fdfd_rowsweep.py), and otherwise its plain version, a
host loop of torch ops. A solve carries K right-hand sides, so a batch of
sources widens each row's matvec into a matrix product instead of looping.
An operator batched over scenes (eps, omega and the stretch vectors with a
leading (B,) axis, models/datagen.py) factors into one factor set a scene in
the same pass: the coefficients, the four sublattices and the row recursions
all carry the scene axis, and a solve takes one right-hand side a scene,
(B, Nx, Ny).

Coefficients (checked against HelmholtzOperator.apply in the tests):

    A x(i,j) =  d(i,j) x(i,j) + e(i,j) x(i,j+2) + w(i,j) x(i,j-2)
              + s(i,j) x(i+2,j) + n(i,j) x(i-2,j)
    e(i,j) = -a_c^2 isc(j) isc(j+2) im(i,j+1)      (j <= Ny-3)
    w(i,j) = -a_c^2 isc(j) isc(j-2) im(i,j-1)      (j >= 2)
    s(i,j) = -a_r^2 isr(i) isr(i+2) im(i+1,j)      (i <= Nx-3)
    n(i,j) = -a_r^2 isr(i) isr(i-2) im(i-1,j)      (i >= 2)
    d(i,j) = HelmholtzOperator.diagonal()

On every sublattice the first row's n and the last row's s are zero.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fdtd2d_tpu_torch.fdfd.refine import refine, refine_batched, true_relative_residual
from fdtd2d_tpu_torch.ops import fdfd_rowsweep
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator, make_operator
from fdtd2d_tpu_torch.utils.trace import span

# the sublattices' one order: (i mod 2, j mod 2) of their points
_PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))


def split_sublattices(a):
    """The four (i mod 2, j mod 2) sublattices of ``a`` (a tensor or a numpy
    array, the grid its last two axes) as views, in ``_PARITIES`` order. A
    list: an odd grid's sublattices differ in shape, and stacked callers
    stack it."""
    return [a[..., px::2, py::2] for (px, py) in _PARITIES]


def merge_sublattices(parts, out):
    """Write the four sublattices ``parts`` (in ``_PARITIES`` order) back
    into the grid ``out``, and return ``out``."""
    for sub, part in zip(split_sublattices(out), parts):
        sub[...] = part
    return out


def five_point_coefficients(op: HelmholtzOperator):
    """(d, e, w, s, n) coefficient arrays, each ``op.field_shape`` complex
    ((Nx, Ny), or (B, Nx, Ny) for an operator batched over scenes or
    omegas); entries at invalid offsets (within 2 of the relevant edge) are
    zero."""
    ac2 = op.inv_2dx**2
    ar2 = op.inv_2dy**2
    im = op.inv_mu
    isc = op.inv_s_col
    isr = op.inv_s_row
    # im shifted by one toward the coupled neighbour, zero at the edges
    im_cp = F.pad(im[..., 1:-1], (0, 2))        # im(i, j+1), j <= Ny-3
    im_cm = F.pad(im[..., 1:-1], (2, 0))        # im(i, j-1), j >= 2
    im_rp = F.pad(im[..., 1:-1, :], (0, 0, 0, 2))
    im_rm = F.pad(im[..., 1:-1, :], (0, 0, 2, 0))
    isc_p = F.pad(isc[..., 2:], (0, 2))         # isc(j+2)
    isc_m = F.pad(isc[..., :-2], (2, 0))        # isc(j-2)
    isr_p = F.pad(isr[..., 2:], (0, 2))
    isr_m = F.pad(isr[..., :-2], (2, 0))

    e = -ac2 * (isc * isc_p)[..., None, :] * im_cp
    w = -ac2 * (isc * isc_m)[..., None, :] * im_cm
    s = -ar2 * (isr * isr_p)[..., :, None] * im_rp
    n = -ar2 * (isr * isr_m)[..., :, None] * im_rm
    return op.diagonal(), e, w, s, n


def _tridiag(d_row, e_row, w_row):
    """Dense (..., nc, nc) tridiagonal blocks from (..., nc) coefficient rows:
    row c holds w(c) at c-1, d(c) at c, e(c) at c+1."""
    return (torch.diag_embed(d_row) + torch.diag_embed(e_row[..., :-1], offset=1)
            + torch.diag_embed(w_row[..., 1:], offset=-1))


def _row(a, r):
    return a[..., r, :]


def _w_step(Wprev, d, e, w, n, s, r):
    """W_r = U_r^{-1} from W_{r-1} (None at r = 0) and (..., nr, nc) rows."""
    U = _tridiag(_row(d, r), _row(e, r), _row(w, r))
    if Wprev is not None:
        U = U - _row(n, r)[..., :, None] * Wprev * _row(s, r - 1)[..., None, :]
    return torch.linalg.inv(U)


@dataclasses.dataclass(frozen=True)
class SublatticeFactors:
    """Stored block inverses of one sublattice, or of four stacked on a
    leading axis."""
    Ws: torch.Tensor      # (..., nr, nc, nc) U_r^{-1}
    nvals: torch.Tensor   # (..., nr, nc) coupling to row r-1 (row 0 zero)
    svals: torch.Tensor   # (..., nr, nc) coupling to row r+1 (last row zero)
    wmax: torch.Tensor    # 0-d: max |W| (the element-growth diagnostic)


@dataclasses.dataclass(frozen=True)
class CkptSublatticeFactors:
    """Checkpointed block-Thomas state: W stored only every ``stride`` rows,
    with the tridiagonal inputs kept so intermediate inverses can be
    recomputed per segment. Memory: (nr/stride) nc^2 instead of nr nc^2; the
    price is that each solve re-runs the inversion recursion twice (forward
    and backward pass)."""
    Wc: torch.Tensor      # (..., nseg, nc, nc) checkpoints W_{k*stride}
    d: torch.Tensor       # (..., nr, nc) tridiagonal inputs
    e: torch.Tensor
    w: torch.Tensor
    nvals: torch.Tensor
    svals: torch.Tensor
    stride: int
    wmax: torch.Tensor    # 0-d: max |W| over the checkpoints


@dataclasses.dataclass(frozen=True)
class DirectFactors:
    """Factors for the four (i mod 2, j mod 2) sublattices, in the fixed
    order (0,0), (0,1), (1,0), (1,1). ``batch``: the operator's batch shape,
    () for one operator, (B,) for one factor set a scene of a batch."""
    subs: tuple
    shape: Tuple[int, int]
    batch: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class StackedFactors:
    """The four sublattice factor sets stacked on a leading axis (even N),
    ahead of the operator's batch axes (``batch``, as in DirectFactors)."""
    stacked: object       # Sublattice-, CkptSublattice- or CompressedSublatticeFactors
    shape: Tuple[int, int]
    batch: Tuple[int, ...] = ()


def _factor_rows(d, e, w, n, s, stride: Optional[int] = None):
    """Block-Thomas factorization over the row axis of (..., nr, nc) arrays:
    every W (``stride=None``) or the checkpoints W_{k*stride}."""
    nr, nc = d.shape[-2:]
    if stride is not None and nr % stride:
        raise ValueError(f"rows {nr} must divide the stride {stride}")
    every = stride or 1
    store = d.new_empty(d.shape[:-2] + (nr // every, nc, nc))
    wmax = torch.zeros((), dtype=d.real.dtype, device=d.device)
    W = None
    # the last checkpoint is W_{(nseg-1)*stride}; rows past it are
    # recomputed at solve time
    for r in range(nr - every + 1):
        W = _w_step(W, d, e, w, n, s, r)
        if r % every == 0:
            store[..., r // every, :, :] = W
            wmax = torch.maximum(wmax, W.abs().amax())
    if stride is None:
        return SublatticeFactors(Ws=store, nvals=n, svals=s, wmax=wmax)
    return CkptSublatticeFactors(Wc=store, d=d, e=e, w=w, nvals=n, svals=s,
                                 stride=stride, wmax=wmax)


def _solve_rows(f: SublatticeFactors, b):
    """x = A^{-1} b from stored inverses; b (..., K, nr, nc). A complex64
    store on the card runs the row-sweep kernel, one launch a direction
    (ops/fdfd_rowsweep.py); any other (CPU tensors, complex128 factors) the
    torch loop that is its plain version."""
    if f.Ws.is_cuda and f.Ws.dtype == torch.complex64:
        return fdfd_rowsweep.row_sweep(f.Ws, f.nvals.contiguous(), f.svals.contiguous(),
                                       b.contiguous())
    return fdfd_rowsweep.row_sweep_reference(f.Ws, f.nvals, f.svals, b)


def _solve_rows_ckpt(f: CkptSublatticeFactors, b):
    """x = A^{-1} b from checkpoints; b (..., nr, nc, K). The forward pass
    recomputes W ascending; the backward pass recomputes each segment's W
    from its checkpoint, then walks the segment in reverse."""
    nr = b.shape[-3]
    coeffs = (f.d, f.e, f.w, f.nvals, f.svals)
    W = f.Wc[..., 0, :, :]
    z = W @ b[..., 0, :, :]
    zs = [z]
    for r in range(1, nr):
        W = _w_step(W, *coeffs, r)
        z = W @ (b[..., r, :, :] - f.nvals[..., r, :, None] * z)
        zs.append(z)
    x = zs[-1]
    xs = [x]
    for k in reversed(range(nr // f.stride)):
        lo = k * f.stride
        hi = min(lo + f.stride, nr - 1)   # rows lo..hi-1 need their W
        Ws = [f.Wc[..., k, :, :]]
        for r in range(lo + 1, hi):
            Ws.append(_w_step(Ws[-1], *coeffs, r))
        for r in range(hi - 1, lo - 1, -1):
            x = zs[r] - Ws[r - lo] @ (f.svals[..., r, :, None] * x)
            xs.append(x)
    return torch.stack(xs[::-1], dim=-3)


# the row solve of each other sublattice factor type, b (..., nr, nc, K); a
# module defining another factor type adds its own (fdfd/compressed.py)
_ROW_SOLVES = {CkptSublatticeFactors: _solve_rows_ckpt}


def _solve_sub(f, b):
    """Solve one factored sublattice (or four stacked); b (..., K, nr, nc)."""
    if type(f) is SublatticeFactors:
        return _solve_rows(f, b)
    return _ROW_SOLVES[type(f)](f, b.movedim(-3, -1).contiguous()).movedim(-1, -3)


def _solve(factors, b):
    """x = A^{-1} b for b of shape batch + (Nx, Ny), batch + (Nx*Ny,) or
    batch + (K, Nx, Ny), ``batch`` being the factors' (one right-hand side,
    or K, for each factor set)."""
    Nx, Ny = factors.shape
    bk = b.reshape(factors.batch + (-1, Nx, Ny))
    if isinstance(factors, StackedFactors):
        parts = _solve_sub(factors.stacked, torch.stack(split_sublattices(bk)))
    else:
        parts = (_solve_sub(fs, bs) for fs, bs in zip(factors.subs, split_sublattices(bk)))
    return merge_sublattices(parts, torch.zeros_like(bk)).reshape(b.shape)


def _sublattice_coefficients(op: HelmholtzOperator):
    """Per parity, the (d, e, w, n, s) coefficients of that sublattice."""
    d, e, w, s, n = five_point_coefficients(op)
    return list(zip(*(split_sublattices(a) for a in (d, e, w, n, s))))


def factor(op: HelmholtzOperator) -> DirectFactors:
    """Factor A into the four sublattice block-Thomas forms (build once,
    solve many), one sublattice at a time (any N). An operator batched over
    scenes (models/datagen.py ``make_operator_traced``) gets one factor set
    a scene, each row step one batched inverse over the scenes."""
    return DirectFactors(subs=tuple(_factor_rows(*c) for c in _sublattice_coefficients(op)),
                         shape=op.shape, batch=op.batch_shape)


def solve_factored(f, b) -> torch.Tensor:
    """x = A^{-1} b from prebuilt factors (DirectFactors or StackedFactors);
    b (Nx, Ny) complex, or (B, Nx, Ny) against factors of B scenes."""
    return _solve(f, b)


def solve_direct(op: HelmholtzOperator, b) -> torch.Tensor:
    """One-shot exact solve (factor + solve)."""
    return solve_factored(factor(op), b)


def stack_coefficients(op: HelmholtzOperator):
    """Five-point coefficients restricted to each sublattice and stacked on
    a leading length-4 axis, order (d, e, w, n, s)."""
    return tuple(torch.stack(parts) for parts in zip(*_sublattice_coefficients(op)))


def factor_stacked(op: HelmholtzOperator, *, checkpointed: bool = False,
                   stride: int = 32) -> StackedFactors:
    """Stacked-sublattice factorization (even Nx/Ny only): the four
    sublattices' recursions run as one, batched on the leading axis. For an
    operator batched over B scenes every row step is one batched inverse
    over 4 x B blocks."""
    Nx, Ny = op.shape
    if Nx % 2 or Ny % 2:
        raise ValueError(f"stacked factors need even N, got {(Nx, Ny)}")
    stacked = _factor_rows(*stack_coefficients(op), stride=stride if checkpointed else None)
    return StackedFactors(stacked=stacked, shape=(Nx, Ny), batch=op.batch_shape)


def solve_stacked(f: StackedFactors, b) -> torch.Tensor:
    """x = A^{-1} b from stacked factors; b (Nx, Ny) complex."""
    return _solve(f, b)


def factor_checkpointed(op: HelmholtzOperator, stride: int = 32):
    """Checkpointed factorization of the four sublattices, one at a time
    (every sublattice's row count must divide by ``stride``)."""
    return tuple(_factor_rows(*c, stride=stride) for c in _sublattice_coefficients(op))


def solve_checkpointed(subs, b) -> torch.Tensor:
    """x = A^{-1} b from :func:`factor_checkpointed` factors; b (Nx, Ny)."""
    Nx, Ny = b.shape[-2:]
    return _solve(DirectFactors(subs=tuple(subs), shape=(Nx, Ny)), b)


# the largest grid side at which HPS refinement is measured to converge
HPS_MEASURED_GRID = 2048


class DirectSolver:
    """Build-once / solve-many exact solver with float64 refinement.

    The complex64 block-LU loses a few digits (no pivoting, f32 inverses);
    each :meth:`solve` wraps the factored backsolve in complex128 iterative
    refinement, so returned traces are TRUE float64 residuals. Even grids
    factor the four sublattices stacked; odd grids one at a time.
    ``checkpointed=True`` stores W every ``stride`` rows.
    ``compressed=True`` stores every W in HODLR form (fdfd/compressed.py:
    ``rank``, ``leaf``, ``power_iters``); ``stacked_solve=False`` factors and
    solves it one sublattice at a time. ``hps=True`` factors by nested
    dissection (fdfd/hps.py, ``hps_leaf``) and refines up to 40 rounds by
    default. Spans (utils/trace.py): ``fdfd.solve`` and
    ``fdfd.solve_batched`` around the entry points, ``fdfd.backsolve``
    around each complex64 inner solve, whatever the factor mode.
    """

    def __init__(self, eps, mu, dx, dy, omega, *, pml_thickness: int = 40,
                 sigma_max: float = 2.0, m: int = 3, dtype=torch.complex64,
                 checkpointed: bool = False, stride: int = 32,
                 compressed: bool = False, rank: int = 20, leaf: int = 128,
                 power_iters: int = 1, stacked_solve: bool = True,
                 hps: bool = False, hps_leaf: int = 8, device="cuda"):
        if sum((checkpointed, compressed, hps)) > 1:
            raise ValueError("choose one of checkpointed/compressed/hps")
        self.omega = float(omega)
        self.dtype = dtype
        self.op = make_operator(eps, mu, dx, dy, self.omega, pml_thickness, sigma_max, m,
                                dtype, device)
        Nx, Ny = self.op.shape
        even = Nx % 2 == 0 and Ny % 2 == 0
        self._default_refine_rounds = 8
        self._solve_with = _solve      # (factors, r) -> x; no bound method: no cycle
        if compressed:
            from fdtd2d_tpu_torch.fdfd import compressed as _comp

            nc = Ny // 2
            L = _comp.hodlr_plan(nc, leaf=leaf, rank=rank)
            omegas = _comp.make_test_matrices(nc, L, rank, dtype=dtype, device=self.op.device)
            if even and stacked_solve:
                self.factors = StackedFactors(
                    stacked=_comp.factor_compressed_stacked(stack_coefficients(self.op), omegas,
                                                            L=L, q=power_iters),
                    shape=(Nx, Ny))
                wmax = self.factors.stacked.wmax
            else:
                self.factors = _comp.factor_compressed(self.op, omegas, L=L, q=power_iters)
                wmax = torch.stack([s.wmax for s in self.factors.subs]).amax()
            self.compressed_bytes = _comp.compressed_bytes(self.factors)
        elif hps:
            # the raw complex64 error grows ~10x a grid doubling (fdfd/hps.py);
            # refinement is measured to converge up to 2048^2: past it, say so
            # before the factorization is paid for
            if max(np.shape(eps)) > HPS_MEASURED_GRID:
                warnings.warn(
                    "DirectSolver(hps=True) is past its measured accuracy wall (grid "
                    f"{tuple(np.shape(eps))}; measured up to {HPS_MEASURED_GRID}^2: on an H100 "
                    "the hard binary scene at contrast 3, 16 point sources a batch, refined "
                    "to a true residual of 1e-6 in 2-3 rounds with complex128 eliminations; "
                    "the raw complex64 error grows ~10x a grid doubling and larger grids are "
                    "unmeasured) — use checkpointed=True or compressed=True for exact solves "
                    "at this size", RuntimeWarning, stacklevel=2)
            from fdtd2d_tpu_torch.fdfd import hps as _hps

            self.factors = _hps.hps_factor(self.op, m=hps_leaf)
            self._solve_with = _hps.hps_solve
            self.hps_bytes = _hps.factor_bytes(self.factors)
            # the JAX package's c64 HPS solve contracted ~0.5 a round at
            # 1024^2 (fdfd/hps.py), where block-Thomas takes ~1e-4
            self._default_refine_rounds = 40
            wmax = self.factors.stacked.Yroot.abs().amax()
        elif even:
            self.factors = factor_stacked(self.op, checkpointed=checkpointed, stride=stride)
            wmax = self.factors.stacked.wmax
        else:
            subs = (factor_checkpointed(self.op, stride) if checkpointed
                    else factor(self.op).subs)
            self.factors = DirectFactors(subs=subs, shape=(Nx, Ny))
            wmax = torch.stack([s.wmax for s in subs]).amax()
        # element-growth diagnostic for the pivotless recursion: ||W||_max
        # scaled by the operator's diagonal magnitude. O(1..1e3) is healthy;
        # >>1e6 flags a near-singular leading block — solve() reports it on
        # a refinement stall.
        self.factor_growth = float(wmax * self.op.diagonal().abs().amax())

        def f64(a):
            return torch.as_tensor(a, device=device).to(torch.float64)

        self.op64 = make_operator(f64(eps), f64(mu), dx, dy, self.omega, pml_thickness,
                                  sigma_max, m, torch.complex128, device)

    def _solve(self, r: torch.Tensor) -> torch.Tensor:
        with span("fdfd.backsolve"):
            return self._solve_with(self.factors, r)

    def _rounds(self, max_refine_rounds: Optional[int]) -> int:
        return self._default_refine_rounds if max_refine_rounds is None else max_refine_rounds

    def _rhs(self, source, rhs_scale) -> torch.Tensor:
        scale = (-1j * self.omega) if rhs_scale is None else complex(rhs_scale)
        src = torch.as_tensor(source, device=self.op.device)
        return src.to(torch.complex128) * scale

    def solve(self, source, *, rhs_scale=None, refine_target: float = 1e-6,
              max_refine_rounds: Optional[int] = None,
              return_split: bool = False, verbose: bool = False):
        """Returns ``(field, trace)``: the trace holds the float64 iterate's
        true residual per refinement round plus a final entry for the
        returned downcast array (omitted with ``return_split=True``, which
        returns the complex128 solution). ``max_refine_rounds`` defaults per
        factor mode: 8 for the block-Thomas modes (typical contraction ~1e-4
        a round), 40 for ``hps`` (the JAX package's measured ~0.5 a round
        at 1024^2)."""
        with span("fdfd.solve"):
            b64 = self._rhs(source, rhs_scale)
            out = refine(self.op64, b64, self._solve, target=refine_target,
                         max_rounds=self._rounds(max_refine_rounds), inner_dtype=self.dtype)
            if out.relative_residual > refine_target:
                # the pivotless c64 factorization did not resolve a digit: say so,
                # with the element-growth diagnostic, instead of leaving a
                # silently-unconverged trace
                warnings.warn(
                    f"direct solve stalled at true residual "
                    f"{out.relative_residual:.2e} (target {refine_target:.0e}); "
                    f"factor element growth {self.factor_growth:.2e} — growth "
                    f">>1e6 indicates a near-singular leading block (pivotless "
                    f"block-LU); consider a PML/frequency perturbation or the "
                    f"Krylov path", RuntimeWarning, stacklevel=2)
            if verbose:
                print(f"direct (refined): true res={out.relative_residual:.3e} "
                      f"rounds={out.rounds}")
            if return_split:
                return out.x, out.trace
            xc = out.x.to(self.dtype)
            return xc, list(out.trace) + [true_relative_residual(self.op64, b64, xc)]

    def solve_batched(self, sources, *, rhs_scale=None,
                      refine_target: float = 1e-6,
                      max_refine_rounds: Optional[int] = None,
                      return_split: bool = False):
        """Solve MANY right-hand sides against the one stored factorization.
        Returns ``(fields (B, Nx, Ny), per_sample_residuals (B,) numpy,
        trace)``; the trace holds the worst-over-batch TRUE float64 residual
        per refinement round, and the residuals are those of the complex128
        iterate. The fields are its downcast to the factor's dtype, or with
        ``return_split=True`` the complex128 iterate itself, as
        :meth:`solve` returns it. The sources ride as the last axis of each
        row's matvec, and the refinement runs one batched float64 residual
        pass per round for the whole sweep."""
        with span("fdfd.solve_batched"):
            b64 = self._rhs(sources, rhs_scale)
            if b64.ndim != 3:
                raise ValueError(f"solve_batched wants (B, Nx, Ny) sources, "
                                 f"got {tuple(b64.shape)}")
            out = refine_batched(
                self.op64, b64, self._solve, target=refine_target,
                max_rounds=self._rounds(max_refine_rounds), inner_dtype=self.dtype)
            worst = float(out.relative_residual.max()) if b64.shape[0] else 0.0
            if worst > refine_target:
                warnings.warn(
                    f"batched direct solve stalled at worst true residual "
                    f"{worst:.2e} (target {refine_target:.0e}); factor element "
                    f"growth {self.factor_growth:.2e}", RuntimeWarning,
                    stacklevel=2)
            x = out.x if return_split else out.x.to(self.dtype)
            return x, out.relative_residual, out.trace
