"""Sparse-CSR layer with scipy-parity semantics (counterpart of
``fdtd2d_tpu/ops/sparse.py``, the reference's C8 layer).

The sparsity STRUCTURE is computed on the host with scipy (concrete numpy
indices, which also gives scipy-identical CSR layouts by construction); the
VALUES are torch tensors, differentiable by autograd and on any device.
``matvec`` and the value assembly use ``index_add``. ``_spsolve`` runs
scipy's sparse LU on the host, as the JAX module does through
``pure_callback``, with the transpose solve as its backward.

The matrix-free path (ops/helmholtz.py + fdfd/solver.py) is the production
path; this module serves API parity, CPU oracles and small direct solves.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch


def _device(like, device):
    """``device`` if given, else the device of the first tensor in ``like``,
    else the card."""
    if device is not None:
        return torch.device(device)
    for a in like:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cuda")


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


@dataclasses.dataclass
class CSR:
    """CSR matrix: tensor values + host (numpy) structure arrays."""

    data: torch.Tensor
    indices: np.ndarray
    indptr: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def _pattern(self) -> sp.csr_matrix:
        """scipy pattern (structure only, data=1)."""
        return sp.csr_matrix((np.ones(self.nnz), self.indices, self.indptr), shape=self.shape)

    def rows(self) -> np.ndarray:
        """Per-entry row indices."""
        return np.repeat(np.arange(self.shape[0]), np.diff(self.indptr))

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.data.device)
        dev = self.data.device
        return out.index_put_((_index(self.rows(), dev), _index(self.indices, dev)),
                              self.data, accumulate=True)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        dev = self.data.device
        contrib = self.data * v[_index(self.indices, dev)]
        out = torch.zeros(self.shape[0], dtype=contrib.dtype, device=dev)
        return out.index_add(0, _index(self.rows(), dev), contrib)

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix((self.data.detach().cpu().numpy(), self.indices, self.indptr),
                             shape=self.shape)

    def __matmul__(self, other):
        if isinstance(other, CSR):
            return _sp_matmul(self, other)
        return self.matvec(other)

    @property
    def T(self) -> "CSR":
        marked = sp.csr_matrix((np.arange(self.nnz), self.indices, self.indptr),
                               shape=self.shape)
        t = marked.T.tocsr()
        t.sort_indices()
        return CSR(data=self.data[_index(t.data, self.data.device)], indices=t.indices,
                   indptr=t.indptr, shape=(self.shape[1], self.shape[0]))


def from_scipy(A, device="cuda") -> CSR:
    A = sp.csr_matrix(A)
    A.sort_indices()
    return CSR(data=torch.as_tensor(A.data, device=device), indices=A.indices,
               indptr=A.indptr, shape=A.shape)


def _diags(diagonals, offsets, shape: Tuple[int, int], device=None) -> CSR:
    """scipy.sparse.diags equivalent with tensor diagonal values (on the
    device of the first tensor diagonal, unless ``device`` says)."""
    if np.isscalar(offsets):
        offsets = [offsets]
        diagonals = [diagonals]
    dev = _device(diagonals, device)
    n, m = shape
    # symbolic: scipy with slot markers 1..nnz per diagonal, concatenated
    marker_diags, flat_vals = [], []
    slot = 1
    for d, off in zip(diagonals, offsets):
        L = min(n + min(off, 0), m - max(off, 0))
        d = torch.atleast_1d(torch.as_tensor(d, device=dev))
        if d.shape[0] == 1:
            d = d.reshape(-1)[0].expand(L)
        if d.shape[0] != L:
            raise ValueError(f"diagonal length {d.shape[0]} != {L}")
        marker_diags.append(np.arange(slot, slot + L, dtype=np.float64))
        flat_vals.append(d)
        slot += L
    M = sp.diags(marker_diags, offsets, shape=shape).tocsr()
    M.sort_indices()
    perm = M.data.astype(np.int64) - 1
    vals = torch.cat(flat_vals)[_index(perm, dev)]
    return CSR(data=vals, indices=M.indices, indptr=M.indptr, shape=shape)


def _eye(n: int, dtype=torch.float64, device="cuda") -> CSR:
    return _diags(torch.ones(n, dtype=dtype, device=device), 0, (n, n))


def _kron(A: CSR, B: CSR) -> CSR:
    """Kronecker product via direct COO index algebra (canonical CSR layout;
    scipy's kron may keep explicit block zeros on dense-ish inputs, but dense
    round-trips agree exactly)."""
    a_rows, a_cols = A.rows(), A.indices
    b_rows, b_cols = B.rows(), B.indices
    Bn, Bm = B.shape
    rows = (a_rows[:, None] * Bn + b_rows[None, :]).ravel()
    cols = (a_cols[:, None] * Bm + b_cols[None, :]).ravel()
    order = np.lexsort((cols, rows))
    shape = (A.shape[0] * Bn, A.shape[1] * Bm)
    vals = (A.data[:, None] * B.data[None, :]).reshape(-1)[_index(order, A.data.device)]
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.add.at(indptr, rows[order] + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(data=vals, indices=cols[order], indptr=indptr, shape=shape)


def _slots(lut: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Output slots of (rows, cols) in a pattern whose entries hold 1..nnz."""
    return np.asarray(lut[rows, cols]).ravel().astype(np.int64) - 1


def _sp_matmul(A: CSR, B: CSR) -> CSR:
    """Sparse-sparse product with scipy's structural semantics."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"shapes {A.shape} and {B.shape} do not align")
    C_pat = (A._pattern() @ B._pattern()).tocsr()
    C_pat.sort_indices()

    # enumerate contributing (slotA, slotB) pairs on the host
    a_rows, a_cols = A.rows(), A.indices
    b_indptr, b_cols = B.indptr, B.indices
    counts = np.diff(b_indptr)[a_cols]              # B-row length per A entry
    sa = np.repeat(np.arange(A.nnz), counts)
    sb = np.concatenate([
        np.arange(b_indptr[k], b_indptr[k + 1]) for k in a_cols
    ]) if A.nnz else np.zeros(0, np.int64)
    out_i = np.repeat(a_rows, counts)
    out_j = b_cols[sb]
    lut = sp.csr_matrix((np.arange(C_pat.nnz) + 1.0, C_pat.indices, C_pat.indptr),
                        shape=C_pat.shape)
    dev = A.data.device
    prod = A.data[_index(sa, dev)] * B.data[_index(sb, dev)]
    vals = torch.zeros(C_pat.nnz, dtype=prod.dtype, device=dev).index_add(
        0, _index(_slots(lut, out_i, out_j), dev), prod)
    return CSR(data=vals, indices=C_pat.indices, indptr=C_pat.indptr,
               shape=(A.shape[0], B.shape[1]))


def _sp_add(A: CSR, B: CSR, alpha=1.0, beta=1.0) -> CSR:
    """alpha*A + beta*B with scipy's union structure."""
    if A.shape != B.shape:
        raise ValueError(f"shapes {A.shape} and {B.shape} differ")
    S = (A._pattern() + B._pattern()).tocsr()
    S.sort_indices()
    lut = sp.csr_matrix((np.arange(S.nnz) + 1.0, S.indices, S.indptr), shape=S.shape)
    dev = A.data.device
    a, b = alpha * A.data, beta * B.data
    vals = torch.zeros(S.nnz, dtype=torch.promote_types(a.dtype, b.dtype), device=dev)
    vals = vals.index_add(0, _index(_slots(lut, A.rows(), A.indices), dev), a.to(vals.dtype))
    vals = vals.index_add(0, _index(_slots(lut, B.rows(), B.indices), dev), b.to(vals.dtype))
    return CSR(data=vals, indices=S.indices, indptr=S.indptr, shape=A.shape)


# ---------------------------------------------------------------------------
# Direct solve through scipy with the adjoint as its backward
# ---------------------------------------------------------------------------


def _host_spsolve(A: sp.csr_matrix, b: torch.Tensor, transpose=False) -> torch.Tensor:
    from scipy.sparse.linalg import spsolve as scipy_spsolve

    if transpose:
        A = A.T
    x = scipy_spsolve(A.tocsc(), b.detach().cpu().numpy())
    return torch.as_tensor(np.asarray(x), device=b.device)


class _SpSolve(torch.autograd.Function):
    """x = A^{-1} b; differentiable in A's values and in b."""

    @staticmethod
    def forward(ctx, data, b, A):
        dtype = torch.promote_types(data.dtype, b.dtype)
        x = _host_spsolve(A.to_scipy(), b.to(dtype)).to(dtype)
        ctx.save_for_backward(data, x)
        ctx.A = A
        return x

    @staticmethod
    def backward(ctx, g):
        # torch's gradient of a complex tensor is the conjugate of JAX's
        # cotangent: lam = A^{-T} conj(g) is the JAX module's adjoint, and
        # the gradients are the conjugates of its data_bar and b_bar
        data, x = ctx.saved_tensors
        A = dataclasses.replace(ctx.A, data=data)
        lam = _host_spsolve(A.to_scipy(), torch.conj_physical(g), transpose=True).to(x.dtype)
        dev = data.device
        data_bar = b_bar = None
        if ctx.needs_input_grad[0]:
            data_bar = -torch.conj_physical(lam[_index(A.rows(), dev)] * x[_index(A.indices, dev)])
            data_bar = data_bar if data.is_complex() else data_bar.real
            data_bar = data_bar.to(data.dtype)
        if ctx.needs_input_grad[1]:
            b_bar = torch.conj_physical(lam)
        return data_bar, b_bar, None


def _spsolve(A: CSR, b: torch.Tensor) -> torch.Tensor:
    """x = A^{-1} b by scipy's sparse LU on the host, differentiable in
    ``A.data`` and ``b``. The LU runs on the host whatever the device, as
    the JAX module's ``pure_callback`` does; the result is returned on
    ``b``'s device."""
    b = torch.as_tensor(b, device=A.data.device)
    return _SpSolve.apply(A.data, b, A)


# ---------------------------------------------------------------------------
# Reference-contract entry points
# ---------------------------------------------------------------------------


def make_A_jax(eps, mu, dx, dy, Nx, Ny, omega, pml_thickness: int = 40,
               sigma_max: float = 2.0, m: int = 3, device=None) -> CSR:
    """Assembled UPML Helmholtz CSR, element-for-element equal to the scipy
    assembly (reference python-src/fdfd.py:14-61, the contract of
    python-src/test_jax_fdfd.py); the JAX module's name is kept. On the
    device of ``eps`` when it is a tensor, unless ``device`` says; else on
    the card."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.ops.helmholtz import pml_sigma_profile

    dev = _device([eps, mu], device)
    eps = torch.as_tensor(eps, device=dev)
    mu = torch.as_tensor(mu, device=dev)
    cdtype = torch.promote_types(eps.dtype, torch.complex64)

    sig_x = pml_sigma_profile(Nx, pml_thickness, sigma_max, m)
    sig_y = pml_sigma_profile(Ny, pml_thickness, sigma_max, m)
    s_x = 1.0 + 1j * np.tile(sig_x[None, :], (Ny, 1)) / (omega * constants.EPSILON_0)
    s_y = 1.0 + 1j * np.tile(sig_y[:, None], (1, Nx)) / (omega * constants.EPSILON_0)

    def full(n, v):
        return torch.full((n,), v, dtype=torch.float64, device=dev)

    def scaled(M: CSR, by: float) -> CSR:
        return dataclasses.replace(M, data=M.data / by)

    def as_complex(M: CSR) -> CSR:
        return dataclasses.replace(M, data=M.data.to(cdtype))

    nn = Nx * Ny
    Dx = scaled(_diags([full(Nx - 1, -1.0), full(Nx - 1, 1.0)], [-1, 1], (Nx, Nx)), 2 * dx)
    Dy = scaled(_diags([full(Ny - 1, -1.0), full(Ny - 1, 1.0)], [-1, 1], (Ny, Ny)), 2 * dy)

    C_x = _kron(_eye(Ny, device=dev), Dx)
    C_y = _kron(Dy, _eye(Nx, device=dev))
    S_x = _diags(torch.as_tensor(1.0 / s_x.flatten(), device=dev).to(cdtype), 0, (nn, nn))
    S_y = _diags(torch.as_tensor(1.0 / s_y.flatten(), device=dev).to(cdtype), 0, (nn, nn))
    C_x = _sp_matmul(S_x, as_complex(C_x))
    C_y = _sp_matmul(S_y, as_complex(C_y))

    M_eps = _diags(eps.flatten().to(cdtype), 0, (nn, nn))
    M_mu = _diags((1.0 / mu.flatten()).to(cdtype), 0, (nn, nn))

    term_x = _sp_matmul(_sp_matmul(C_x, M_mu), C_x.T)
    term_y = _sp_matmul(_sp_matmul(C_y, M_mu), C_y.T)
    return _sp_add(_sp_add(term_x, term_y), M_eps, beta=-(omega**2))


def solve_linear(A, b) -> torch.Tensor:
    """Solve A x = b: direct sparse LU for CSR, preconditioned Krylov for
    matrix-free operators (reference contract: fdfd.py:8, inverse_design.py:1)."""
    from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator

    if isinstance(A, CSR):
        return _spsolve(A, b)
    if isinstance(A, HelmholtzOperator):
        from fdtd2d_tpu_torch.fdfd.solver import solve_fdfd

        return solve_fdfd(A, torch.as_tensor(b, device=A.device)).x.reshape(-1)
    raise TypeError(f"unsupported operator type {type(A)!r}")


def sparse_solve(A: CSR, b, numerical: bool = True) -> torch.Tensor:
    """Reference contract (utils.py:6-12): numerical -> scipy's LU on the
    host; analytic -> densify and solve with torch on A's device
    (differentiable through autograd)."""
    if numerical:
        return _spsolve(A, b)
    b = torch.as_tensor(b, device=A.data.device)
    return torch.linalg.solve(A.todense(), b.to(torch.promote_types(A.dtype, b.dtype)))
