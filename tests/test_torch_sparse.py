"""The port's sparse-CSR layer (fdtd2d_tpu_torch/ops/sparse.py): every case of
tests/test_sparse.py, against scipy and against the JAX package's functions
on the same inputs, at that file's bounds."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from fdtd2d_tpu.ops import sparse as jax_sparse
from fdtd2d_tpu_torch.ops.sparse import (
    CSR, _diags, _eye, _kron, _sp_add, _sp_matmul, _spsolve, from_scipy, make_A_jax,
    solve_linear, sparse_solve,
)

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_fdfd_operator import _scene, scipy_make_A  # noqa: E402


def _csr(A):
    return from_scipy(A, device="cpu")


def _dense(M):
    return M.todense().numpy()


def test_diags_matches_scipy_and_jax():
    diagonals = [np.arange(1.0, 5.0), np.arange(1.0, 6.0), np.arange(1.0, 5.0)]
    offsets = [-1, 0, 1]
    want = sp.diags(diagonals, offsets, shape=(5, 5)).toarray()
    got = _diags([torch.tensor(d) for d in diagonals], offsets, (5, 5))
    np.testing.assert_array_equal(_dense(got), want)
    theirs = jax_sparse._diags([jnp.asarray(d) for d in diagonals], offsets, (5, 5))
    np.testing.assert_array_equal(got.indices, np.asarray(theirs.indices))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(theirs.data))


def test_diags_rectangular_and_scalar():
    want = sp.diags([2.0], [1], shape=(3, 5)).toarray()
    np.testing.assert_array_equal(_dense(_diags([torch.full((3,), 2.0)], [1], (3, 5))), want)
    # a one-element diagonal is broadcast, and a scalar offset takes one diagonal
    np.testing.assert_array_equal(_dense(_diags(torch.tensor([2.0]), 1, (3, 5))), want)
    np.testing.assert_array_equal(_dense(_eye(4, device="cpu")), np.eye(4))


def test_kron_matches_scipy():
    rng = np.random.default_rng(0)
    A = sp.random(6, 5, density=0.4, random_state=rng).tocsr()
    B = sp.random(4, 7, density=0.5, random_state=rng).tocsr()
    got = _kron(_csr(A), _csr(B))
    np.testing.assert_allclose(_dense(got), sp.kron(A, B).toarray(), atol=1e-14)
    theirs = jax_sparse._kron(jax_sparse.from_scipy(A), jax_sparse.from_scipy(B))
    np.testing.assert_array_equal(got.indptr, np.asarray(theirs.indptr))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(theirs.data), atol=1e-14)


def test_sp_matmul_matches_scipy():
    rng = np.random.default_rng(1)
    A = sp.random(8, 6, density=0.4, random_state=rng).tocsr()
    B = sp.random(6, 9, density=0.4, random_state=rng).tocsr()
    got = _sp_matmul(_csr(A), _csr(B))
    np.testing.assert_allclose(_dense(got), (A @ B).toarray(), atol=1e-14)
    np.testing.assert_allclose(_dense(_csr(A) @ _csr(B)), (A @ B).toarray(), atol=1e-14)
    theirs = jax_sparse._sp_matmul(jax_sparse.from_scipy(A), jax_sparse.from_scipy(B))
    np.testing.assert_array_equal(got.indices, np.asarray(theirs.indices))


def test_sp_add_transpose_and_matvec():
    rng = np.random.default_rng(2)
    A = sp.random(7, 7, density=0.3, random_state=rng).tocsr()
    B = sp.random(7, 7, density=0.3, random_state=rng).tocsr()
    got = _sp_add(_csr(A), _csr(B), alpha=2.0, beta=-3.0)
    np.testing.assert_allclose(_dense(got), (2 * A - 3 * B).toarray(), atol=1e-14)
    np.testing.assert_allclose(_dense(_csr(A).T), A.T.toarray(), atol=1e-14)
    v = rng.standard_normal(7)
    np.testing.assert_allclose((_csr(A) @ torch.tensor(v)).numpy(), A @ v, atol=1e-14)
    assert (got.to_scipy() != (2 * A - 3 * B)).nnz == 0


def test_spsolve_matches_scipy():
    rng = np.random.default_rng(3)
    A = (sp.random(30, 30, density=0.2, random_state=rng) + sp.eye(30) * 5.0).tocsr()
    b = rng.standard_normal(30)
    want = spla.spsolve(A.tocsc(), b)
    np.testing.assert_allclose(_spsolve(_csr(A), torch.tensor(b)).numpy(), want, rtol=1e-10)


def test_spsolve_gradient_matches_dense_and_jax():
    rng = np.random.default_rng(4)
    A = (sp.random(12, 12, density=0.35, random_state=rng) + sp.eye(12) * 4.0).tocsr()
    Ac = _csr(A)
    b = rng.standard_normal(12)

    def grads(solve):
        data = Ac.data.clone().requires_grad_(True)
        bt = torch.tensor(b, requires_grad=True)
        x = solve(CSR(data, Ac.indices, Ac.indptr, Ac.shape), bt)
        return torch.autograd.grad((x**2).sum(), (data, bt))

    g_s = grads(_spsolve)
    g_d = grads(lambda M, bb: torch.linalg.solve(M.todense(), bb))
    for a, c in zip(g_s, g_d):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-8, atol=1e-10)
    Aj = jax_sparse.from_scipy(A)

    def jloss(data, bb):
        x = jax_sparse._spsolve(jax_sparse.CSR(data, Aj.indices, Aj.indptr, Aj.shape), bb)
        return jnp.sum(x**2)

    g_j = jax.grad(jloss, argnums=(0, 1))(Aj.data, jnp.asarray(b))
    for a, c in zip(g_s, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-8, atol=1e-10)


def test_spsolve_complex_gradient_matches_dense():
    """Complex values and a complex source under a loss that is not
    invariant to a global phase: torch's conjugate convention in the
    transpose-solve backward."""
    rng = np.random.default_rng(6)
    A = (sp.random(10, 10, density=0.4, random_state=rng) + sp.eye(10) * 4.0).tocsr()
    A = (A + 1j * sp.random(10, 10, density=0.3, random_state=rng)).tocsr()
    Ac = _csr(A)
    b = rng.standard_normal(10) + 1j * rng.standard_normal(10)
    w = torch.tensor(rng.standard_normal(10) + 1j * rng.standard_normal(10))

    def grads(solve):
        data = Ac.data.clone().requires_grad_(True)
        bt = torch.tensor(b, requires_grad=True)
        x = solve(CSR(data, Ac.indices, Ac.indptr, Ac.shape), bt)
        return torch.autograd.grad((w * x).sum().real + (x.abs() ** 2).sum(), (data, bt))

    g_s = grads(_spsolve)
    g_d = grads(lambda M, bb: torch.linalg.solve(M.todense(), bb))
    for a, c in zip(g_s, g_d):
        assert a.dtype == torch.complex128
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-8, atol=1e-10)


def test_make_A_jax_data_parity():
    """CSR .data elementwise equality with the scipy assembly (the contract
    of reference python-src/test_jax_fdfd.py:37-47), and with the JAX
    package's make_A_jax."""
    N, dx, omega = 40, 1e-3, 17e9
    eps, mu = _scene(N, seed=13)
    want = scipy_make_A(eps, mu, dx, dx, N, N, omega, pml_thickness=8)
    want.sort_indices()
    got = make_A_jax(torch.tensor(eps), torch.tensor(mu), dx, dx, N, N, omega, pml_thickness=8)
    assert got.nnz == want.nnz and got.dtype == torch.complex128
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data.numpy(), want.data, rtol=1e-6, atol=1e-6)
    theirs = jax_sparse.make_A_jax(jnp.asarray(eps), jnp.asarray(mu), dx, dx, N, N, omega,
                                   pml_thickness=8)
    np.testing.assert_array_equal(got.indptr, np.asarray(theirs.indptr))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(theirs.data), rtol=1e-12)


def test_solve_linear_and_sparse_solve():
    rng = np.random.default_rng(5)
    A = (sp.random(20, 20, density=0.3, random_state=rng) + sp.eye(20) * 3.0).tocsr()
    b = rng.standard_normal(20)
    want = spla.spsolve(A.tocsc(), b)
    Ac = _csr(A)
    np.testing.assert_allclose(solve_linear(Ac, torch.tensor(b)).numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(sparse_solve(Ac, torch.tensor(b), numerical=True).numpy(), want,
                               rtol=1e-10)
    np.testing.assert_allclose(sparse_solve(Ac, torch.tensor(b), numerical=False).numpy(), want,
                               rtol=1e-8)


def test_solve_linear_takes_a_matrix_free_operator():
    """solve_linear on a HelmholtzOperator is solve_fdfd's field, flattened,
    and equals the LU solve of the assembled matrix."""
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    N, dx, omega = 24, 1e-3, 17e9
    eps, mu = _scene(N, seed=3)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=6, dtype=torch.complex128,
                       device="cpu")
    b = np.zeros(N * N, np.complex128)
    b[N * N // 2 + N // 2] = -1j * omega
    x = solve_linear(op, torch.tensor(b))
    A = make_A_jax(torch.tensor(eps), torch.tensor(mu), dx, dx, N, N, omega, pml_thickness=6)
    want = _spsolve(A, torch.tensor(b))
    assert x.shape == (N * N,)
    assert float((x - want).abs().max() / want.abs().max()) < 1e-5
