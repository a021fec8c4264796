"""The port's FDFD operator, five-point coefficients, DST, FDM preconditioner
and hard scene against the JAX package's and the scipy assembly of the
reference's matrix (tests/test_fdfd_operator.py::scipy_make_A)."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.core.scenes import hard_binary_scene as jax_hard_scene
from fdtd2d_tpu.fdfd.direct import five_point_coefficients as jax_five_point
from fdtd2d_tpu.ops.dst import dst2d as jax_dst2d
from fdtd2d_tpu.ops.fdm import fdm_preconditioner_for as jax_fdm_for
from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd.direct import five_point_coefficients
from fdtd2d_tpu_torch.fdfd.solver import solve_fdfd
from fdtd2d_tpu_torch.ops.dst import dst2d, idst2d
from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner_for
from fdtd2d_tpu_torch.ops.helmholtz import make_operator, operator_from_numpy

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_fdfd_operator import scipy_make_A  # noqa: E402

DX, OMEGA = 1e-3, 17e9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These grids gain nothing from intra-op threads, and in a parallel
    test run the threads of every worker oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(N, seed=0):
    rng = np.random.default_rng(seed)
    eps = constants.EPSILON_0 * (1.0 + 2.0 * rng.random((N, N)))
    return eps, np.full((N, N), constants.MU_0)


def _field(N, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _ops(eps, mu, pml, dtype=torch.complex128):
    jdtype = jnp.complex128 if dtype == torch.complex128 else jnp.complex64
    return (make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=pml, dtype=dtype),
            jax_make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=pml, dtype=jdtype))


@pytest.mark.parametrize("pml", [0, 10])
def test_apply_matches_jax_and_scipy(pml):
    N = 48
    eps, mu = _scene(N)
    op, jop = _ops(eps, mu, pml)
    A = scipy_make_A(eps, mu, DX, DX, N, N, OMEGA, pml_thickness=pml)
    for seed in (1, 2):
        v = _field(N, seed)
        got = op(torch.as_tensor(v.ravel())).numpy()
        assert got.dtype == np.complex128 and got.shape == (N * N,)
        assert _rel(got, A @ v.ravel()) < 1e-12
        assert _rel(got, np.asarray(jop.apply(jnp.asarray(v))).ravel()) < 1e-12


def test_diagonal_matches_jax_and_scipy():
    N = 32
    eps, mu = _scene(N, seed=3)
    op, jop = _ops(eps, mu, 8)
    A = scipy_make_A(eps, mu, DX, DX, N, N, OMEGA, pml_thickness=8)
    got = op.diagonal().numpy()
    assert _rel(got.ravel(), A.diagonal()) < 1e-12
    assert _rel(got, jop.diagonal()) < 1e-12


def test_complex64_matches_complex128():
    """c64 operator: real fields in float32, apply and diagonal within 1e-5."""
    N = 48
    eps, mu = _scene(N, seed=4)
    op64 = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=10, dtype=torch.complex128)
    op32 = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=10, dtype=torch.complex64)
    assert op32.eps.dtype == op32.omega.dtype == op32.inv_2dx.dtype == torch.float32
    assert op32.dtype == torch.complex64
    v = torch.as_tensor(_field(N))
    assert _rel(op32.apply(v.to(torch.complex64)), op64.apply(v)) < 1e-5
    assert _rel(op32.diagonal(), op64.diagonal()) < 1e-5


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_operator_from_numpy_equals_make_operator(dtype):
    """The JAX operator's fields, taken through numpy, give the port's
    make_operator exactly (same dtypes and values), and the same apply."""
    N = 40
    eps, mu = _scene(N, seed=5)
    op, jop = _ops(eps, mu, 6, dtype)
    names = ("eps", "inv_mu", "inv_s_row", "inv_s_col", "omega", "inv_2dx", "inv_2dy")
    got = operator_from_numpy(*(np.asarray(getattr(jop, n)) for n in names),
                              pml_thickness=jop.pml_thickness, sigma_max=jop.sigma_max,
                              m=jop.m)
    for n in names:
        a, b = getattr(got, n), getattr(op, n)
        assert a.dtype == b.dtype and torch.equal(a, b), n
    assert (got.pml_thickness, got.sigma_max, got.m) == (op.pml_thickness, op.sigma_max, op.m)
    v = torch.as_tensor(_field(N)).to(dtype)
    assert torch.equal(got.apply(v), op.apply(v))


def test_residual_and_batched_apply():
    N = 24
    eps, mu = _scene(N, seed=6)
    op, _ = _ops(eps, mu, 4)
    xs = torch.as_tensor(np.stack([_field(N, s) for s in (1, 2, 3)]))
    batched = op.apply(xs)
    for k in range(3):
        assert torch.equal(batched[k], op.apply(xs[k]))
    b = torch.as_tensor(_field(N, 9))
    assert torch.equal(op.residual(b, xs[0]), b - op.apply(xs[0]))


def test_five_point_coefficients_match_jax_and_apply():
    N = 96
    eps, mu, _ = hard_binary_scene(N, seed=3, sigma=4.0, source_amp=10.0)
    op, jop = _ops(eps, mu, 16)
    coeffs = five_point_coefficients(op)
    for got, want in zip(coeffs, jax_five_point(jop)):
        assert _rel(got.numpy(), want) < 1e-12
    d, e, w, s, n = coeffs
    x = torch.as_tensor(_field(N, 0))
    z2 = torch.zeros((N, 2), dtype=x.dtype)
    xe = torch.cat([x[:, 2:], z2], 1)
    xw = torch.cat([z2, x[:, :-2]], 1)
    xs = torch.cat([x[2:], z2.T], 0)
    xn = torch.cat([z2.T, x[:-2]], 0)
    assert _rel(d * x + e * xe + w * xw + s * xs + n * xn, op.apply(x)) < 1e-12


def test_dst2d_matches_jax_and_inverts():
    x = _field(37)[:, :29]
    got = dst2d(torch.as_tensor(x))
    assert _rel(got.numpy(), jax_dst2d(jnp.asarray(x))) < 1e-10
    assert _rel(idst2d(got).numpy(), x) < 1e-12
    real = torch.as_tensor(x.real)
    assert _rel(dst2d(real).numpy(), jax_dst2d(jnp.asarray(x.real))) < 1e-10


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_fdm_preconditioner_matches_jax(dtype):
    N = 64
    eps, mu = _scene(N, seed=8)
    op, jop = _ops(eps, mu, 12, dtype)
    M, jM = fdm_preconditioner_for(op), jax_fdm_for(jop)
    assert M.Pr.dtype == dtype
    x = _field(N, 2)
    want = np.asarray(jM(jnp.asarray(x, jop.dtype)))
    got = M(torch.as_tensor(x).to(dtype)).numpy()
    assert _rel(got, want) < (1e-10 if dtype == torch.complex128 else 1e-5)
    flat = M(torch.as_tensor(x.ravel()).to(dtype))
    assert flat.shape == (N * N,)


def test_fdm_preconditioner_one_cycle():
    """FDM-preconditioned FGMRES converges within one restart cycle on a
    heterogeneous medium (as tests/test_fdfd_operator.py)."""
    N = 96
    eps, mu = _scene(N, seed=9)
    source = np.zeros((N, N))
    source[40, 40] = 1.0
    op, _ = _ops(eps, mu, 16)
    res = solve_fdfd(op, torch.as_tensor(-1j * OMEGA * source), preconditioner="fdm",
                     tol=1e-10, maxiter=40)
    assert res.relative_residual < 1e-10
    assert res.iterations == 40


def test_hard_binary_scene_identical_to_jax():
    for kw in ({}, {"seed": 3, "sigma": 4.0, "source_amp": 10.0, "source_xy": (5, 7)}):
        for got, want in zip(hard_binary_scene(64, **kw), jax_hard_scene(64, **kw)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
