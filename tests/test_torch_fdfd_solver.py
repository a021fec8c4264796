"""The port's FGMRES, preconditioners, solve_fdfd and run_fdfd against the
JAX package's (ops/krylov.py, fdfd/solver.py) and scipy's spsolve of the
reference-assembled matrix (as tests/test_fdfd_operator.py)."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdfd.solver import jacobi_preconditioner as jax_jacobi
from fdtd2d_tpu.fdfd.solver import run_fdfd as jax_run_fdfd
from fdtd2d_tpu.fdfd.solver import shifted_laplacian_preconditioner as jax_shifted
from fdtd2d_tpu.ops.fdm import fdm_preconditioner_for as jax_fdm_for
from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu.ops.krylov import fgmres as jax_fgmres
from fdtd2d_tpu_torch.fdfd.solver import (
    RefinedSolveResult, SolveResult, jacobi_preconditioner, run_fdfd,
    shifted_laplacian_preconditioner, solve_fdfd,
)
from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner_for
from fdtd2d_tpu_torch.ops.helmholtz import make_operator
from fdtd2d_tpu_torch.ops.krylov import fgmres

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


def _scene(N, seed):
    rng = np.random.default_rng(seed)
    eps = constants.EPSILON_0 * (1.0 + 2.0 * rng.random((N, N)))
    return eps, np.full((N, N), constants.MU_0)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_fgmres_matches_jax_and_spsolve():
    """FDM-FGMRES in complex128 at 128^2 (the scene of
    tests/test_fdfd_operator.py, restart 40): the same iteration count as the
    JAX package, residual <= 1e-8 and the field within 1e-5 of spsolve."""
    N = 128
    eps, mu = _scene(N, seed=7)
    source = np.zeros((N, N))
    source[N // 2, N // 2] = 10.0
    b = -1j * OMEGA * source
    kw = dict(tol=1e-9, maxiter=200, restart=40)
    res = solve_fdfd(make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=20,
                                   dtype=torch.complex128), torch.as_tensor(b),
                     preconditioner="fdm", **kw)
    jop = jax_make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=20, dtype=jnp.complex128)
    jres = jax_fgmres(jop.apply, jnp.asarray(b), jax_fdm_for(jop), **kw)
    assert isinstance(res, SolveResult) and res.converged
    assert res.relative_residual < 1e-8
    assert res.iterations == int(jres.iterations) == 40  # one whole restart cycle
    want = spla.spsolve(scipy_make_A(eps, mu, DX, DX, N, N, OMEGA, pml_thickness=20),
                        b.ravel()).reshape(N, N)
    assert _rel(res.x.numpy(), want) < 1e-5
    assert _rel(res.x.numpy(), jres.x) < 1e-6


def test_fgmres_complex64_matches_jax_iterations():
    """complex64 FDM-FGMRES with restart 20: the same number of restart
    cycles as the JAX package, and a residual within the same decade."""
    N = 64
    eps, mu = _scene(N, seed=2)
    eps[20:40, 16:32] *= 2.0
    source = np.zeros((N, N), np.complex128)
    source[N // 2, N // 2] = -1j * OMEGA
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=12)
    jop = jax_make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=12)
    out = fgmres(op.apply, torch.as_tensor(source).to(torch.complex64),
                 fdm_preconditioner_for(op), restart=20, maxiter=400, tol=1e-6)
    jout = jax_fgmres(jop.apply, jnp.asarray(source, jnp.complex64), jax_fdm_for(jop),
                      restart=20, maxiter=400, tol=1e-6)
    assert out.iterations == int(jout.iterations) and out.iterations % 20 == 0
    assert out.relative_residual <= 1e-6
    assert out.relative_residual / float(jout.relative_residual) == pytest.approx(1, abs=0.9)
    assert _rel(out.x.numpy(), jout.x) < 1e-4


def test_fgmres_breakdown_and_zero_rhs():
    """An exact solve in one Arnoldi step (identity operator) leaves zero
    vectors behind, which the guarded rotations and back-substitution skip;
    b = 0 returns x = 0 at once."""
    b = torch.arange(1.0, 7.0, dtype=torch.float64).to(torch.complex128)
    out = fgmres(lambda v: v, b, restart=4, tol=1e-12)
    assert out.iterations == 4 and out.relative_residual < 1e-15
    assert torch.allclose(out.x, b, rtol=1e-15, atol=0)
    zero = fgmres(lambda v: v, torch.zeros(5, dtype=torch.complex128), restart=4)
    assert zero.iterations == 0 and not zero.x.any()


@pytest.mark.parametrize("name", ["dst", "jacobi"])
def test_builtin_preconditioners_match_jax(name):
    N = 48
    eps, mu = _scene(N, seed=3)
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=10, dtype=torch.complex128)
    jop = jax_make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=10, dtype=jnp.complex128)
    ours, theirs = {"dst": (shifted_laplacian_preconditioner, jax_shifted),
                    "jacobi": (jacobi_preconditioner, jax_jacobi)}[name]
    r = np.random.default_rng(4).standard_normal((N, N)) + 0.5j
    got = ours(op)(torch.as_tensor(r.ravel()))
    assert got.shape == (N * N,) and got.dtype == torch.complex128
    assert _rel(got.numpy(), theirs(jop)(jnp.asarray(r.ravel()))) < 1e-10
    res = solve_fdfd(op, torch.as_tensor(r), preconditioner=name, tol=1e-3, maxiter=20,
                     restart=10)
    assert res.iterations == 20 and res.x.shape == (N, N)


def test_run_fdfd_plain_matches_jax():
    """run_fdfd without refinement (as tests/test_fdfd_operator.py)."""
    N = 64
    eps, mu = _scene(N, seed=11)
    src = np.zeros((N, N))
    src[32, 32] = 1.0
    kw = dict(pml_thickness=10, tol=1e-8, maxiter=2000)
    res = run_fdfd(eps, mu, DX, DX, OMEGA, src, dtype=torch.complex128, **kw)
    jres = jax_run_fdfd(eps, mu, DX, DX, OMEGA, src, dtype=jnp.complex128, **kw)
    assert res.x.shape == (N, N) and res.relative_residual < 1e-7
    assert _rel(res.x.numpy(), jres.x) < 1e-6


def test_run_fdfd_refined_matches_jax():
    """complex64 FDM-FGMRES inside complex128 refinement: the iterate meets
    the target, the downcast's residual is reported as such, and the fields
    match the JAX package's."""
    N = 64
    eps, mu = _scene(N, seed=12)
    src = np.zeros((N, N))
    src[20, 40] = 1.0
    kw = dict(pml_thickness=10, refine_target=1e-9, tol=1e-5, restart=20, maxiter=400)
    res = run_fdfd(eps, mu, DX, DX, OMEGA, src, **kw)
    jres = jax_run_fdfd(eps, mu, DX, DX, OMEGA, src, **kw)
    assert isinstance(res, RefinedSolveResult) and res.converged
    assert res.x.dtype == torch.complex64 and res.x64.dtype == torch.complex128
    assert res.x64_residual <= 1e-9 and res.trace[-1] == res.x64_residual
    assert res.relative_residual < 5e-5
    assert res.relative_residual == pytest.approx(float(jres.relative_residual), rel=0.5)
    assert _rel(res.x64.numpy(), np.asarray(jres.x64.re) + 1j * np.asarray(jres.x64.im)) < 1e-8


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_library_methods_not_ported(method):
    op = make_operator(*_scene(16, seed=0), DX, DX, OMEGA, pml_thickness=4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        solve_fdfd(op, torch.zeros((16, 16), dtype=torch.complex64), method=method)
    with pytest.raises(ValueError, match="unknown method"):
        solve_fdfd(op, torch.zeros((16, 16), dtype=torch.complex64), method="cg")
