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
from fdtd2d_tpu.fdfd.solver import solve_fdfd as jax_solve_fdfd
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
                                   dtype=torch.complex128, device="cpu"), torch.as_tensor(b),
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
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=12, device="cpu")
    jop = jax_make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=12)
    out = fgmres(op.apply, torch.as_tensor(source).to(torch.complex64),
                 fdm_preconditioner_for(op), restart=20, maxiter=400, tol=1e-6)
    jout = jax_fgmres(jop.apply, jnp.asarray(source, jnp.complex64), jax_fdm_for(jop),
                      restart=20, maxiter=400, tol=1e-6)
    assert out.iterations == int(jout.iterations) and out.iterations % 20 == 0
    assert out.relative_residual <= 1e-6
    assert out.relative_residual / float(jout.relative_residual) == pytest.approx(1, abs=0.9)
    assert _rel(out.x.numpy(), jout.x) < 1e-4


def test_solve_fdfd_warm_start_matches_jax_counts():
    """``solve_fdfd(x0=)`` reaches fgmres, as the JAX package's _solve_core
    passes it: restarted from a solution of looser tolerance, the solve takes
    fewer restart cycles than a cold one, the same number as JAX from the
    same warm start, and ends at the same field."""
    from fdtd2d_tpu.fdfd.solver import _solve_core as jax_solve_core
    from fdtd2d_tpu.fdfd.solver import resolve_preconditioner as jax_resolve

    N = 64
    eps, mu = _scene(N, seed=5)
    eps[20:40, 16:32] *= 2.0
    b = np.zeros((N, N), np.complex128)
    b[N // 2, N // 2] = -1j * OMEGA
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=12, dtype=torch.complex128,
                       device="cpu")
    jop = jax_make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=12, dtype=jnp.complex128)
    kw = dict(tol=1e-10, maxiter=400, restart=10)
    cold = solve_fdfd(op, torch.as_tensor(b), **kw)
    rough = solve_fdfd(op, torch.as_tensor(b), tol=1e-4, maxiter=400, restart=10)
    warm = solve_fdfd(op, torch.as_tensor(b), x0=rough.x.reshape(-1), **kw)
    assert cold.converged and warm.converged
    assert 0 < warm.iterations < cold.iterations
    assert warm.iterations + rough.iterations <= cold.iterations + kw["restart"]
    jM, jbuiltin = jax_resolve(jop, "fdm")
    jkw = dict(method="fgmres", builtin_pc=jbuiltin, **kw)
    jcold = jax_fgmres(jop.apply, jnp.asarray(b), jM, **kw)
    jwarm = jax_fgmres(jop.apply, jnp.asarray(b), jM, x0=jnp.asarray(rough.x.numpy()), **kw)
    assert (cold.iterations, warm.iterations) == (int(jcold.iterations), int(jwarm.iterations))
    jres = jax_solve_core(jop, jnp.asarray(b), jM, x0=jnp.asarray(rough.x.numpy()), **jkw)
    assert _rel(warm.x.numpy(), jres.x) < 1e-6
    assert _rel(warm.x.numpy(), cold.x.numpy()) < 1e-6


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
    op = make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=10, dtype=torch.complex128,
                       device="cpu")
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
    res = run_fdfd(eps, mu, DX, DX, OMEGA, src, dtype=torch.complex128, device="cpu", **kw)
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
    res = run_fdfd(eps, mu, DX, DX, OMEGA, src, device="cpu", **kw)
    jres = jax_run_fdfd(eps, mu, DX, DX, OMEGA, src, **kw)
    assert isinstance(res, RefinedSolveResult) and res.converged
    assert res.x.dtype == torch.complex64 and res.x64.dtype == torch.complex128
    assert res.x64_residual <= 1e-9 and res.trace[-1] == res.x64_residual
    assert res.relative_residual < 5e-5
    assert res.relative_residual == pytest.approx(float(jres.relative_residual), rel=0.5)
    assert _rel(res.x64.numpy(), np.asarray(jres.x64.re) + 1j * np.asarray(jres.x64.im)) < 1e-8


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_library_methods_not_ported(method):
    """The JAX package's library methods, once raising here, now run: a zero
    right-hand side gives the zero field at once; an unknown method still
    raises. (Their parity with JAX: test_library_methods_match_jax.)"""
    op = make_operator(*_scene(16, seed=0), DX, DX, OMEGA, pml_thickness=4, device="cpu")
    out = solve_fdfd(op, torch.zeros((16, 16), dtype=torch.complex64), method=method)
    assert out.iterations == 0 and not out.x.abs().any() and out.relative_residual == 0
    with pytest.raises(ValueError, match="unknown method"):
        solve_fdfd(op, torch.zeros((16, 16), dtype=torch.complex64), method="cg")


def test_entry_points_default_to_the_card():
    """Every public constructor and entry point runs on the card unless the
    caller asks for the CPU, as FDTDConfig.device does: a user who builds an
    operator and solves on it never solves on the CPU without having asked.
    The ``*_from_numpy`` helpers, which carry JAX parameters across for the
    tests, keep the CPU."""
    import inspect

    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig

    def default(fn):
        return inspect.signature(fn).parameters["device"].default

    from fdtd2d_tpu_torch.core import grid
    from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner
    from fdtd2d_tpu_torch.ops.helmholtz import operator_from_numpy
    from fdtd2d_tpu_torch.utils.metrics import Timer

    assert default(DirectSolver.__init__) == default(run_fdfd) == FDTDConfig.device == "cuda"
    for fn in (make_operator, fdm_preconditioner, grid.grid_init, grid.Scene.vacuum,
               grid.Scene.from_image, Timer.__init__):
        assert default(fn) == "cuda", fn
    for fn in (grid.scene_from_numpy, grid.state_from_numpy, operator_from_numpy):
        assert default(fn) == "cpu", fn


def _sharded_scene(N):
    """The scene of tests/test_sharded.py (seed 21, eps in [1, 2) eps0, a
    point source of 5 at (N/2, N/3)): b = -1j omega source."""
    rng = np.random.default_rng(21)
    eps = constants.EPSILON_0 * (1.0 + rng.random((N, N)))
    src = np.zeros((N, N))
    src[N // 2, N // 3] = 5.0
    return eps, np.full((N, N), constants.MU_0), -1j * OMEGA * src


@pytest.fixture(scope="module")
def library_ops():
    eps, mu, b = _sharded_scene(64)
    return (make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=10, dtype=torch.complex128,
                          device="cpu"),
            jax_make_operator(eps, mu, DX, DX, OMEGA, pml_thickness=10, dtype=jnp.complex128),
            b)


# (method, preconditioner, tol, maxiter, whether JAX's solve converges there).
# JAX's gmres is left-preconditioned and stops when ||M (b - A x)|| <= tol ||b||:
# the FDM and Jacobi inverses shrink norms ~1e-12-fold, so at tol 1e-6 (and
# Jacobi even at 1e-10) it returns x0 = 0 without an iteration; the port does
# the same. Unpreconditioned BiCGSTAB amplifies rounding ~1e7-fold every ten
# iterations on this scene (JAX's own stalls at 1.2e-4 after 2000), so it is
# held step for step over its first 10; unpreconditioned GMRES over 3 cycles
# (JAX's is at 5.7e-2 after 2000).
LIBRARY_CASES = [
    ("bicgstab", "fdm", 1e-10, 2000, True),
    ("bicgstab", "jacobi", 1e-10, 2000, True),
    ("bicgstab", None, 1e-10, 10, False),
    ("gmres", "fdm", 1e-10, 2000, True),
    ("gmres", "fdm", 1e-6, 2000, False),
    ("gmres", "jacobi", 1e-10, 2000, False),
    ("gmres", None, 1e-10, 3, False),
]


@pytest.mark.parametrize("method,pc,tol,maxiter,converges", LIBRARY_CASES)
def test_library_methods_match_jax(library_ops, method, pc, tol, maxiter, converges):
    """BiCGSTAB and GMRES against the JAX package's solve_fdfd (its
    jax.scipy solvers) on the same complex128 operator at 64^2: the fields
    within 1e-8 (max |difference| / max |JAX's|; equal where both are zero)
    and, where JAX's converges, both residuals below 10 tol (else the same
    residual: the iterates are the same)."""
    op, jop, b = library_ops
    kw = dict(method=method, preconditioner=pc, tol=tol, maxiter=maxiter)
    got = solve_fdfd(op, torch.as_tensor(b), **kw)
    want = jax_solve_fdfd(jop, jnp.asarray(b), **kw)
    jx = np.asarray(want.x)
    if np.abs(jx).max() == 0:
        assert not got.x.abs().any() and got.iterations == 0
    else:
        assert _rel(got.x.numpy(), jx) < 1e-8
    jres = float(want.relative_residual)
    assert bool(want.converged) == got.converged == converges
    if converges:
        assert got.relative_residual < 10 * tol and jres < 10 * tol
    else:
        assert got.relative_residual == pytest.approx(jres, rel=1e-6)
