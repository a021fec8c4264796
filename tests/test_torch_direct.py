"""The port's sublattice block-Thomas solver and complex128 refinement
against the JAX package's (fdfd/direct.py, fdfd/refine.py) and scipy's
spsolve of the reference-assembled matrix, on the hard binary scene of
tests/test_direct.py."""

import pathlib
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from fdtd2d_tpu.fdfd.direct import solve_direct as jax_solve_direct
from fdtd2d_tpu.fdfd.refine import refine as jax_refine
from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu.ops.splitc import make_operator_f64, split_from_numpy
from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd.direct import (
    DirectSolver, factor, factor_checkpointed, factor_stacked, solve_checkpointed,
    solve_direct, solve_factored, solve_stacked,
)
from fdtd2d_tpu_torch.fdfd.refine import refine, scaled_norm
from fdtd2d_tpu_torch.ops.helmholtz import make_operator

sys.path.insert(0, str(pathlib.Path(__file__).parent))
from test_fdfd_operator import scipy_make_A  # noqa: E402

DX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These grids gain nothing from intra-op threads, and in a parallel
    test run the threads of every worker oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hard_scene(N, seed=3):
    return hard_binary_scene(N, seed=seed, sigma=4.0, source_amp=10.0)


def _op(N, omega, pml, dtype=torch.complex128):
    eps, mu, src = _hard_scene(N)
    return make_operator(eps, mu, DX, DX, omega, pml_thickness=pml, dtype=dtype), src


def _residual(op, x, b):
    return float(torch.linalg.vector_norm(op.apply(x) - b) / torch.linalg.vector_norm(b))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_solve_direct_matches_jax_and_spsolve():
    N, omega = 96, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, DX, DX, omega, pml_thickness=16, dtype=torch.complex128)
    b = -1j * omega * src
    x = solve_direct(op, torch.as_tensor(b))
    assert x.shape == (N, N) and x.dtype == torch.complex128
    assert _residual(op, x, torch.as_tensor(b)) < 1e-10
    want = spla.spsolve(scipy_make_A(eps, mu, DX, DX, N, N, omega, pml_thickness=16).tocsc(),
                        b.ravel()).reshape(N, N)
    assert _rel(x.numpy(), want) < 1e-8
    jop = jax_make_operator(eps, mu, DX, DX, omega, pml_thickness=16, dtype=jnp.complex128)
    assert _rel(x.numpy(), jax_solve_direct(jop, jnp.asarray(b))) < 1e-8


def test_factored_reuse():
    N = 64
    op, _ = _op(N, 17e9, 12)
    f = factor(op)
    assert [s.Ws.shape for s in f.subs] == [(32, 32, 32)] * 4
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        b = torch.as_tensor(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
        assert _residual(op, solve_factored(f, b), b) < 1e-10


@pytest.mark.parametrize("mode", ["stacked", "checkpointed", "stacked-checkpointed"])
def test_stacked_and_checkpointed_match_per_sublattice(mode):
    """Stacked (four sublattices batched) and segment-checkpointed factors
    reproduce the per-sublattice stored-factor solve; checkpoints hold
    nr/stride inverses, not nr."""
    N, omega = 64, 17e9
    op, src = _op(N, omega, 12)
    b = torch.as_tensor(-1j * omega * src)
    want = solve_factored(factor(op), b)
    if mode == "stacked":
        f = factor_stacked(op)
        assert f.stacked.Ws.shape == (4, 32, 32, 32)
        got = solve_stacked(f, b)
    elif mode == "checkpointed":
        subs = factor_checkpointed(op, stride=8)
        assert [s.Wc.shape for s in subs] == [(4, 32, 32)] * 4
        got = solve_checkpointed(subs, b)
    else:
        f = factor_stacked(op, checkpointed=True, stride=8)
        assert f.stacked.Wc.shape == (4, 4, 32, 32)
        got = solve_stacked(f, b)
    assert _rel(got.numpy(), want.numpy()) < 1e-12
    assert _residual(op, got, b) < 1e-10


def test_checkpoint_stride_must_divide_rows():
    op, _ = _op(48, 17e9, 8)
    with pytest.raises(ValueError, match="divide the stride"):
        factor_checkpointed(op, stride=5)
    with pytest.raises(ValueError, match="even N"):
        factor_stacked(make_operator(*_hard_scene(47)[:2], DX, DX, 17e9, pml_thickness=8))


def test_direct_solver_c64_refined_hard_scene():
    """c64 factors + c128 refinement reach 1e-8 TRUE residual on the hard
    binary scene (as tests/test_direct.py); the returned c128 iterate's
    residual, recomputed here, agrees."""
    N, omega = 160, 24e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=20)
    x, trace = solver.solve(src, refine_target=1e-8)
    assert x.dtype == torch.complex64 and x.shape == (N, N)
    assert trace[-2] < 1e-8, trace
    assert trace[-1] < 5e-5  # downcast floor of the returned c64 array
    x64, trace64 = solver.solve(src, refine_target=1e-8, return_split=True)
    assert x64.dtype == torch.complex128 and trace64 == trace[:-1]
    b = torch.as_tensor(-1j * omega * src)
    assert _residual(solver.op64, x64, b) < 1e-7


def test_direct_solver_odd_grid_matches_jax_field():
    """Odd N factors one sublattice at a time; the refined field matches the
    JAX DirectSolver's at the c64 downcast's precision."""
    from fdtd2d_tpu.fdfd.direct import DirectSolver as JaxDirectSolver

    N, omega = 63, 24e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12)
    assert len(solver.factors.subs) == 4
    x, trace = solver.solve(src, refine_target=1e-8)
    xj, trace_j = JaxDirectSolver(eps, mu, DX, DX, omega, pml_thickness=12).solve(
        src, refine_target=1e-8)
    assert trace[-2] < 1e-8 and trace_j[-2] < 1e-8
    assert _rel(x.numpy(), xj) < 1e-5


def test_solve_batched_matches_single_rhs():
    N, omega = 64, 24e9
    eps, mu, src0 = _hard_scene(N)
    rng = np.random.default_rng(7)
    srcs = np.zeros((3, N, N), np.complex128)
    srcs[0] = src0
    for i in (1, 2):
        r, c = rng.integers(16, N - 16, 2)
        srcs[i, r, c] = 1.0
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12)
    xb, per_sample, trace = solver.solve_batched(srcs, refine_target=1e-8)
    assert xb.shape == (3, N, N) and per_sample.shape == (3,)
    assert np.all(per_sample < 1e-8), per_sample
    assert trace[-1] < 1e-8
    for i in range(3):
        xi, _ = solver.solve(srcs[i], refine_target=1e-8)
        assert float(torch.linalg.vector_norm(xb[i] - xi) / torch.linalg.vector_norm(xi)) < 1e-5
    with pytest.raises(ValueError, match="B, Nx, Ny"):
        solver.solve_batched(srcs[0])


def test_growth_diagnostic_and_stall_warning():
    """An unreachable refine_target surfaces as a RuntimeWarning citing the
    element-growth diagnostic; the solve still refines to the floor."""
    N, omega = 96, 24e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=16)
    assert np.isfinite(solver.factor_growth) and 0 < solver.factor_growth < 1e6
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        _, trace = solver.solve(src, refine_target=1e-30)
        _, _, trace_b = solver.solve_batched(src[None], refine_target=1e-30)
    msgs = [str(w.message) for w in rec if issubclass(w.category, RuntimeWarning)]
    assert any(m.startswith("direct solve stalled") and "growth" in m for m in msgs), msgs
    assert any(m.startswith("batched direct solve stalled") and "growth" in m
               for m in msgs), msgs
    assert trace[-2] < 1e-8 and trace_b[-1] < 1e-8


def test_refine_stagnation_stop_matches_jax():
    """An inner solve that resolves nothing stops refinement at the
    stagnation rule (rel >= 0.9 prev), as in the JAX package."""
    N, omega = 32, 17e9
    eps, mu, src = _hard_scene(N)
    b = -1j * omega * src
    op64 = make_operator(eps, mu, DX, DX, omega, pml_thickness=8, dtype=torch.complex128)
    out = refine(op64, torch.as_tensor(b), lambda r: 0.5 * torch.zeros_like(r), target=1e-9)
    jout = jax_refine(make_operator_f64(eps, mu, DX, DX, omega, 8), split_from_numpy(b),
                      lambda r: 0.5 * jnp.zeros_like(r), target=1e-9)
    assert out.rounds == jout.rounds == 1
    assert out.trace == jout.trace == [1.0, 1.0]
    assert out.relative_residual == 1.0


def test_refine_zero_rhs_returns_at_once():
    op64 = make_operator(*_hard_scene(16)[:2], DX, DX, 17e9, pml_thickness=4,
                         dtype=torch.complex128)
    out = refine(op64, torch.zeros((16, 16), dtype=torch.complex128),
                 lambda r: pytest.fail("inner solve called for b = 0"))
    assert out.rounds == 0 and out.trace == [0.0] and not out.x.any()


def test_huge_rhs_norms_stay_finite():
    """A right-hand side scaled by 1e20 (the bench scene's -1j*omega source
    scaled again by the default) or 1e200 keeps finite norms, and the
    refinement does not depend on the scale: the first correction contracts
    the residual alike, and both reach the target."""
    N, omega = 48, 17e9
    eps, mu, src = _hard_scene(N)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((N, N)) + 0j)
    for scale in (1e20, 1e200):
        n = float(scaled_norm(x * scale))
        assert np.isfinite(n) and n == pytest.approx(scale * float(scaled_norm(x)), rel=1e-12)
    batch = torch.stack([x, 1e200 * x])
    assert scaled_norm(batch, batched=True)[1] == pytest.approx(
        1e200 * float(scaled_norm(x)), rel=1e-12)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=8)
    _, trace_1 = solver.solve(src, rhs_scale=1.0, refine_target=1e-9)
    _, trace_big = solver.solve(src * 1e20, rhs_scale=-1j * omega, refine_target=1e-9)
    assert np.allclose(trace_1[:2], trace_big[:2], rtol=1e-6, atol=0)
    assert trace_1[-2] <= 1e-9 and trace_big[-2] <= 1e-9


@pytest.mark.parametrize("mode", ["compressed", "hps"])
def test_unported_factor_modes_raise(mode):
    eps, mu, _ = _hard_scene(16)
    with pytest.raises(NotImplementedError, match="item 12"):
        DirectSolver(eps, mu, DX, DX, 17e9, pml_thickness=4, **{mode: True})
