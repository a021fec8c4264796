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
    DirectSolver, factor, factor_checkpointed, factor_stacked, merge_sublattices,
    solve_checkpointed, solve_direct, solve_factored, solve_stacked, split_sublattices,
)
from fdtd2d_tpu_torch.fdfd.refine import refine, scaled_norm, true_relative_residual
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
    return make_operator(eps, mu, DX, DX, omega, pml_thickness=pml, dtype=dtype,
                         device="cpu"), src


def _residual(op, x, b):
    return float(torch.linalg.vector_norm(op.apply(x) - b) / torch.linalg.vector_norm(b))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def test_solve_direct_matches_jax_and_spsolve():
    N, omega = 96, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, DX, DX, omega, pml_thickness=16, dtype=torch.complex128,
                       device="cpu")
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
        factor_stacked(make_operator(*_hard_scene(47)[:2], DX, DX, 17e9, pml_thickness=8,
                                     device="cpu"))


def test_direct_solver_c64_refined_hard_scene():
    """c64 factors + c128 refinement reach 1e-8 TRUE residual on the hard
    binary scene (as tests/test_direct.py); the returned c128 iterate's
    residual, recomputed here, agrees."""
    N, omega = 160, 24e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=20, device="cpu")
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
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12, device="cpu")
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
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12, device="cpu")
    xb, per_sample, trace = solver.solve_batched(srcs, refine_target=1e-8)
    assert xb.shape == (3, N, N) and per_sample.shape == (3,)
    assert np.all(per_sample < 1e-8), per_sample
    assert trace[-1] < 1e-8
    for i in range(3):
        xi, _ = solver.solve(srcs[i], refine_target=1e-8)
        assert float(torch.linalg.vector_norm(xb[i] - xi) / torch.linalg.vector_norm(xi)) < 1e-5
    with pytest.raises(ValueError, match="B, Nx, Ny"):
        solver.solve_batched(srcs[0])


def test_solve_batched_return_split_gives_the_refined_iterate():
    """With return_split=True solve_batched returns the complex128 iterate,
    whose true residual meets the target for every source and is the one it
    reports; the default return is that iterate's complex64 downcast."""
    N, omega, target = 64, 24e9, 1e-8
    eps, mu, _ = _hard_scene(N)
    srcs = np.zeros((3, N, N))
    for i, (r, c) in enumerate(((20, 33), (40, 17), (32, 32))):
        srcs[i, r, c] = 1.0
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12, device="cpu")
    x64, per_sample, trace = solver.solve_batched(srcs, refine_target=target,
                                                  return_split=True)
    xc, per_sample_c, trace_c = solver.solve_batched(srcs, refine_target=target)
    assert x64.dtype == torch.complex128 and xc.dtype == torch.complex64
    assert torch.equal(x64.to(torch.complex64), xc) and trace == trace_c
    np.testing.assert_array_equal(per_sample, per_sample_c)
    b = torch.as_tensor(srcs).to(torch.complex128) * (-1j * omega)
    for i in range(3):
        true = true_relative_residual(solver.op64, b[i], x64[i])
        assert true <= target and true == pytest.approx(per_sample[i], rel=1e-6)


def test_growth_diagnostic_and_stall_warning():
    """An unreachable refine_target surfaces as a RuntimeWarning citing the
    element-growth diagnostic; the solve still refines to the floor."""
    N, omega = 96, 24e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=16, device="cpu")
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
    op64 = make_operator(eps, mu, DX, DX, omega, pml_thickness=8, dtype=torch.complex128,
                         device="cpu")
    out = refine(op64, torch.as_tensor(b), lambda r: 0.5 * torch.zeros_like(r), target=1e-9)
    jout = jax_refine(make_operator_f64(eps, mu, DX, DX, omega, 8), split_from_numpy(b),
                      lambda r: 0.5 * jnp.zeros_like(r), target=1e-9)
    assert out.rounds == jout.rounds == 1
    assert out.trace == jout.trace == [1.0, 1.0]
    assert out.relative_residual == 1.0


@pytest.mark.parametrize("kind", ["torch", "numpy"])
@pytest.mark.parametrize("shape", [(6, 8), (7, 5), (3, 6, 8), (2, 3, 7, 5)])
def test_split_then_merge_is_the_identity(shape, kind):
    """The four sublattices, split and merged back into an empty grid, give
    the input bit for bit: even and odd grids (unequal sublattices), with a
    leading K and (B, K) axes, tensors and numpy arrays alike."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    a = torch.tensor(a) if kind == "torch" else a
    parts = split_sublattices(a)
    assert len(parts) == 4
    for part, (px, py) in zip(parts, [(0, 0), (0, 1), (1, 0), (1, 1)]):
        assert part.shape[-2:] == ((shape[-2] - px + 1) // 2, (shape[-1] - py + 1) // 2)
        assert np.array_equal(np.asarray(part[..., 0, 0]), np.asarray(a[..., px, py]))
    out = merge_sublattices(parts, torch.full_like(a, float("nan")) if kind == "torch"
                            else np.full_like(a, np.nan))
    assert np.array_equal(np.asarray(out), np.asarray(a))


def test_refine_zero_rhs_returns_at_once():
    op64 = make_operator(*_hard_scene(16)[:2], DX, DX, 17e9, pml_thickness=4, device="cpu",
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
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=8, device="cpu")
    _, trace_1 = solver.solve(src, rhs_scale=1.0, refine_target=1e-9)
    _, trace_big = solver.solve(src * 1e20, rhs_scale=-1j * omega, refine_target=1e-9)
    assert np.allclose(trace_1[:2], trace_big[:2], rtol=1e-6, atol=0)
    assert trace_1[-2] <= 1e-9 and trace_big[-2] <= 1e-9


@pytest.mark.parametrize("kw", [
    dict(compressed=True, rank=20, leaf=128, power_iters=1, stacked_solve=False),
    dict(compressed=True, rank=8, leaf=8, power_iters=2, stacked_solve=False),
    dict(compressed=True, rank=8, leaf=8, power_iters=0),
    dict(hps=True, hps_leaf=8),
    dict(rank=20, leaf=128, power_iters=1, stacked_solve=True, hps_leaf=8),
], ids=["direct2048-keywords", "compressed-loop", "compressed-stacked", "hps", "stored"])
def test_factor_modes_take_the_jax_keywords_and_refine(kw):
    """bench.py's direct2048 call (compressed with rank, leaf, power_iters
    and stacked_solve=False), the compressed mode stacked and as a loop at a
    depth that compresses, hps with hps_leaf, and the stored mode (where the
    five keywords are inert) each build and refine to a true 1e-9 on the
    hard scene at 64^2."""
    N, omega = 64, 17e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12, device="cpu", **kw)
    assert solver._default_refine_rounds == (40 if kw.get("hps") else 8)
    assert hasattr(solver, "compressed_bytes") == bool(kw.get("compressed"))
    assert hasattr(solver, "hps_bytes") == bool(kw.get("hps"))
    x, trace = solver.solve(src, refine_target=1e-9)
    assert x.shape == (N, N) and bool(torch.isfinite(x).all())
    assert trace[-2] <= 1e-9, trace


@pytest.mark.parametrize("modes", [("checkpointed", "compressed"), ("compressed", "hps"),
                                   ("checkpointed", "hps"),
                                   ("checkpointed", "compressed", "hps")],
                         ids="+".join)
def test_more_than_one_factor_mode_is_a_value_error(modes):
    """As the JAX constructor: more than one of checkpointed/compressed/hps
    is a ValueError, raised before anything is factored."""
    from fdtd2d_tpu.fdfd.direct import DirectSolver as JaxDirectSolver

    eps, mu, _ = _hard_scene(16)
    flags = {m: True for m in modes}
    with pytest.raises(ValueError, match="choose one of"):
        DirectSolver(eps, mu, DX, DX, 17e9, pml_thickness=4, device="cpu", **flags)
    with pytest.raises(ValueError, match="choose one of"):
        JaxDirectSolver(eps, mu, DX, DX, 17e9, pml_thickness=4, **flags)


def _scene_batch(N, B=3, pml=8, dtype=torch.complex64):
    """A scene-batched operator (models/datagen.py's form: eps, mu (B, N, N),
    omega (B,), stretch vectors (B, N)) of binary scenes."""
    from fdtd2d_tpu_torch.models.datagen import make_operator_traced

    rng = np.random.default_rng(N)
    eps = np.where(rng.random((B, N, N)) > 0.5, 5.0, 1.0) * 8.854e-12
    mu = np.full((B, N, N), 1.2566e-6)
    omega = rng.uniform(18e9, 30e9, B)
    src = np.zeros((B, N, N))
    src[:, N // 2, N // 3] = 1.0
    op = make_operator_traced(torch.tensor(eps), torch.tensor(mu), DX, DX, torch.tensor(omega),
                              pml, dtype=dtype)
    b = (-1j * op.omega.to(dtype))[:, None, None] * torch.tensor(src).to(dtype)
    return op, b


def _scene(op, i):
    """Scene i of a scene-batched operator as an unbatched operator."""
    import dataclasses

    return dataclasses.replace(op, eps=op.eps[i], inv_mu=op.inv_mu[i], omega=op.omega[i],
                               inv_s_row=op.inv_s_row[i], inv_s_col=op.inv_s_col[i])


@pytest.mark.parametrize("N, stacked", [(48, True), (50, True), (47, False)])
def test_scene_batched_factor_equals_per_scene_calls(N, stacked):
    """One factor set a scene from one batched factor (the datagen path:
    stacked for even N, per sublattice for odd), and its solve of one
    right-hand side a scene, against the unbatched factor and solve of each
    scene: bit for bit at 48^2. Elsewhere torch's CPU kernels put a row's
    last elements in a scalar tail loop in one layout and in the vector
    body in the other, and the two round complex products differently, so
    the coefficients already differ in the last bit: there the factors and
    solves agree to 1e-5. Every solve's residual is at the complex64 floor."""
    op, b = _scene_batch(N)
    fac = factor_stacked if stacked else factor
    f = fac(op)
    assert f.batch == (3,)
    if stacked:
        assert f.stacked.Ws.shape == (4, 3, N // 2, N // 2, N // 2)
    x = solve_factored(f, b)
    assert x.shape == b.shape
    for i in range(3):
        fi = fac(_scene(op, i))
        assert fi.batch == ()
        got = [f.stacked.Ws[:, i]] if stacked else [s.Ws[i] for s in f.subs]
        want = [fi.stacked.Ws] if stacked else [s.Ws for s in fi.subs]
        xi = solve_factored(fi, b[i])
        if N == 48:
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert torch.equal(x[i], xi)
        else:
            assert all(_rel(g.numpy(), w.numpy()) < 1e-5 for g, w in zip(got, want))
            assert _rel(x[i].numpy(), xi.numpy()) < 1e-5
        assert _residual(_scene(op, i), x[i], b[i]) < 1e-4


def test_unbatched_factor_keeps_its_layout():
    """An unbatched operator's factors carry no batch axis, and a factor of a
    one-scene batch equals it bit for bit (the scene axis adds no
    arithmetic)."""
    op, b = _scene_batch(32, B=1)
    one = _scene(op, 0)
    f1, fb = factor_stacked(one), factor_stacked(op)
    assert f1.batch == () and f1.stacked.Ws.shape == (4, 16, 16, 16)
    assert torch.equal(fb.stacked.Ws[:, 0], f1.stacked.Ws)
    assert torch.equal(solve_stacked(fb, b)[0], solve_stacked(f1, b[0]))


# -- the row-sweep kernel's plan, and the CPU side of its dispatch ------------------

@pytest.mark.parametrize("case, groups, nr, nc, K, want", [
    ("1024^2, K = 16", 4, 512, 512, 16, dict(chunks=1, kc=16, kp=16, ctas=33, rows=16)),
    ("1024^2, K = 1", 4, 512, 512, 1, dict(chunks=1, kc=1, kp=4, ctas=33, rows=16)),
    ("1024^2, K = 40", 4, 512, 512, 40, dict(chunks=3, kc=14, kp=16, ctas=11, rows=16)),
    ("odd N, one sublattice", 1, 512, 511, 16, dict(chunks=1, kc=16, kp=16, ctas=128, rows=4)),
    ("scene batch of 4", 16, 512, 512, 16, dict(chunks=1, kc=16, kp=16, ctas=8, rows=16)),
    ("dense nc = 1024", 4, 1024, 1024, 16, dict(chunks=1, kc=16, kp=16, ctas=33, rows=4)),
])
def test_row_sweep_plan_stays_inside_the_card(case, groups, nr, nc, K, want):
    """The plan (pure Python) for the shapes the main path and its other
    callers give: every launch inside an H100's 132 SMs and 232,448 bytes of
    shared memory a block, every right-hand side in exactly one chunk of at
    most 16, every CTA owning at least one row, and a ring tile whose
    micro-tiles the kernel's 256 threads cover."""
    from fdtd2d_tpu_torch.ops import fdfd_rowsweep as rs

    sms, smem = rs.H100
    plan = rs.plan_row_sweep(groups, nr, nc, K, sms, smem)
    assert {k: getattr(plan, k) for k in want} == want, case
    assert plan.grid <= sms and plan.smem <= smem
    assert plan.smem == rs.smem_bytes(nc, plan.kp, plan.rows)
    assert plan.kc <= plan.kp <= 16 and plan.kp in rs.KPADS
    assert (plan.chunks - 1) * plan.kc < K <= plan.chunks * plan.kc
    assert 1 <= plan.ctas <= nc and nc // plan.ctas >= 1
    assert plan.rows in rs.RING_ROWS and plan.rows * plan.kp <= rs.THREADS
    assert plan.launches * plan.per_launch >= plan.units == groups * plan.chunks
    assert plan.launches == 1


def _old_solve_rows(f, b):
    """The solve's torch loop as it stood before the row-sweep kernel, on b
    (..., K, nr, nc), through _solve_sub's layout change."""
    bl = b.movedim(-3, -1).contiguous()
    nr = bl.shape[-3]
    z = f.Ws[..., 0, :, :] @ bl[..., 0, :, :]
    zs = [z]
    for r in range(1, nr):
        z = f.Ws[..., r, :, :] @ (bl[..., r, :, :] - f.nvals[..., r, :, None] * z)
        zs.append(z)
    x = zs[-1]
    xs = [x]
    for r in range(nr - 2, -1, -1):
        x = zs[r] - f.Ws[..., r, :, :] @ (f.svals[..., r, :, None] * x)
        xs.append(x)
    return torch.stack(xs[::-1], dim=-3).movedim(-1, -3)


@pytest.mark.parametrize("N, stacked, dtype", [(32, True, torch.complex64),
                                               (33, False, torch.complex64),
                                               (32, True, torch.complex128)])
def test_solve_rows_on_cpu_takes_the_loop(N, stacked, dtype):
    """On CPU tensors _solve_rows runs the torch loop: the row-sweep counter
    stays where it was, and the answer is today's bit for bit (stacked
    factors, and an odd grid's per-sublattice factors with strided
    couplings), in complex64 and complex128."""
    from fdtd2d_tpu_torch.fdfd.direct import _solve_rows
    from fdtd2d_tpu_torch.utils import trace

    op, _ = _op(N, 17e9, 6, dtype)
    f = factor_stacked(op).stacked if stacked else factor(op).subs[1]
    nr, nc = f.Ws.shape[-3], f.Ws.shape[-1]
    rng = np.random.default_rng(N)
    b = torch.tensor(rng.standard_normal(f.Ws.shape[:-3] + (3, nr, nc))
                     + 1j * rng.standard_normal(f.Ws.shape[:-3] + (3, nr, nc))).to(dtype)
    before = trace.counters()
    x = _solve_rows(f, b)
    assert trace.delta(before, "fdfd.kernels.row_sweeps") == 0
    assert x.shape == b.shape and x.dtype == dtype
    assert torch.equal(x, _old_solve_rows(f, b))


@pytest.mark.parametrize("bad, match", [("cpu", "no row-sweep kernel"),
                                        ("complex128", "complex64 only"),
                                        ("strided", "contiguous")])
def test_row_sweep_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    """The kernel's wrapper raises, before any CUDA call, on CPU tensors,
    complex128 and non-contiguous input: it never falls back to the loop."""
    from fdtd2d_tpu_torch.ops import fdfd_rowsweep as rs
    from fdtd2d_tpu_torch.utils import trace

    f = factor_stacked(_op(16, 17e9, 4, torch.complex64)[0]).stacked
    b = torch.zeros((4, 2, 8, 8), dtype=torch.complex64)
    Ws, nvals, svals = f.Ws, f.nvals, f.svals
    if bad == "complex128":
        Ws, b = Ws.to(torch.complex128), b.to(torch.complex128)
    elif bad == "strided":
        b = torch.zeros((4, 8, 8, 2), dtype=torch.complex64).movedim(-1, -3)
    before = trace.counters()
    with pytest.raises(ValueError, match=match):
        rs.row_sweep(Ws, nvals, svals, b)
    assert trace.delta(before, "fdfd.kernels.row_sweeps") == 0
