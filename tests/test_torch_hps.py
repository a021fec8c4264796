"""The port's HPS nested-dissection solver (fdfd/hps.py) against the JAX
package's, scipy's spsolve and the block-Thomas leg, as tests/test_hps.py
holds the JAX package's."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from fdtd2d_tpu.fdfd import hps as jhps
from fdtd2d_tpu.ops.helmholtz import make_operator as jax_make_operator
from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd import hps
from fdtd2d_tpu_torch.fdfd.direct import DirectSolver, five_point_coefficients, solve_direct
from fdtd2d_tpu_torch.ops import fdfd_hps
from fdtd2d_tpu_torch.ops.helmholtz import make_operator
from fdtd2d_tpu_torch.utils import trace

DX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hard_scene(N, seed=3):
    return hard_binary_scene(N, seed=seed, sigma=4.0, source_amp=10.0)


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _sub_coeffs(N=64, omega=2e10, pml=8, seed=0, parity=(0, 0)):
    """(d, Ecol, Erow) complex128 coefficients of one sublattice, as
    tests/test_hps.py draws them."""
    rng = np.random.default_rng(seed)
    eps = np.where(rng.standard_normal((N, N)) > 0, 5e-11, 1e-11)
    mu = np.full((N, N), 1.26e-6)
    op = make_operator(eps, mu, DX, DX, omega, pml_thickness=pml, dtype=torch.complex128,
                       device="cpu")
    d, e, _, s, _ = five_point_coefficients(op)
    px, py = parity
    return tuple(a[px::2, py::2].contiguous() for a in (d, e, s))


def _scipy_sub_matrix(d, Ecol, Erow):
    """The symmetrized sublattice 5-point matrix (one coefficient per edge)."""
    nr, nc = d.shape
    idx = np.arange(nr * nc).reshape(nr, nc)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.extend(r.ravel()); cols.extend(c.ravel()); vals.extend(v.ravel())

    add(idx, idx, d)
    add(idx[:, :-1], idx[:, 1:], Ecol[:, :-1])
    add(idx[:, 1:], idx[:, :-1], Ecol[:, :-1])
    add(idx[:-1, :], idx[1:, :], Erow[:-1, :])
    add(idx[1:, :], idx[:-1, :], Erow[:-1, :])
    return sp.csr_matrix((vals, (rows, cols)), shape=(nr * nc, nr * nc))


@pytest.mark.parametrize("nr, nc, m", [(32, 32, 8), (64, 32, 8), (48, 48, 12), (16, 64, 4),
                                       (256, 256, 8)])
def test_build_plan_equals_jax(nr, nc, m):
    """Every array of the plan equals the JAX package's, and leaf interiors,
    the J sets of every level and the root skeleton tile the grid once."""
    got, want = hps.build_plan(nr, nc, m), jhps.build_plan(nr, nc, m)
    assert (got.nr, got.nc, len(got.merges)) == (want.nr, want.nc, len(want.merges))
    assert np.array_equal(got.root_coords, want.root_coords)
    for a, b in [(got.leaf, want.leaf), *zip(got.merges, want.merges)]:
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            assert np.array_equal(x, y) and np.asarray(x).dtype == np.asarray(y).dtype, field.name
    seen = np.zeros((nr, nc), np.int32)
    lf = got.leaf
    for (r0, c0) in lf.origins:
        seen[r0 + lf.idx_I // m, c0 + lf.idx_I % m] += 1
    for mp in got.merges:
        for (r0, c0) in mp.origins:
            seen[r0 + mp.J_coords[:, 0], c0 + mp.J_coords[:, 1]] += 1
    seen[got.root_coords[:, 0], got.root_coords[:, 1]] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("nr, nc, m, match", [(60, 60, 8, "not divisible"),
                                              (24, 24, 8, "powers of two")])
def test_build_plan_rejects_bad_geometry(nr, nc, m, match):
    for build in (hps.build_plan, jhps.build_plan):
        with pytest.raises(ValueError, match=match):
            build(nr, nc, m)


@pytest.mark.parametrize("N, m, parity", [(32, 8, (0, 0)), (64, 8, (1, 0)), (64, 16, (0, 1))])
def test_sublattice_matches_spsolve(N, m, parity):
    """complex128 agreement with scipy's sparse LU, a rectangular-merge
    geometry and a larger leaf included."""
    d, Ecol, Erow = _sub_coeffs(N, parity=parity)
    nr, nc = d.shape
    plan = hps.build_plan(nr, nc, m)
    f = hps.hps_factor_sub(d, Ecol, Erow, plan)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((nr, nc)) + 1j * rng.standard_normal((nr, nc))
    x = hps.hps_solve_sub(f, plan, torch.tensor(b)).numpy().ravel()
    want = spla.spsolve(_scipy_sub_matrix(*(a.numpy() for a in (d, Ecol, Erow))).tocsc(),
                        b.ravel())
    assert _rel(x, want) < 1e-10


def test_hps_solve_matches_jax_c128():
    N, omega = 64, 17e9
    eps, mu, src = _hard_scene(N)
    b = -1j * omega * src
    op = make_operator(eps, mu, DX, DX, omega, pml_thickness=12, dtype=torch.complex128,
                       device="cpu")
    x = hps.hps_solve(hps.hps_factor(op, m=8), torch.tensor(b))
    jop = jax_make_operator(eps, mu, DX, DX, omega, pml_thickness=12, dtype=jnp.complex128)
    want = jhps.hps_solve(jhps.hps_factor(jop, m=8), jnp.asarray(b))
    assert _rel(x.numpy(), want) <= 1e-10


def test_full_operator_c64_matches_direct():
    """Full outrigger solve in complex64: residual and distance to the
    block-Thomas leg at the complex64 floor (< 5e-5)."""
    N, omega = 64, 17e9
    eps, mu, src = _hard_scene(N)
    op = make_operator(eps, mu, DX, DX, omega, pml_thickness=12, dtype=torch.complex64,
                       device="cpu")
    b = torch.tensor(-1j * omega * src, dtype=torch.complex64)
    f = hps.hps_factor(op, m=8)
    assert f.stacked.Yroot.shape[0] == 4
    x = hps.hps_solve(f, b)
    assert float(torch.linalg.vector_norm(op.apply(x) - b) / torch.linalg.vector_norm(b)) < 5e-5
    assert _rel(x.numpy(), solve_direct(op, b).numpy()) < 5e-5


def test_eliminations_run_in_complex128_and_store_complex64():
    """A complex64 sublattice factors in complex128 and stores complex64:
    the leaf level (whose input is the coefficients alone) equals the
    complex128 factor of the same coefficients rounded to complex64, and
    the levels above, fed rounded Schur complements, stay within 1e-5 of
    it; a solve with those factors is at the complex64 floor."""
    d, Ecol, Erow = (a.to(torch.complex64) for a in _sub_coeffs(64))
    plan = hps.build_plan(*d.shape, 8)
    narrow = hps.hps_factor_sub(d, Ecol, Erow, plan)
    wide = hps.hps_factor_sub(*(a.to(torch.complex128) for a in (d, Ecol, Erow)), plan)
    for got, want in ((narrow.leaf.Y, wide.leaf.Y), (narrow.leaf.E, wide.leaf.E)):
        assert got.dtype == torch.complex64 and torch.equal(got, want.to(torch.complex64))
    for got, want in [(lev.Y, w.Y) for lev, w in zip(narrow.levels, wide.levels)] + [
            (narrow.Yroot, wide.Yroot)]:
        assert got.dtype == torch.complex64
        assert _rel(got.to(torch.complex128).numpy(), want.numpy()) < 1e-5
    rng = np.random.default_rng(1)
    b = rng.standard_normal(d.shape) + 1j * rng.standard_normal(d.shape)
    x = hps.hps_solve_sub(narrow, plan, torch.tensor(b, dtype=torch.complex64))
    assert x.dtype == torch.complex64
    want = hps.hps_solve_sub(wide, plan, torch.tensor(b))
    assert _rel(x.numpy(), want.numpy()) < 1e-5


def test_factor_bytes_are_predicted_and_lean():
    """Measured bytes equal the plan's prediction (and JAX's), and the ratio
    to the stored-W store 4*(N/2)^3*8 B grows past the N ~ 256 crossover."""
    N = 256
    eps, mu, _ = _hard_scene(N)
    op = make_operator(eps, mu, DX, DX, 17e9, pml_thickness=24, dtype=torch.complex64,
                       device="cpu")
    assert hps.factor_bytes(hps.hps_factor(op, m=8)) == hps.predicted_factor_bytes(N, m=8)
    for n in (64, 256, 512, 1024, 2048):
        assert hps.predicted_factor_bytes(n) == jhps.predicted_factor_bytes(n)
    # the cells of chip_smoke.py phase 29 and the 2048^2 figure of PERF.md
    assert [hps.predicted_factor_bytes(n) for n in (512, 1024, 2048)] == [
        297_205_248, 1_355_677_184, 6_091_963_904]
    wall = lambda n: 4 * (n // 2) ** 3 * 8  # noqa: E731
    assert hps.predicted_factor_bytes(1024) < wall(1024) / 3
    assert hps.predicted_factor_bytes(2048) < wall(2048) / 5
    assert hps.predicted_factor_bytes(4096) < wall(4096) / 10
    assert hps.predicted_factor_bytes(2048) / hps.predicted_factor_bytes(1024) < 5.0


def test_solver_refined_hard_scene():
    """DirectSolver(hps=True): the complex128 iterate reaches 1e-8 within the
    mode's default rounds, and matches the stored-W solver's to 1e-6."""
    N, omega = 64, 17e9
    eps, mu, src = _hard_scene(N)
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12, hps=True, device="cpu")
    assert solver._default_refine_rounds == 40
    assert solver.hps_bytes == hps.predicted_factor_bytes(N)
    assert 0 < solver.factor_growth < np.inf
    x64, trace = solver.solve(src, refine_target=1e-8, return_split=True)
    assert trace[-1] < 1e-8
    ref = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=12, device="cpu")
    xr, _ = ref.solve(src, refine_target=1e-8, return_split=True)
    assert _rel(x64.numpy(), xr.numpy()) < 1e-6


def test_batched_rhs():
    """K right-hand sides ride the trailing axis of every product: one
    factorization, each solve at the complex64 floor (< 5e-5)."""
    N = 32
    eps, mu, _ = _hard_scene(N)
    op = make_operator(eps, mu, DX, DX, 17e9, pml_thickness=8, dtype=torch.complex64,
                       device="cpu")
    f = hps.hps_factor(op, m=8)
    rng = np.random.default_rng(2)
    bs = torch.tensor(rng.standard_normal((3, N, N)) + 1j * rng.standard_normal((3, N, N)),
                      dtype=torch.complex64)
    xs = hps.hps_solve(f, bs)
    assert xs.shape == bs.shape
    for i in range(3):
        res = torch.linalg.vector_norm(op.apply(xs[i]) - bs[i]) / torch.linalg.vector_norm(bs[i])
        assert float(res) < 5e-5
        assert torch.allclose(hps.hps_solve(f, bs[i]), xs[i], rtol=0, atol=1e-5 * float(
            xs[i].abs().max()))


def _stub_factor(monkeypatch):
    def stop(*a, **k):
        raise InterruptedError("factor reached")

    monkeypatch.setattr(hps, "hps_factor", stop)


def test_warns_past_accuracy_wall(monkeypatch):
    """Past 2048^2, the largest grid measured to refine (on an H100: the
    hard scene's 16-source batches to 1e-6), DirectSolver(hps=True) warns
    at 4096^2, before the factorization (stubbed out here) is paid for, and
    says what was measured."""
    _stub_factor(monkeypatch)
    N = 4096
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    with pytest.warns(RuntimeWarning, match="accuracy wall") as rec:
        with pytest.raises(InterruptedError):
            DirectSolver(eps, mu, DX, DX, 17e9, hps=True, hps_leaf=8, device="cpu")
    assert "measured up to 2048^2" in str(rec[0].message)


def test_no_warning_at_2048(monkeypatch):
    """2048^2 lies inside the measured wall: the factorization (stubbed out)
    is reached with no warning."""
    _stub_factor(monkeypatch)
    N = 2048
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(InterruptedError):
            DirectSolver(eps, mu, DX, DX, 17e9, hps=True, hps_leaf=8, device="cpu")


@pytest.mark.parametrize("N", [64, 128])
def test_counters_count_each_inner_solve_and_level(N):
    """A solve_batched call counts one fdfd.hps.solves an inner solve (as
    many as fdfd.backsolve spans), 2 x the plan's merge levels an inner
    solve in fdfd.hps.levels, and opens each sweep span once and the split
    twice an inner solve; the factor counts once."""
    eps, mu, _ = _hard_scene(N)
    before = trace.counters()
    solver = DirectSolver(eps, mu, DX, DX, 17e9, pml_thickness=12, hps=True, device="cpu")
    assert trace.delta(before, "fdfd.hps.factor") == 1
    srcs = np.zeros((2, N, N))
    srcs[0, N // 3, N // 2] = srcs[1, N // 2, N // 4] = 1.0
    before = trace.counters()
    _, _, residuals = solver.solve_batched(srcs, refine_target=1e-8)
    solves = len(residuals) - 1
    levels = len(hps.build_plan(N // 2, N // 2, 8).merges)
    assert solves >= 1 and trace.delta(before, "fdfd.backsolve") == solves
    assert trace.delta(before, "fdfd.hps.solves") == solves
    assert trace.delta(before, "fdfd.hps.levels") == 2 * levels * solves
    assert [trace.delta(before, f"fdfd.hps.{k}") for k in ("split", "up", "root", "down")] == [
        2 * solves, solves, solves, solves]
    assert trace.delta(before, "fdfd.hps.factor") == 0
    assert trace.delta(before, "fdfd.kernels.hps_sweeps") == 0   # the CPU runs the torch path


def test_solve_batched_agrees_with_the_per_sublattice_reference():
    """solve_batched(hps=True, return_split=True) at 128^2 with leaf 8, on
    the benchmark's scene and operator: every complex128 iterate within
    1e-6 of the exact field that the benchmark's per-sublattice reference
    (portbench/reference/fdfd_sublattice.py) solves, and its true residual
    with the reference's own operator at most 1e-6."""
    from portbench.reference import fdfd as ref
    from portbench.reference.fdfd_sublattice import OneAtATime

    N, omega, pml = 128, 17e9, 40
    eps, mu, _ = hard_binary_scene(N, seed=7, contrast=3.0)
    positions = [(40, 71), (64, 64), (90, 37)]
    srcs = np.zeros((len(positions), N, N))
    for k, (i, j) in enumerate(positions):
        srcs[k, i, j] = 1.0
    solver = DirectSolver(eps, mu, DX, DX, omega, pml_thickness=pml, hps=True, hps_leaf=8,
                          device="cpu")
    x, _, trace_ = solver.solve_batched(srcs, refine_target=1e-6, return_split=True)
    assert x.dtype == torch.complex128 and trace_[-1] <= 1e-6
    A = ref.operator(eps, mu, DX, DX, omega, pml, 2.0, 3)
    exact = OneAtATime(A, (N, N), "cpu")
    b = torch.as_tensor(ref.point_sources((N, N), positions, omega).reshape(-1, N, N))
    want, want_res = exact.solve(b)
    assert float(want_res.max()) < 1e-13
    err = torch.linalg.vector_norm(x - want, dim=(1, 2)) / torch.linalg.vector_norm(want, dim=(1, 2))
    res = (torch.linalg.vector_norm(b - exact.apply(x), dim=(1, 2))
           / torch.linalg.vector_norm(b, dim=(1, 2)))
    assert float(err.max()) <= 1e-6 and float(res.max()) <= 1e-6


def test_odd_grid_is_a_value_error():
    """The four sublattices of an odd grid differ in shape; the JAX package's
    plans then reject the grid, and the port says why."""
    N = 33
    eps, mu, _ = _hard_scene(N)
    op = make_operator(eps, mu, DX, DX, 17e9, pml_thickness=4, device="cpu")
    with pytest.raises(ValueError, match="even N"):
        hps.hps_factor(op, m=8)
    with pytest.raises(ValueError):
        jhps.hps_factor(jax_make_operator(eps, mu, DX, DX, 17e9, pml_thickness=4), m=8)


# -- the level kernels' tables, plain version and planner (ops/fdfd_hps.py) ---------

PLANS = [(32, 32, 8), (64, 32, 8), (48, 48, 12), (16, 64, 4), (256, 256, 8)]


def _random_factors(plan, lead, seed, dtype=torch.complex64):
    """Factors of ``plan``'s shapes with the leading axes ``lead``: normal
    entries scaled by the inverse square root of a row's terms."""
    rng = np.random.default_rng(seed)

    def c(*shape):
        a = rng.standard_normal((*lead, *shape)) + 1j * rng.standard_normal((*lead, *shape))
        return torch.tensor(a / np.sqrt(shape[-1]), dtype=dtype)

    lf = plan.leaf
    nI, rho = len(lf.idx_I), len(lf.idx_R)
    levels = tuple(hps.LevelFactors(Y=c(mp.n_parents, len(mp.idx_J), len(mp.idx_J)),
                                    E=c(mp.n_parents, len(mp.idx_J), len(mp.idx_R)))
                   for mp in plan.merges)
    top = len(plan.root_coords)
    return hps.SubHPSFactors(leaf=hps.LevelFactors(Y=c(lf.n_boxes, nI, nI),
                                                   E=c(lf.n_boxes, nI, rho)),
                             levels=levels, Yroot=c(top, top))


def _rhs(lead, K, n, seed, dtype=torch.complex64):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((*lead, K, n)) + 1j * rng.standard_normal((*lead, K, n)),
                        dtype=dtype)


@pytest.mark.parametrize("nr, nc, m", PLANS)
def test_sweep_tables_compose_the_gathers(nr, nc, m):
    """Each level's int32 table is up_src, idx_J and idx_R composed: the
    point of the children's skeletons (box x rho + position) that the torch
    path gathers into b_J and b_R, and that xcat_perm and child_src send x_J
    and x_R back to, every child point once, and its order the inverse; the
    leaf's table is box_I, then box_R, every grid point once."""
    plan = hps.build_plan(nr, nc, m)
    dp = hps._device_plan(nr, nc, m, torch.device("cpu"))
    n = nr * nc
    assert dp.leaf_table.dtype == torch.int32
    assert torch.equal(dp.leaf_table.long(), torch.cat([dp.box_I, dp.box_R], dim=1))
    assert torch.equal(dp.leaf_table.flatten().sort().values, torch.arange(n, dtype=torch.int32))
    rho = len(plan.leaf.idx_R)
    for mp, dm in zip(plan.merges, dp.merges):
        P, nJ = mp.n_parents, len(mp.idx_J)
        points = torch.arange(2 * P * rho).reshape(2 * P, rho)
        cat = points[dm.up_src].reshape(P, 2 * rho)            # the torch path's bcat
        want = torch.cat([cat[:, dm.idx_J], cat[:, dm.idx_R]], dim=1)
        assert dm.table.dtype == torch.int32 and torch.equal(dm.table.long(), want)
        # down: cat([x_J, x_R])[xcat_perm], split in halves, to child_src's rows
        down = torch.empty(2 * P * rho, dtype=torch.long)
        xcat = torch.arange(P * 2 * rho).reshape(P, 2 * rho)[:, dm.xcat_perm].reshape(2 * P, rho)
        down[points.flatten()] = xcat[dm.child_src].flatten()
        assert torch.equal(down[dm.table.long().flatten()], torch.arange(P * 2 * rho))
        # up writes each child point to its place in the J-then-R order
        assert dm.order.dtype == torch.int32
        assert torch.equal(dm.order.long()[dm.table.long().flatten()], torch.arange(P * 2 * rho))
        rho = len(mp.idx_R)


@pytest.mark.parametrize("lead", [(), (4,)], ids=["one", "four"])
@pytest.mark.parametrize("K", [1, 16])
@pytest.mark.parametrize("nr, nc, m", PLANS)
def test_sweeps_reference_matches_solve_cols(nr, nc, m, K, lead):
    """The kernel's plain version, its tables, skeleton buffers and padded
    chunks walked by torch ops, reproduces the torch path bit for bit on
    random complex64 factors."""
    plan = hps.build_plan(nr, nc, m)
    f = _random_factors(plan, lead, seed=nr + K)
    b = _rhs(lead, K, nr * nc, seed=K)
    want = hps._solve_cols(f, plan, b.movedim(-1, -2).contiguous()).movedim(-1, -2)
    got = fdfd_hps.hps_sweeps_reference(*hps._sweep_operands(f, plan, b.device), b)
    assert got.shape == b.shape and torch.equal(got, want)


@pytest.mark.parametrize("K", [5, 20])
def test_sweeps_reference_pads_and_chunks(K):
    """K = 5 pads to 8; K = 20 runs as chunks of 16 and 4: within 1e-6 of
    the torch path, the products summing in another order."""
    plan = hps.build_plan(64, 32, 8)
    f = _random_factors(plan, (4,), seed=K)
    b = _rhs((4,), K, 64 * 32, seed=K + 1)
    want = hps._solve_cols(f, plan, b.movedim(-1, -2).contiguous()).movedim(-1, -2)
    got = fdfd_hps.hps_sweeps_reference(*hps._sweep_operands(f, plan, b.device), b)
    err = torch.linalg.vector_norm(got - want, dim=-1) / torch.linalg.vector_norm(want, dim=-1)
    assert float(err.max()) <= 1e-6


@pytest.mark.parametrize("case", ["cpu", "complex128", "non-contiguous b"])
def test_level_kernel_wrapper_refuses(case):
    """The kernel takes CUDA complex64 contiguous tensors only: the wrapper
    raises before any launch, and hps_solve keeps such inputs on the torch
    path."""
    plan = hps.build_plan(32, 32, 8)
    dtype = torch.complex128 if case == "complex128" else torch.complex64
    f = _random_factors(plan, (4,), seed=1, dtype=dtype)
    b = _rhs((4,), 3, 32 * 32, seed=2, dtype=dtype)
    if case == "non-contiguous b":
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    match = {"cpu": "on cpu", "complex128": "complex64 only", "non-contiguous b": "contiguous"}
    before = trace.counters()
    with pytest.raises(ValueError, match=match[case]):
        fdfd_hps.hps_sweeps(*hps._sweep_operands(f, plan, b.device), b)
    assert not hps._on_card(f, b)
    assert trace.delta(before, "fdfd.kernels.hps_sweeps") == 0


def test_level_kernel_wrapper_refuses_mismatched_shapes():
    plan = hps.build_plan(32, 32, 8)
    f = _random_factors(plan, (4,), seed=3)
    leaf, levels, Yroot = hps._sweep_operands(f, plan, torch.device("cpu"))
    with pytest.raises(ValueError, match="b has shape"):
        fdfd_hps.hps_sweeps_reference(leaf, levels, Yroot, _rhs((4,), 2, 32 * 31, seed=4))
    with pytest.raises(ValueError, match="do not merge"):
        fdfd_hps.hps_sweeps_reference(leaf, levels[1:], Yroot, _rhs((4,), 2, 32 * 32, seed=4))
    with pytest.raises(ValueError, match="int32"):
        fdfd_hps.hps_sweeps_reference((leaf[0], leaf[1], leaf[2].long()), levels, Yroot,
                                      _rhs((4,), 2, 32 * 32, seed=4))


@pytest.mark.parametrize("K, down, level, want", [
    # the leaf up: 64 rows an item (Y's 36, E's 28 columns), its 36 terms in one stage
    (16, False, "leaf", dict(tc=36, ni=2, blocks=65536, smem=57_600)),
    (16, True, "leaf", dict(tc=28, ni=3, blocks=36864, smem=53_888)),
    # the lowest merge down: 12 rows an item, seven items a block, 44 terms in two chunks
    (16, True, 0, dict(tc=22, ni=7, blocks=6144, smem=67_904)),
    # the top merge up: 384 blocks, more than the SMs: a ring for two CTAs an SM
    (16, False, 13, dict(tc=72, ni=2, blocks=384, smem=115_200)),
    # the top merge down: 128 blocks, one wave: a ring for one CTA an SM
    (16, True, 13, dict(tc=128, ni=2, blocks=128, smem=205_824)),
    (1, False, "leaf", dict(tc=18, ni=5, blocks=16384, smem=75_168)),
    (1, True, 13, dict(tc=54, ni=2, blocks=32, smem=227_008)),
])
def test_plan_level_from_shapes(K, down, level, want):
    """The tiling of the 2048^2 cell's launches (four sublattices of
    1024^2, leaf 8) from the shapes alone, on an H100's SMs and shared
    memory: rows a block by the padded chunk, the most items a block meets,
    and the even term chunk that splits the terms most evenly among the
    fewest chunks whose two-stage ring fits two CTAs an SM, or one where the
    blocks do not fill the SMs once."""
    plan = hps.build_plan(1024, 1024, 8)
    lf = plan.leaf
    P, nJ, nR = ((lf.n_boxes, len(lf.idx_I), len(lf.idx_R)) if level == "leaf" else
                 (plan.merges[level].n_parents, len(plan.merges[level].idx_J),
                  len(plan.merges[level].idx_R)))
    lp = fdfd_hps.plan_level(4 * P, nJ, nR, fdfd_hps.kpad(K), down, *fdfd_hps.H100)
    got = dict(tc=lp.tc, ni=lp.ni, blocks=lp.blocks, smem=lp.smem)
    assert got == want
    assert lp.tc % 2 == 0 and lp.smem <= fdfd_hps.H100[1]
    rows = fdfd_hps.rows_a_block(lp.kp)
    # every block of rows meets at most ni items
    assert all((q0 + rows - 1) // lp.rows - q0 // lp.rows + 1 <= lp.ni
               for q0 in range(0, min(lp.items * lp.rows, 64 * rows), rows))


def test_plan_level_refuses():
    with pytest.raises(ValueError, match="kp 3"):
        fdfd_hps.plan_level(4, 12, 44, 3, False)
    with pytest.raises(ValueError, match="does not fit"):
        fdfd_hps.plan_level(4, 12, 44, 16, False, 132, 1024)
