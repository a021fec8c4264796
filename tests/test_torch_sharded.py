"""The sharded FDTD path of the port (fdtd2d_tpu_torch.parallel) on the CPU:
the mesh, K2's block mode as its emulation against the plain step, the
rollout against the JAX package's sharded functions (interpret mode on the
8-device CPU platform) and the NumPy oracle, and simulate_sharded's
dispatch. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdtd.reference import numpy_simulate
from fdtd2d_tpu.fdtd.simulate import FDTDConfig as JaxConfig
from fdtd2d_tpu.fdtd.simulate import simulate as jax_simulate
from fdtd2d_tpu.parallel import make_mesh as jax_make_mesh
from fdtd2d_tpu.parallel import simulate_sharded as jax_simulate_sharded
from fdtd2d_tpu.parallel.fdtd_sharded import plan_sharded_ttiled as jax_plan
from fdtd2d_tpu.parallel.fdtd_sharded import plan_sharded_ttiled_2d as jax_plan_2d
from fdtd2d_tpu.parallel.fdtd_sharded import simulate_sharded_ttiled as jax_sharded_ttiled
from fdtd2d_tpu.parallel.fdtd_sharded import (
    simulate_sharded_ttiled_2d as jax_sharded_ttiled_2d)
from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate
from fdtd2d_tpu_torch.fdtd.step import MUR_BAND
from fdtd2d_tpu_torch.ops import fdtd_ttiled
from fdtd2d_tpu_torch.ops.fdtd_ttiled import Block, S
from fdtd2d_tpu_torch.parallel import (
    Mesh, make_mesh, mesh_blocks, plan_sharded_ttiled, plan_sharded_ttiled_2d,
    simulate_sharded, simulate_sharded_ttiled, simulate_sharded_ttiled_2d)
from fdtd2d_tpu_torch.parallel import fdtd_sharded
from fdtd2d_tpu_torch.utils import trace

DT, DX, FC = 5e-14, 1e-4, 30e9
Z0 = 376.73  # vacuum impedance: scales the random H to the random Ez


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These grids gain nothing from intra-op threads, and in a parallel
    test run the threads of every worker oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(shape, names=("x", "y")):
    return make_mesh(shape, axis_names=names, devices=["cpu"] * max(8, math.prod(shape)))


def _rel(ours, ref):
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(ours.double().numpy() - ref)) / np.max(np.abs(ref))


def _random_scene(rng, rows, cols):
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    state = [(rng.standard_normal(shape) / scale).astype(np.float32)
             for shape, scale in (((rows, cols), 1.0), ((rows, cols - 1), Z0),
                                  ((rows - 1, cols), Z0))]
    return eps, mu, state


def _config(nsteps, src, **kw):
    return FDTDConfig(dt=DT, dx=DX, nsteps=nsteps, source_xy=src, source_fc=FC,
                      device="cpu", **kw)


def boundary_cover(Ez, b=MUR_BAND):
    """Smallest max |Ez| over the four Mur bands and the four corners,
    relative to max |Ez| over the grid."""
    parts = (Ez[b:-b, :b], Ez[b:-b, -b:], Ez[:b, b:-b], Ez[-b:, b:-b],
             Ez[:b, :b], Ez[:b, -b:], Ez[-b:, :b], Ez[-b:, -b:])
    return float(min(p.abs().max() for p in parts) / Ez.abs().max())


# -- (a) the mesh --------------------------------------------------------------

def test_mesh_shapes():
    """As tests/test_sharded.py::test_mesh_shapes on its 8-device platform:
    the default mesh is near-square over all devices, a shape is honoured,
    and the axis names follow the shape. One device may be named several
    times: that is the port's form of a virtual multi-device platform."""
    m = make_mesh(devices=["cpu"] * 8)
    assert isinstance(m, Mesh) and m.devices.size == 8 and m.devices.shape == (2, 4)
    assert m.axis_names == ("x", "y")
    m2 = _cpu_mesh((4, 2))
    assert m2.devices.shape == (4, 2) and m2.devices.ndim == 2
    m1 = make_mesh((8,), axis_names=("x",), devices=["cpu"] * 8)
    assert m1.devices.shape == (8,) and m1.axis_names == ("x",)
    assert all(d == torch.device("cpu") for d in m1.devices.flat)
    assert make_mesh((3,), devices=["cpu"] * 8).devices.shape == (3,)  # the first three
    mixed = make_mesh((2,), devices=["cpu", torch.device("cuda", 1)])
    assert mixed.devices[1] == torch.device("cuda:1")
    assert jax_make_mesh((4, 2)).devices.shape == m2.devices.shape


@pytest.mark.parametrize("shape,devices", [((3, 3), ["cpu"] * 8), ((9,), ["cpu"] * 8),
                                           ((2,), ["cpu"])])
def test_mesh_needs_enough_devices(shape, devices):
    with pytest.raises(ValueError, match="needs more than"):
        make_mesh(shape, devices=devices)


def test_default_mesh_is_the_visible_cuda_devices():
    """No device is chosen silently: without CUDA devices and without
    ``devices=`` there is no mesh."""
    if torch.cuda.is_available():
        assert make_mesh().devices.size == torch.cuda.device_count()
    else:
        with pytest.raises(ValueError, match="pass devices="):
            make_mesh()


# -- (b) K2's block mode: the emulation against the plain step ------------------

# (grid, mesh, K, tile, source). 203x157 in 2x2, 1x4, 4x1 and 3x2 blocks that
# do not divide it evenly, with forced small tiles whose seams cross bands,
# corners and block boundaries. Sources: on the corner where four blocks
# meet (owned by one, in the ghost cells of three); in the ghost cells of
# block (0, 0) three columns past its owned ones; in the first block only,
# outside every other block's array. Thin blocks: 64 rows over 8 (a block
# owns G = 8 rows, so block 1's ghost rows hold the whole top band), 60
# over 6 (10 rows: block 1's array is pulled to the domain's edge, and the
# band lies in ghost cells that are themselves 10 deep) and 44x52 over 4x4.
# 19 steps leave a short last sweep at every K here.
BLOCK_CASES = {
    "2x2-K7-source-on-block-corner": ((203, 157), (2, 2), 7, (13, 16), (102, 79)),
    "1x4-K3-source-in-ghost-cells": ((203, 157), (1, 4), 3, (29, 20), (100, 41)),
    "4x1-K8-source-outside-three-blocks": ((203, 157), (4, 1), 8, (17, 40), (10, 10)),
    "3x2-K5-source-near-far-corner": ((203, 157), (3, 2), 5, (17, 20), (199, 153)),
    "8x1-thin-K8-band-in-ghost-rows": ((64, 48), (8, 1), 8, (8, 24), (30, 20)),
    "6x1-thin-K8-array-pulled-to-edge": ((60, 48), (6, 1), 8, (10, 48), (11, 3)),
    "4x4-thin-K8-ghost-corners": ((44, 52), (4, 4), 8, (11, 13), (22, 26)),
    "1x1-K4-the-whole-domain": ((42, 54), (1, 1), 4, (9, 8), (19, 25)),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_emulation_equals_plain_step(case):
    """The sharded rollout on CPU blocks (the block-mode emulation and the
    halo exchange) against the port's plain step on the whole domain,
    float32, from a random state that puts a field in every band and corner:
    equal bit for bit. The buffers are filled with NaN before set-up, so a
    sweep that read a ghost cell the exchange had not filled would show."""
    (rows, cols), mesh_shape, K, tile, src = BLOCK_CASES[case]
    nsteps = 19
    assert nsteps % K
    eps, mu, state = _random_scene(np.random.default_rng(5), rows, cols)
    cfg = _config(nsteps, src, source_kind="sinusoidal" if K == 3 else "ricker")
    want, _ = simulate(eps, mu, dataclasses.replace(cfg, backend="torch"), state=state)
    assert boundary_cover(want[0]) >= 1e-3
    mesh = _cpu_mesh(mesh_shape)
    plan = fdtd_sharded._resolve_plan(rows, cols, *mesh_shape, K, tile)
    assert plan == (K, K, *tile)
    before = trace.counters()
    got, snaps = fdtd_sharded._rollout(eps, mu, cfg, mesh, state, K, K, tile, by_sweeps=True,
                                       fill=math.nan)
    # CPU blocks launch nothing
    assert snaps is None and trace.delta(before, "fdtd.kernels.k2_block_sweeps") == 0
    sweeps = -(-nsteps // K)
    copies = len(fdtd_sharded.exchange_plan(mesh_blocks(rows, cols, *mesh_shape, K)))
    assert fdtd_sharded.exchange_copies == sweeps * copies
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
    # the public entry makes the same rollout
    again, _ = simulate_sharded_ttiled(eps, mu, cfg, mesh, state=state, K=K, tile=tile)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_block_spans_and_ghost_cells():
    """The blocks' owned and ghosted spans, as the rollout loop and the kernel
    read them. 203x157 in 3x2 blocks at G = 8: block (1, 1) has ghost rows
    on both sides and ghost columns on its left only; a side is a domain
    edge exactly where the array ends there. A cell of its top-left ghost
    corner belongs to block (0, 0)."""
    blocks = mesh_blocks(203, 157, 3, 2, 8)
    b = blocks[1][1]
    assert (b.r0, b.r1, b.c0, b.c1) == (68, 136, 79, 157)
    assert b.rows == (60, 144) and b.cols == (71, 157) and b.shape == (84, 86)
    assert b.owned == (slice(8, 76), slice(8, 86))
    corner = (b.rows[0] + 2, b.cols[0] + 3)      # domain coordinates of a ghost-corner cell
    o = blocks[0][0]
    assert o.r0 <= corner[0] < o.r1 and o.c0 <= corner[1] < o.c1
    # every cell of the domain is owned exactly once
    owned = np.zeros((203, 157), int)
    for row in blocks:
        for blk in row:
            owned[blk.owned_in_domain] += 1
    assert (owned == 1).all()
    # an array end less than S cells inside the domain lies at its edge instead
    thin = mesh_blocks(60, 48, 6, 1, 8)
    assert thin[1][0].rows == (0, 28) and thin[2][0].rows == (12, 38)
    assert thin[4][0].rows == (32, 60) and thin[5][0].rows == (42, 60)
    assert Block.whole(60, 48).shape == (60, 48) and Block.whole(60, 48).G == 0
    # tiles cut the owned cells; a window at a ghost boundary reaches K ghost cells
    spans = fdtd_ttiled.tile_spans(203, 17, 8, b.r0, b.r1)
    assert spans[0] == (68, 85, 60, 93) and spans[-1] == (119, 136, 111, 144)
    assert all(fdtd_ttiled.interior_span(s, 203) for s in spans)
    last = blocks[2][1]
    spans = fdtd_ttiled.tile_spans(203, 17, 8, last.r0, last.r1)
    assert spans[0][2] == last.r0 - 8 and spans[-1][3] == 203
    assert not fdtd_ttiled.interior_span(spans[-1], 203)


def test_exchange_fills_every_ghost_cell_columns_first():
    """One exchange's strips cover each block's array minus its owned cells
    exactly, ghost corners by the row strips; every strip is read from the
    adjacent block's array; the column strips come first."""
    blocks = mesh_blocks(203, 157, 3, 2, 8)
    plan = fdtd_sharded.exchange_plan(blocks)
    n_col = sum(1 for d, _, s, _ in plan if d[0] == s[0])
    assert all(d[0] == s[0] for d, _, s, _ in plan[:n_col])
    assert all(d[1] == s[1] for d, _, s, _ in plan[n_col:])
    assert (n_col, len(plan) - n_col) == (2 * 3, 2 * 2 * 2)
    for r, row in enumerate(blocks):
        for c, blk in enumerate(row):
            filled = np.zeros(blk.shape, int)
            filled[blk.owned] = 1
            for d, dsl, s, ssl in plan:
                if d != (r, c):
                    continue
                filled[dsl] = 1
                src = blocks[s[0]][s[1]]
                assert abs(s[0] - r) + abs(s[1] - c) == 1
                shape = tuple(sl.stop - sl.start for sl in ssl)
                assert shape == tuple(sl.stop - sl.start for sl in dsl)
                assert all(0 <= sl.start and sl.stop <= n for sl, n in zip(ssl, src.shape))
            assert filled.all()


@pytest.mark.parametrize("shape,D,K,tile,match", [
    ((64, 128), (8, 1), 8, (5, 32), "at least 6"),        # tiles own >= 6 cells
    ((64, 128), (16, 1), 4, (4, 32), "own fewer"),        # 4-row blocks
    ((40, 128), (8, 1), 8, (5, 32), "own fewer"),         # 5-row blocks, G = 8
    ((400, 360), (2, 2), 6, (70, 84), "register body"),   # 82-row interior windows
])
def test_sharded_plan_raises(shape, D, K, tile, match):
    with pytest.raises(ValueError, match=match):
        fdtd_sharded._resolve_plan(*shape, *D, K, tile)


def test_check_plan_holds_windows_inside_the_block():
    """A block whose ghost depth is below the sweep depth cannot run: its
    windows would reach past its array."""
    blk = mesh_blocks(203, 157, 2, 2, 4)[0][0]
    fdtd_ttiled.check_plan(203, 157, 4, 17, 20, blk)
    with pytest.raises(ValueError, match="ghost depth"):
        fdtd_ttiled.check_plan(203, 157, 5, 17, 20, blk)
    with pytest.raises(ValueError, match="domain"):
        fdtd_ttiled.check_plan(204, 157, 4, 17, 20, blk)


PLAN_SHAPES = [((8192, 8192), (2, 2)), ((8192, 8192), (4, 1)), ((4096, 4096), (4, 1)),
               ((4096, 4096), (2, 4)), ((203, 157), (3, 2)), ((64, 128), (8, 1)),
               ((64, 512), (2, 4))]


@pytest.mark.parametrize("shape,D", PLAN_SHAPES, ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}"
                                                      for s, d in PLAN_SHAPES])
def test_sharded_planner(shape, D):
    """The planner's (K, G, TH, TW): G = K, one tile shape that every block's
    owned extent takes, every block's plan admitted by the kernel's checks,
    the redundant compute under the single-device cap. Large grids keep the
    single-device plan (K = 8, 64 x 80 tiles); thin blocks fall to K = 2.
    Where the JAX planner admits a decomposition the port does too."""
    plan = plan_sharded_ttiled_2d(*shape, *D)
    assert plan is not None
    K, G, TH, TW = plan
    assert G == K and K in fdtd_ttiled.DEPTHS
    stepped = 0
    for row in mesh_blocks(*shape, *D, G):
        for blk in row:
            fdtd_ttiled.check_plan(*shape, K, TH, TW, blk)
            assert min(blk.r1 - blk.r0, blk.c1 - blk.c0) >= S
            stepped += ((fdtd_ttiled.redundancy(*shape, K, TH, TW, blk) + 1)
                        * (blk.r1 - blk.r0) * (blk.c1 - blk.c0))
    assert stepped / (shape[0] * shape[1]) - 1 <= fdtd_ttiled.MAX_REDUNDANCY
    if min(shape) >= 4096:
        assert (K, TH, TW) == (8, 64, 80)
    if shape == (64, 128):
        assert K == 2 and plan_sharded_ttiled(*shape, D[0]) == plan
    if D[1] == 1 and shape[0] % D[0] == 0:
        assert jax_plan(*shape, D[0]) is not None
    if shape[0] % D[0] == 0 and shape[1] % D[1] == 0 and D[1] > 1:
        assert jax_plan_2d(*shape, *D) is not None


def test_sharded_planner_refuses():
    assert plan_sharded_ttiled(20, 128, 8) is None          # 2- and 3-row blocks
    assert plan_sharded_ttiled_2d(64, 20, 2, 4) is None     # 5-column blocks
    assert jax_plan(20, 128, 8) is None


# -- (c) the rollout against the JAX package and the oracle ----------------------

def _block_scene(rows, cols, block):
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[block] *= 3.0
    return eps, np.full((rows, cols), constants.MU_0)


@pytest.mark.parametrize("src,steps", [((32, 64), 20), ((31, 9), 19)],
                         ids=["centre", "source-on-device-boundary-rem-sweep"])
def test_sharded_ttiled_matches_jax_and_oracle(src, steps):
    """tests/test_sharded.py's 1D cases: 64x128 over 8 devices (a block owns
    8 rows; at the JAX plan's K = 8 every halo crosses a block boundary),
    against the JAX function run in interpret mode on the 8-device CPU
    platform, all three fields within 1e-5 relative, and Ez within 1e-5 of
    the float64 NumPy oracle. Also at the port's own plan (K = 2)."""
    N, M = 64, 128
    eps, mu = _block_scene(N, M, (slice(20, 40), slice(50, 70)))
    assert jax_plan(N, M, 8) == (8, 8, 8)
    jcfg = JaxConfig(dt=DT, dx=DX, nsteps=steps, source_xy=src, source_fc=FC)
    ref = jax_sharded_ttiled(eps, mu, jcfg, jax_make_mesh((8,), axis_names=("x",)))[0]
    oracle = numpy_simulate(eps, mu, DT, DX, steps, src, FC)
    mesh = make_mesh((8,), axis_names=("x",), devices=["cpu"] * 8)
    for K, tile in ((8, (8, 64)), (None, None)):
        ours, snaps = simulate_sharded_ttiled(eps, mu, _config(steps, src), mesh, K=K, tile=tile)
        assert snaps is None
        for o, r in zip(ours, ref):
            assert tuple(o.shape) == r.shape and _rel(o, r) < 1e-5
        assert _rel(ours[0], oracle) < 1e-5
        assert ours[1].shape == (N, M - 1) and ours[2].shape == (N - 1, M)


def test_sharded_ttiled_2d_matches_jax_and_oracle():
    """tests/test_sharded.py's 2D case: 64x512 on a 2x4 mesh with the source
    on the corner where four blocks meet, against the JAX function
    (interpret mode) and the oracle at 1e-5; snapshots refused as there."""
    N, M = 64, 512
    eps, mu = _block_scene(N, M, (slice(20, 40), slice(100, 300)))
    src, steps = (N // 2, M // 2), 20
    jcfg = JaxConfig(dt=DT, dx=DX, nsteps=steps, source_xy=src, source_fc=FC)
    ref, jsnaps = jax_sharded_ttiled_2d(eps, mu, jcfg, jax_make_mesh((2, 4), axis_names=("r", "c")))
    oracle = numpy_simulate(eps, mu, DT, DX, steps, src, FC)
    mesh = _cpu_mesh((2, 4), ("r", "c"))
    K, G, TH, TW = plan_sharded_ttiled_2d(N, M, 2, 4)
    assert G >= K
    ours, snaps = simulate_sharded_ttiled_2d(eps, mu, _config(steps, src), mesh)
    assert snaps is None and jsnaps is None
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape and _rel(o, r) < 1e-5
    assert _rel(ours[0], oracle) < 1e-5
    with pytest.raises(ValueError, match="snapshots"):
        simulate_sharded_ttiled_2d(eps, mu, _config(steps, src, nframes=2), mesh)
    with pytest.raises(ValueError, match="1D"):
        simulate_sharded_ttiled_2d(eps, mu, _config(steps, src),
                                   make_mesh((8,), devices=["cpu"] * 8))


# -- (d) thin blocks: the JAX kernel's band-in-halo fault -----------------------

def test_records_jax_band_in_halo_fault_sharded():
    """Reference behaviour the parity tests must not treat as truth (ROADMAP,
    "Reference behaviour..."). At 64 rows over 8 devices a block owns ln =
    GH = 8 rows, so device 1's halo holds domain rows 0-7, the whole top
    Mur band, and the JAX kernel, told only that its block is not on top,
    steps them as interior cells; likewise at the bottom. From a random
    state (a zero state never brings a field to the band in 20 steps) the
    JAX sharded kernel misses the JAX plain step by more than 1e-6
    relative, while the port, which applies every band in every window that
    holds it, equals its plain step bit for bit."""
    N, M, steps, src = 64, 128, 8, (32, 64)
    eps, mu, state = _random_scene(np.random.default_rng(0), N, M)
    jcfg = JaxConfig(dt=DT, dx=DX, nsteps=steps, source_xy=src, source_fc=FC)
    jstate = [jnp.asarray(a) for a in state]
    jax_kernel = jax_sharded_ttiled(eps, mu, jcfg, jax_make_mesh((8,), axis_names=("x",)),
                                    state=jstate)[0]
    jax_plain = jax_simulate(eps, mu, dataclasses.replace(jcfg, backend="jax"), state=jstate)[0]
    jax_err = max(np.max(np.abs(np.asarray(k, np.float64) - np.asarray(p, np.float64)))
                  / np.max(np.abs(np.asarray(p, np.float64)))
                  for k, p in zip(jax_kernel, jax_plain))
    assert jax_err > 1e-6

    cfg = _config(steps, src)
    mesh = make_mesh((8,), axis_names=("x",), devices=["cpu"] * 8)
    assert mesh_blocks(N, M, 8, 1, 8)[1][0].rows == (0, 24)  # block 1 holds the top band
    ours, _ = simulate_sharded_ttiled(eps, mu, cfg, mesh, state=state, K=8, tile=(8, 64))
    plain, _ = simulate(eps, mu, dataclasses.replace(cfg, backend="torch"), state=state)
    for o, p, j in zip(ours, plain, jax_plain):
        assert torch.equal(o, p)
        assert _rel(o, j) < 1e-6


# -- (e) simulate_sharded's dispatch --------------------------------------------

def test_simulate_sharded_auto_with_frames_on_a_1d_mesh():
    """tests/test_sharded.py::test_simulate_sharded_dispatches_to_ttiled:
    'auto' on an admissible 1D mesh takes the kernel path (here its
    emulation) and snapshots ride along, on sweep multiples. At the JAX
    plan's K = 8 the frames are the JAX function's; at the port's own plan
    (K = 2 for 8-row blocks) the final fields still are."""
    N, M = 64, 128
    rng = np.random.default_rng(21)
    eps = np.broadcast_to(constants.EPSILON_0 * (1.0 + rng.random((N, 1))), (N, M)).copy()
    mu = np.full((N, M), constants.MU_0)
    cfg = _config(32, (32, 64), nframes=2, backend="auto")
    mesh = make_mesh((8,), axis_names=("x",), devices=["cpu"] * 8)
    jcfg = JaxConfig(dt=DT, dx=DX, nsteps=32, source_xy=(32, 64), source_fc=FC, nframes=2,
                     backend="auto")
    ref, jsnaps = jax_simulate_sharded(eps, mu, jcfg, jax_make_mesh((8,), axis_names=("x",)))
    ours, snaps = simulate_sharded(eps, mu, cfg, mesh)
    assert snaps.shape == (2, N, M) == jsnaps.shape
    for o, r in zip(ours, ref):
        assert _rel(o, r) < 1e-5
    at_k8, snaps8 = simulate_sharded_ttiled(eps, mu, cfg, mesh, K=8, tile=(8, 64))
    assert _rel(snaps8, jsnaps) < 1e-5 and _rel(at_k8[0], ref[0]) < 1e-5
    # frames on sweep multiples: frame k of 2 after (k + 1) * 16 steps
    half, _ = simulate(eps, mu, dataclasses.replace(cfg, nsteps=16, nframes=0, backend="torch"))
    assert _rel(snaps[0], half[0].numpy()) < 1e-5 and _rel(snaps8[0], half[0].numpy()) < 1e-5


def test_simulate_sharded_dispatches_to_ttiled_2d():
    """tests/test_sharded.py::test_simulate_sharded_dispatches_to_ttiled_2d:
    64x512 on a 2x4 mesh through simulate_sharded against the oracle."""
    N, M, src = 64, 512, (31, 200)
    eps = np.full((N, M), constants.EPSILON_0)
    mu = np.full((N, M), constants.MU_0)
    (got, _, _), snaps = simulate_sharded(eps, mu, _config(16, src), _cpu_mesh((2, 4), ("r", "c")))
    assert snaps is None
    assert _rel(got, numpy_simulate(eps, mu, DT, DX, 16, src, FC)) < 1e-5


def test_simulate_sharded_float64_matches_single_device():
    """tests/test_sharded.py::test_sharded_fdtd_matches_single_device: the
    float64 plain engine on a 2x4 mesh against the single-device plain path
    at 1e-12, the staggered shapes on every path, and a round-tripped state
    (staggered and padded) accepted back."""
    N = 96
    rng = np.random.default_rng(21)
    eps = constants.EPSILON_0 * (1.0 + rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    cfg = _config(60, (N // 2, N // 2), backend="torch", dtype=torch.float64)
    (want, _, _), _ = simulate(eps, mu, cfg)
    mesh = _cpu_mesh((2, 4))
    (got, hx, hy), _ = simulate_sharded(eps, mu, cfg, mesh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    assert hx.shape == (N, N - 1) and hy.shape == (N - 1, N)
    state1 = simulate(eps, mu, cfg)[0]
    (want2, _, _), _ = simulate(eps, mu, cfg, state=state1)
    padded = (got, torch.nn.functional.pad(hx, (0, 1)), torch.nn.functional.pad(hy, (0, 0, 0, 1)))
    for state in ((got, hx, hy), padded):
        (got2, _, _), _ = simulate_sharded(eps, mu, cfg, mesh, state=state)
        np.testing.assert_allclose(got2.numpy(), want2.numpy(), rtol=0, atol=1e-12)
    # 'auto' in float64 is the plain engine too, with simulate's frames
    auto = dataclasses.replace(cfg, backend="auto", nframes=4, nsteps=50)
    (a, _, _), snaps = simulate_sharded(eps, mu, auto, mesh)
    (w, _, _), wsnaps = simulate(eps, mu, dataclasses.replace(auto, backend="torch"))
    assert snaps.shape == wsnaps.shape == (4, N, N)
    np.testing.assert_allclose(snaps.numpy(), wsnaps.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0, atol=1e-12)


def test_simulate_sharded_ttiled_raises_on_an_inadmissible_grid():
    """'ttiled' raises where the plan does not admit the grid (20 rows over
    8 devices: 2- and 3-row blocks) or a 2D mesh is asked for frames, as the
    JAX package does; 'auto' on CPU blocks falls to the plain engine there
    and matches the single-device path; an unknown backend raises."""
    N, M = 20, 128
    eps = np.full((N, M), constants.EPSILON_0)
    mu = np.full((N, M), constants.MU_0)
    mesh = make_mesh((8,), axis_names=("x",), devices=["cpu"] * 8)
    cfg = _config(12, (10, 64), backend="ttiled")
    with pytest.raises(ValueError, match="admits no ttiled"):
        simulate_sharded(eps, mu, cfg, mesh)
    with pytest.raises(ValueError, match="own fewer"):
        simulate_sharded_ttiled(eps, mu, cfg, mesh)
    with pytest.raises(ValueError, match="fewer than 6"):
        simulate_sharded(eps, mu, dataclasses.replace(cfg, backend="auto"), mesh)
    with pytest.raises(ValueError, match="unknown backend"):
        simulate_sharded(eps, mu, dataclasses.replace(cfg, backend="pallas"), mesh)
    mesh4 = make_mesh((2,), axis_names=("x",), devices=["cpu"] * 2)
    (got, _, _), _ = simulate_sharded(eps, mu, dataclasses.replace(cfg, backend="auto"), mesh4)
    (want, _, _), _ = simulate(eps, mu, dataclasses.replace(cfg, backend="torch"))
    assert torch.equal(got, want)
    eps2 = np.full((64, 512), constants.EPSILON_0)
    mu2 = np.full((64, 512), constants.MU_0)
    framed = _config(16, (31, 200), backend="ttiled", nframes=2)
    with pytest.raises(ValueError, match="admits no ttiled"):
        simulate_sharded(eps2, mu2, framed, _cpu_mesh((2, 4)))


def test_parallel_package_imports_no_jax():
    """Every module of the port (the parallel package and all the others,
    found by walking the package) imports neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys

    code = ("import sys, pkgutil, importlib, fdtd2d_tpu_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages(fdtd2d_tpu_torch.__path__, "
            "'fdtd2d_tpu_torch.')]\n"
            "assert 'fdtd2d_tpu_torch.parallel.dryrun' in mods, mods\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'fdtd2d_tpu', 'optax', 'flax'))\n"
            "assert not bad, bad\n"
            "print(len(mods))")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 50
