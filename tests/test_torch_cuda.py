"""K1 (both modes), K2 (single-device and block mode) and K3 mode on the
card: the CUDA kernels against their plain versions; and the FDFD solvers
(stored, compressed and HPS direct factors, FGMRES) on the card against
complex128 on the CPU, and the HPS sweep of examples/direct_large.py at
1024^2.

These tests need an NVIDIA GPU and nvcc, and skip without them. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.core.grid import grid_init
from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate
from fdtd2d_tpu_torch.fdtd.step import MUR_BAND, precompute_coefficients
from fdtd2d_tpu_torch.ops import fdtd_blocked, fdtd_fused, fdtd_ttiled
from fdtd2d_tpu_torch.utils import trace

DT, DX, FC = 5e-14, 1e-4, 30e9
Z0 = 376.73  # vacuum impedance: scales the random H to the random Ez

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _launches(before, *kernels):
    """Each FDTD kernel counter's gain since the snapshot ``before``."""
    return tuple(trace.delta(before, f"fdtd.kernels.{k}") for k in kernels)


def _medium_and_state(dev, rows, cols, start):
    rng = np.random.default_rng(0)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    coeffs = precompute_coefficients(torch.tensor(eps, device=dev),
                                     torch.tensor(mu, device=dev), DT, DX)
    if start == "zero":
        return coeffs, grid_init(rows, cols, torch.float32, dev)
    return coeffs, tuple(torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                      device=dev) / scale
                         for shape, scale in (((rows, cols), 1.0), ((rows, cols - 1), Z0),
                                              ((rows - 1, cols), Z0)))


def boundary_cover(Ez, b=MUR_BAND):
    """Smallest max |Ez| over the four Mur bands and the four corners,
    relative to max |Ez| over the grid."""
    parts = (Ez[b:-b, :b], Ez[b:-b, -b:], Ez[:b, b:-b], Ez[-b:, b:-b],
             Ez[:b, :b], Ez[:b, -b:], Ez[-b:, :b], Ez[-b:, -b:])
    return float(min(p.abs().max() for p in parts) / Ez.abs().max())


@pytest.mark.parametrize("start", ["zero", "random"])
@pytest.mark.parametrize("source", [(30, 25), (6, 8)])
@pytest.mark.parametrize("kind", ["ricker", "sinusoidal"])
def test_kernel_matches_plain_float64(dev, start, source, kind):
    """An odd grid with a random medium, one run and two chunks, in K1's
    streaming mode and in its resident mode (the planner's 2 x 2 tiles and a
    forced 5 x 4 grid, whose seams cross every Mur band). The float64 plain
    run takes the kernel's float32 coefficients and state; the kernel differs
    from it by float32 rounding (FMA contraction, expf) only. Chunked equals
    single and resident equals streaming bit for bit.

    From a zero state the wave spreads about 18 cells in 120 steps, which
    checks the source but leaves most of the Mur bands near zero. The random
    state puts a field in every band and corner (asserted to be at least
    1e-3 of max |Ez|, so that a wrong value there is about 100 times the
    tolerance) and in the cells the step never writes."""
    rows, cols = 61, 47
    nsteps = 120 if start == "zero" else 60
    (ce, ch, coef), state = _medium_and_state(dev, rows, cols, start)
    plain = fdtd_fused.fdtd_multistep_fused_reference(
        *(f.double() for f in state), ce.double(), ch.double(), coef.double(), DT, FC,
        *source, nsteps, kind, 0)
    if start == "random":
        assert boundary_cover(plain[0]) >= 1e-3
    streaming = None
    for mode, tiles in (("streaming", None), ("resident", None), ("resident", (5, 4))):
        def run(fields, n, offset):
            return fdtd_fused.fdtd_multistep_fused(*fields, ce, ch, coef, DT, FC, *source, n,
                                                   kind, offset, mode=mode, tiles=tiles)

        before = trace.counters()
        one = run(state, nsteps, 0)
        two = run(run(state, 25, 0), nsteps - 25, 25)
        torch.cuda.synchronize()
        counted = _launches(before, "k1", "k1_resident")
        assert counted == ((3, 3) if mode == "resident" else (2 * 2 * nsteps, 0))
        streaming = streaming or one
        for k, c, s, p in zip(one, two, streaming, plain):
            assert k.shape == p.shape and torch.equal(k, c) and torch.equal(k, s)
            err = float((k.double() - p).abs().max() / p.abs().max())
            assert err <= 1e-5, f"{mode} {tiles}: relative error {err:.3e}"


@pytest.mark.parametrize("n", [200, 768, 1034])
def test_resident_modes_agree_at_size(dev, n):
    """Each variant of the resident kernel (200^2: fields and coefficients in
    registers; 768^2 and 1034^2, the largest an H100 holds: coefficients in
    shared memory) at the planner's tile grid, from a random state over a
    random medium: within 1e-5 of the float64 plain step and equal to the
    streaming mode bit for bit; the built kernel's layout is the planner's."""
    plan = fdtd_fused.plan_resident(n, n, *fdtd_fused.device_numbers(dev))
    fdtd_fused._check_layout.cache_clear()
    fdtd_fused._check_layout(plan.variant, dev)
    (ce, ch, coef), state = _medium_and_state(dev, n, n, "random")
    tail = (DT, FC, n - 4, n - 3, 40, "ricker", 7)
    resident = fdtd_fused.fdtd_multistep_fused(*state, ce, ch, coef, *tail, mode="resident")
    streaming = fdtd_fused.fdtd_multistep_fused(*state, ce, ch, coef, *tail, mode="streaming")
    plain = fdtd_fused.fdtd_multistep_fused_reference(
        *(f.double() for f in state), ce.double(), ch.double(), coef.double(), *tail)
    assert boundary_cover(plain[0]) >= 1e-3
    for r, s, p in zip(resident, streaming, plain):
        assert torch.equal(r, s)
        assert float((r.double() - p).abs().max() / p.abs().max()) <= 1e-5


def test_refused_cooperative_launch_raises(dev):
    """More tiles than the card holds resident: the planner refuses the
    grid, and a launch forced past it is refused by the runtime and raises;
    the next launch on the same device runs."""
    n = 512
    (ce, ch, coef), state = _medium_and_state(dev, n, n, "random")
    with pytest.raises(ValueError, match="beyond the resident mode"):
        fdtd_fused.fdtd_multistep_fused(*state, ce, ch, coef, DT, FC, 9, 9, 3, "ricker", 0,
                                        mode="resident", tiles=(32, 32))
    padded = fdtd_fused.pad_state(*state)
    chp = fdtd_fused.pad_field(ch, n, n)
    amps = torch.zeros(3, device=dev)
    too_many = fdtd_fused.ResidentPlan(fdtd_fused.VARIANTS[0], 32, 32)
    before = trace.counters()
    with pytest.raises(RuntimeError, match="refused 1024 blocks"):
        fdtd_fused.launch_resident(*padded, ce, chp, amps, 9, 9, float(coef), too_many)
    assert _launches(before, "k1") == (0,)
    good = fdtd_fused.fdtd_multistep_fused(*state, ce, ch, coef, DT, FC, 9, 9, 3, "ricker", 0,
                                           mode="resident")
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(f).all()) for f in good)


def test_simulate_auto_uses_kernel(dev):
    """A small grid with frames goes to K1's resident mode: one cooperative
    launch a frame, the padded state kept across the frames."""
    N = 64
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=40, source_xy=(20, 33), source_fc=FC,
                     nframes=4, device="cuda")
    before = trace.counters()
    (Ez, Hx, Hy), snaps = simulate(eps, mu, cfg)
    assert _launches(before, "k1", "k1_resident") == (4, 4)
    assert tuple(Hx.shape) == (N, N - 1) and tuple(Hy.shape) == (N - 1, N)
    plain, plain_snaps = simulate(eps, mu, dataclasses.replace(cfg, backend="torch",
                                                               dtype=torch.float64))
    for k, p in zip((Ez, Hx, Hy, snaps), (*plain, plain_snaps)):
        assert float((k.double() - p).abs().max() / p.abs().max()) <= 1e-5


@pytest.mark.parametrize("case", ["float64", "noncontiguous ce"])
def test_kernel_raises_on_what_it_does_not_take(dev, case):
    N = 32
    Ez, Hx, Hy = (torch.zeros(s, device=dev) for s in ((N, N), (N, N - 1), (N - 1, N)))
    ce, ch = torch.ones(N, N, device=dev), torch.ones(N - 1, N - 1, device=dev)
    if case == "float64":
        Ez, Hx, Hy, ce, ch = (t.double() for t in (Ez, Hx, Hy, ce, ch))
    else:
        ce = torch.ones(2 * N, N, device=dev)[::2]
    before = trace.counters()
    with pytest.raises(ValueError):
        fdtd_fused.fdtd_multistep_fused(Ez, Hx, Hy, ce, ch, 0.5, DT, FC, 16, 16, 5,
                                        "ricker", 0)
    assert _launches(before, "k1") == (0,)


@pytest.mark.parametrize("start", ["zero", "random"])
@pytest.mark.parametrize("source", [(30, 25), (6, 8)])
@pytest.mark.parametrize("mode", ["K2", "K3"])
def test_tiled_kernel_matches_plain_and_emulation(dev, mode, start, source):
    """The cases of chip_smoke.py phases 6 and 7 at 61x47: 9x8 tiles (61 % 9
    and 47 % 8 are 7), so that tile seams cross every band and corner; K2 at
    K = 7 (9 - 7 and 8 - 7 < 6: windows of non-edge tiles hold band cells;
    7 divides neither step count nor the split), K3 mode at K = 1. Held to
    the float64 plain step and to the tile emulation run in float64 on the
    same float32 inputs, within 1e-5 relative, and to itself in two chunks
    bit for bit. Each sweep (K2) or step (K3) is one launch."""
    rows, cols, tile = 61, 47, (9, 8)
    nsteps = 120 if start == "zero" else 60
    (ce, ch, coef), state = _medium_and_state(dev, rows, cols, start)
    kind = "ricker" if source == (30, 25) else "sinusoidal"
    K = 7 if mode == "K2" else 1
    counter = "k2_sweeps" if mode == "K2" else "k3"

    def run(fields, n, offset):
        if mode == "K2":
            return fdtd_ttiled.fdtd_multistep_ttiled(*fields, ce, ch, coef, DT, FC, *source,
                                                     n, kind, offset, K=K, tile=tile)
        return fdtd_blocked.fdtd_multistep_blocked(*fields, ce, ch, coef, DT, FC, *source,
                                                   n, kind, offset, tile=tile)

    before = trace.counters()
    one = run(state, nsteps, 0)
    two = run(run(state, 25, 0), nsteps - 25, 25)
    torch.cuda.synchronize()
    sweeps = lambda n: -(-n // K)  # noqa: E731
    assert _launches(before, counter) == (sweeps(nsteps) + sweeps(25) + sweeps(nsteps - 25),)
    emu = fdtd_ttiled.fdtd_multistep_ttiled_reference(
        *(f.double() for f in state), ce.double(), ch.double(), coef.double(), DT, FC,
        *source, nsteps, kind, 0, K, tile)
    plain = fdtd_fused.fdtd_multistep_fused_reference(
        *(f.double() for f in state), ce.double(), ch.double(), coef.double(), DT, FC,
        *source, nsteps, kind, 0)
    if start == "random":
        assert boundary_cover(plain[0]) >= 1e-3
    for k, c, e, p in zip(one, two, emu, plain):
        assert k.shape == p.shape and torch.equal(k, c)
        for ref in (e, p):
            err = float((k.double() - ref.double()).abs().max() / ref.double().abs().max())
            assert err <= 1e-5, f"relative error {err:.3e}"


@pytest.mark.parametrize("shape", [(400, 360), (403, 357)], ids=["400x360", "403x357"])
@pytest.mark.parametrize("mode", ["K2", "K3"])
def test_tiled_kernel_interior_body(dev, mode, shape):
    """The register body of interior tiles at the planner's plan, where
    several interior tiles with full 80 x 96 windows meet at seams, from a
    random state: held to the float64 plain step and to the float64 tile
    emulation within 1e-5 relative, and to itself in two chunks bit for bit.
    403x357 gives rows of 357 floats (padded to 360 for the 16-byte rows
    that TMA needs) and windows that start off a 16-byte column."""
    rows, cols = shape
    nsteps, split = 40, 17
    (ce, ch, coef), state = _medium_and_state(dev, rows, cols, "random")
    K = None if mode == "K2" else 1
    plan = fdtd_ttiled.resolve_plan(rows, cols, K)
    assert fdtd_ttiled.interior_tiles(rows, cols, *plan) >= 8
    source = (rows // 2, cols // 2)

    def run(fields, n, offset):
        if mode == "K2":
            return fdtd_ttiled.fdtd_multistep_ttiled(*fields, ce, ch, coef, DT, FC, *source,
                                                     n, "ricker", offset)
        return fdtd_blocked.fdtd_multistep_blocked(*fields, ce, ch, coef, DT, FC, *source,
                                                   n, "ricker", offset)

    one = run(state, nsteps, 0)
    two = run(run(state, split, 0), nsteps - split, split)
    torch.cuda.synchronize()
    f64 = (*(f.double() for f in state), ce.double(), ch.double(), coef.double(), DT, FC,
           *source, nsteps, "ricker", 0)
    emu = fdtd_ttiled.fdtd_multistep_ttiled_reference(*f64, plan[0], plan[1:])
    plain = fdtd_fused.fdtd_multistep_fused_reference(*f64)
    assert boundary_cover(plain[0]) >= 1e-3
    for k, c, e, p in zip(one, two, emu, plain):
        assert k.shape == p.shape and torch.equal(k, c)
        for ref in (e, p):
            err = float((k.double() - ref).abs().max() / ref.abs().max())
            assert err <= 1e-5, f"relative error {err:.3e}"


@pytest.mark.parametrize("n", [400, 4096, 8192])
def test_tiled_kernel_layout_matches_planner(dev, n):
    """The built kernel reports the static and dynamic shared memory, and the
    interior window, that the planner admitted its plans with."""
    K, TH, TW = fdtd_ttiled.pick_sweep_depth(n, n)
    WH, WW = fdtd_ttiled.window_extent(n, TH, K), fdtd_ttiled.window_extent(n, TW, K)
    fdtd_ttiled._check_layout.cache_clear()
    fdtd_ttiled._check_layout(WH, WW)


def test_simulate_ttiled_uses_kernel(dev):
    N = 64
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=40, source_xy=(20, 33), source_fc=FC,
                     nframes=4, backend="ttiled", device="cuda")
    K, _, _ = fdtd_ttiled.pick_sweep_depth(N, N)
    before = trace.counters()
    (Ez, Hx, Hy), snaps = simulate(eps, mu, cfg)
    assert _launches(before, "k2_sweeps") == (4 * -(-10 // K),)
    plain, plain_snaps = simulate(eps, mu, dataclasses.replace(cfg, backend="torch",
                                                               dtype=torch.float64))
    for k, p in zip((Ez, Hx, Hy, snaps), (*plain, plain_snaps)):
        assert float((k.double() - p).abs().max() / p.abs().max()) <= 1e-5


def test_tiled_kernel_raises_on_float64(dev):
    N = 32
    Ez, Hx, Hy = (torch.zeros(s, device=dev, dtype=torch.float64)
                  for s in ((N, N), (N, N - 1), (N - 1, N)))
    ce, ch = (torch.ones(s, device=dev, dtype=torch.float64) for s in ((N, N), (N - 1, N - 1)))
    before = trace.counters()
    with pytest.raises(ValueError, match="float32 only"):
        fdtd_ttiled.fdtd_multistep_ttiled(Ez, Hx, Hy, ce, ch, 0.5, DT, FC, 16, 16, 5,
                                          "ricker", 0)
    with pytest.raises(ValueError, match="float32 only"):
        fdtd_blocked.fdtd_multistep_blocked(Ez, Hx, Hy, ce, ch, 0.5, DT, FC, 16, 16, 5,
                                            "ricker", 0)
    assert _launches(before, "k2_sweeps", "k3") == (0, 0)


@pytest.mark.parametrize("mesh_shape,K,tile,source", [
    ((2, 2), 7, (13, 16), (102, 79)),   # the source where four blocks meet
    ((4, 1), 8, (17, 40), (10, 10)),    # outside three blocks' arrays
    ((3, 2), None, None, (199, 153)),   # the planner's tiles
])
def test_block_mode_matches_plain_float64_and_single_device(dev, mesh_shape, K, tile, source):
    """K2's block mode through the sharded rollout, every block on the one
    card: 203x157 from a random state that reaches every band and corner, 61
    steps (a short last sweep), against the float64 plain step at 1e-5 and
    against single-device K2 bit for bit; one launch a block a sweep."""
    from fdtd2d_tpu_torch.parallel import fdtd_sharded, make_mesh, simulate_sharded_ttiled

    rows, cols, nsteps = 203, 157, 61
    rng = np.random.default_rng(0)
    eps = (constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))).astype(np.float32)
    mu = np.full((rows, cols), constants.MU_0, np.float32)
    state = tuple((rng.standard_normal(shape) / scale).astype(np.float32)
                  for shape, scale in (((rows, cols), 1.0), ((rows, cols - 1), Z0),
                                       ((rows - 1, cols), Z0)))
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=nsteps, source_xy=source, source_fc=FC,
                     backend="ttiled", device="cuda")
    n = mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(mesh_shape, devices=[dev] * n)
    depth = fdtd_sharded._resolve_plan(rows, cols, *mesh_shape, K, tile)[0]
    before = trace.counters()
    kern, _ = simulate_sharded_ttiled(eps, mu, cfg, mesh, state=state, K=K, tile=tile)
    torch.cuda.synchronize()
    assert _launches(before, "k2_block_sweeps", "k2_sweeps") == (n * -(-nsteps // depth), 0)
    single, _ = simulate(eps, mu, cfg, state=state)
    plain, _ = simulate(eps, mu, dataclasses.replace(cfg, backend="torch", dtype=torch.float64),
                        state=state)
    assert boundary_cover(plain[0]) >= 1e-3
    for k, s, p in zip(kern, single, plain):
        assert k.shape == p.shape and torch.equal(k, s)
        assert float((k.double() - p).abs().max() / p.abs().max()) <= 1e-5


def test_block_sweep_raises_on_what_the_kernel_does_not_take(dev):
    """On CUDA tensors the block sweep launches the kernel or raises: float64
    buffers, buffers that are not in the kernel's layout, and a ghost depth
    below the sweep depth are refused before any launch."""
    blk = fdtd_ttiled.Block(64, 64, 0, 32, 0, 64, 4)
    AN, AM = blk.shape
    ld = fdtd_ttiled.row_stride(AM)

    def buffers(dtype=torch.float32, ld=ld):
        return (torch.zeros((3, AN, ld), dtype=dtype, device=dev),
                torch.zeros((3, AN, ld), dtype=dtype, device=dev),
                torch.ones((AN, ld), dtype=dtype, device=dev),
                torch.ones((AN, ld), dtype=dtype, device=dev))

    amps = torch.zeros(4, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    before = trace.counters()
    with pytest.raises(ValueError, match="float32"):
        fdtd_ttiled.fdtd_block_sweep(blk, *buffers(torch.float64), 0.5, amps.double(), counter,
                                     32, 32, 4, (16, 32))
    with pytest.raises(ValueError, match="contiguous"):
        fdtd_ttiled.fdtd_block_sweep(blk, *buffers(ld=ld + 4), 0.5, amps, counter, 32, 32, 4,
                                     (16, 32))
    with pytest.raises(ValueError, match="ghost depth"):
        fdtd_ttiled.fdtd_block_sweep(blk, *buffers(), 0.5, torch.zeros(5, device=dev), counter,
                                     32, 32, 5, (16, 32))
    assert _launches(before, "k2_block_sweeps") == (0,)
    fdtd_ttiled.fdtd_block_sweep(blk, *buffers(), 0.5, amps, counter, 32, 32, 4, (16, 32))
    torch.cuda.synchronize()
    assert _launches(before, "k2_block_sweeps") == (1,)


def test_auto_with_float64_runs_the_plain_step_on_the_card(dev):
    """'auto' names a kernel for float32 only: a float64 rollout on the card
    runs the plain step (it raised before), launches nothing, and equals
    backend='torch' bit for bit; sharded over four blocks of the card it
    agrees to 1e-12."""
    from fdtd2d_tpu_torch.parallel import make_mesh, simulate_sharded

    N = 96
    eps = np.full((N, N), constants.EPSILON_0)
    eps[20:40, 30:50] *= 3.0
    mu = np.full((N, N), constants.MU_0)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=40, source_xy=(48, 48), source_fc=FC, nframes=4,
                     backend="auto", dtype=torch.float64, device="cuda")
    before = trace.counters()
    (Ez, Hx, Hy), snaps = simulate(eps, mu, cfg)
    want, want_snaps = simulate(eps, mu, dataclasses.replace(cfg, backend="torch"))
    sharded, sharded_snaps = simulate_sharded(eps, mu, cfg, make_mesh((2, 2), devices=[dev] * 4))
    assert trace.delta(before, "fdtd.kernels.launches") == 0
    assert Ez.dtype == torch.float64 and Ez.is_cuda
    for a, b, c in zip((Ez, Hx, Hy, snaps), (*want, want_snaps), (*sharded, sharded_snaps)):
        assert torch.equal(a, b)
        assert float((c - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_direct_solver_on_card_matches_cpu_complex128(dev):
    """DirectSolver at 256^2 on the card (complex64 factors, complex128
    refinement, everything on the card) against the complex128 direct solve
    on the CPU."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver, solve_direct
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    N, dx, omega = 256, 1e-3, 17e9
    eps, mu, src = hard_binary_scene(N)
    solver = DirectSolver(eps, mu, dx, dx, omega, device=dev)
    assert solver.factors.stacked.Ws.is_cuda and solver.op64.eps.is_cuda
    x, trace = solver.solve(src, refine_target=1e-9)
    assert x.is_cuda and x.dtype == torch.complex64
    assert trace[-2] <= 1e-9 and trace[-1] < 5e-5
    op = make_operator(eps, mu, dx, dx, omega, dtype=torch.complex128, device="cpu")
    want = solve_direct(op, torch.as_tensor(-1j * omega * src))
    assert float((x.cpu().to(torch.complex128) - want).abs().max() / want.abs().max()) <= 1e-5


def test_fgmres_on_card_matches_cpu_complex128(dev):
    """FDM-FGMRES in complex64 at 128^2 on the card: converged within
    maxiter, and the field against the complex128 direct solve on the CPU.
    (tol 1e-5: complex64 FGMRES floors near 1.5e-6 on this scene.)"""
    from fdtd2d_tpu_torch.fdfd.direct import solve_direct
    from fdtd2d_tpu_torch.fdfd.solver import solve_fdfd
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    N, dx, omega = 128, 1e-3, 17e9
    rng = np.random.default_rng(7)
    eps = constants.EPSILON_0 * (1.0 + 2.0 * rng.random((N, N)))
    mu = np.full((N, N), constants.MU_0)
    b = np.zeros((N, N), np.complex128)
    b[N // 2, N // 2] = -1j * omega * 10.0
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=20, device=dev)
    res = solve_fdfd(op, torch.tensor(b, device=dev), tol=1e-5, maxiter=400, restart=20)
    assert res.x.is_cuda and res.relative_residual <= 1e-5 and res.iterations < 400
    want = solve_direct(make_operator(eps, mu, dx, dx, omega, pml_thickness=20,
                                      dtype=torch.complex128, device="cpu"),
                        torch.as_tensor(b))
    assert float((res.x.cpu().to(torch.complex128) - want).abs().max()
                 / want.abs().max()) <= 1e-4


def _hard(N):
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene

    return hard_binary_scene(N, seed=3, sigma=4.0, source_amp=10.0)


def _cpu_exact(eps, mu, omega, pml, src):
    from fdtd2d_tpu_torch.fdfd.direct import solve_direct
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    op = make_operator(eps, mu, 1e-3, 1e-3, omega, pml_thickness=pml, dtype=torch.complex128,
                       device="cpu")
    return solve_direct(op, torch.as_tensor(-1j * omega * src))


def _rel2(x, ref):
    x = x.cpu().to(torch.complex128)
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def test_compressed_on_card_matches_cpu(dev):
    """DirectSolver(compressed=True) at 160^2 (rank 10, leaf 16, q = 1) on the
    card: its raw backsolve within the range finder's 3e-3 of the exact
    complex128 solve on the CPU, and the refined complex128 iterate within
    1e-6 of it."""
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    N, omega = 160, 24e9
    eps, mu, src = _hard(N)
    solver = DirectSolver(eps, mu, 1e-3, 1e-3, omega, pml_thickness=20, compressed=True,
                          rank=10, leaf=16, device=dev)
    assert solver.factors.stacked.rows["D"].device.type == torch.device(dev).type
    want = _cpu_exact(eps, mu, omega, 20, src)
    b = torch.tensor(-1j * omega * src, dtype=torch.complex64, device=dev)
    assert _rel2(solver._solve(b), want) < 3e-3
    x64, trace = solver.solve(src, refine_target=1e-10, return_split=True)
    assert trace[-1] <= 1e-10 and x64.device.type == torch.device(dev).type
    assert _rel2(x64, want) < 1e-6


def test_compressed_one_sublattice_a_call_on_card(dev):
    """At 512^2 (rank 20, leaf 128, q = 1, bench.py's direct2048 keywords)
    the card's single and batched inverses round differently and the
    pivotless complex64 recursion carries that to ~1e-4 in both the stored
    and the compressed solves. The compressed factor one sublattice a call
    (bench.py's stacked_solve=False) is held to the stored factor built the
    same way, and the batched one to the batched store, at <= 1e-5; its gap
    to the batched compressed solve is the dense store's own (+ 1e-5)."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd import compressed as comp
    from fdtd2d_tpu_torch.fdfd.direct import (
        StackedFactors, factor, factor_stacked, solve_factored, solve_stacked,
        stack_coefficients)
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    N, omega = 512, 17e9
    eps, mu, src = hard_binary_scene(N, seed=3, source_amp=10.0)
    op = make_operator(eps, mu, 1e-3, 1e-3, omega, pml_thickness=40, device=dev)
    b = torch.tensor(-1j * omega * src, dtype=torch.complex64, device=dev)
    nc = N // 2
    L = comp.hodlr_plan(nc, leaf=128, rank=20)
    om = comp.make_test_matrices(nc, L, 20, device=dev)
    loop = comp.solve_compressed(comp.factor_compressed(op, om, L=L, q=1), b)
    stacked = comp.solve_compressed(StackedFactors(stacked=comp.factor_compressed_stacked(
        stack_coefficients(op), om, L=L, q=1), shape=op.shape), b)
    dense_loop = solve_factored(factor(op), b)
    dense_stacked = solve_stacked(factor_stacked(op), b)
    assert _rel2(loop, dense_loop.cpu().to(torch.complex128)) <= 1e-5
    assert _rel2(stacked, dense_stacked.cpu().to(torch.complex128)) <= 1e-5
    spread = _rel2(dense_loop, dense_stacked.cpu().to(torch.complex128))
    assert _rel2(loop, stacked.cpu().to(torch.complex128)) <= spread + 1e-5


def test_hps_on_card_matches_cpu(dev):
    """hps_factor / hps_solve at 64^2 on the card: the raw complex64
    residual < 5e-5 (tests/test_hps.py's bound), and DirectSolver(hps=True)'s
    refined iterate within 1e-6 of the exact complex128 solve on the CPU."""
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver
    from fdtd2d_tpu_torch.fdfd.hps import hps_factor, hps_solve
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    N, omega = 64, 17e9
    eps, mu, src = _hard(N)
    op = make_operator(eps, mu, 1e-3, 1e-3, omega, pml_thickness=12, device=dev)
    b = torch.tensor(-1j * omega * src, dtype=torch.complex64, device=dev)
    x = hps_solve(hps_factor(op, m=8), b)
    assert float(torch.linalg.vector_norm(op.apply(x) - b) / torch.linalg.vector_norm(b)) < 5e-5
    solver = DirectSolver(eps, mu, 1e-3, 1e-3, omega, pml_thickness=12, hps=True, device=dev)
    x64, trace = solver.solve(src, refine_target=1e-10, return_split=True)
    assert trace[-1] <= 1e-10
    assert _rel2(x64, _cpu_exact(eps, mu, omega, 12, src)) < 1e-6


def test_hps_sweep_at_1024_refines_to_1e8(dev):
    """examples/direct_large.py's HPS leg at 1024^2 on the card: the hard
    scene (seed 7, the source at N/3) and the script's 8-source sweep
    through solve_batched, each source at a true 1e-8 (the JAX package's
    complex64 factor on a CPU takes 8 rounds there,
    tools/examples_jax_witness.py)."""
    from fdtd2d_tpu_torch.apps import direct_large
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    N = 1024
    eps, mu, src = direct_large.hard_scene(N)
    solver = DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, hps=True, device=dev)
    _, per_sample, trace = solver.solve_batched(direct_large.sweep_sources(src, N),
                                                refine_target=1e-8)
    assert len(per_sample) == 8 and max(float(v) for v in per_sample) <= 1e-8, trace
    assert len(trace) - 1 <= 8, trace


def test_tf32_is_off_during_the_factors(dev, monkeypatch):
    """The pivotless complex64 factors need full-fp32 products: no matmul of
    the compressed or the HPS factor runs with TF32 on."""
    from fdtd2d_tpu_torch.fdfd import compressed, hps
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    seen = []

    def watch(fn):
        def wrapped(*a, **k):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.get_float32_matmul_precision()))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(compressed, "_compress_row", watch(compressed._compress_row))
    monkeypatch.setattr(hps, "_eliminate", watch(hps._eliminate))
    eps, mu, src = _hard(64)
    for kw in (dict(compressed=True, rank=8, leaf=8), dict(hps=True)):
        DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=12, device=dev, **kw)
    assert len(seen) > 32 and set(seen) == {(False, "highest")}
