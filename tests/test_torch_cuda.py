"""K1 (both modes), K2 (single-device and block mode), K3 mode, the direct
backsolve's row sweep and the refinement's residual kernels on the card: the
CUDA kernels against their plain versions; and the FDFD solvers
(stored, compressed and HPS direct factors, FGMRES) on the card against
complex128 on the CPU, and the HPS sweep of examples/direct_large.py at
1024^2.

These tests need an NVIDIA GPU and nvcc, and skip without them. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import functools

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


# -- the row-sweep kernel of the block-Thomas backsolve (ops/fdfd_rowsweep.py) ---------

# The kernel and the torch loop make the same complex64 products with float32
# FMAs; they sum each row's nc terms in another order (the kernel in 16 or
# more interleaved partial sums, cuBLAS in its tiles), so the two differ by
# float32 rounding carried through the recurrences: at most 7.3e-6 of a
# right-hand side's 2-norm on an H100 (1024^2, K = 16, 512 rows each way),
# 1.4e-6 or less at 128^2 and 129^2.
ROWSWEEP_TOL = 2e-5


@functools.lru_cache(maxsize=1)
def _stacked_factor(N):
    """The stacked complex64 factor of the benchmark's hard binary scene at N^2."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd.direct import factor_stacked
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    eps, mu, _ = hard_binary_scene(N)
    return factor_stacked(make_operator(eps, mu, 1e-3, 1e-3, 17e9, device="cuda")).stacked


def _sweep_vs_loop(f, K, seed=0):
    """(worst relative 2-norm error of a right-hand side, launches): the
    kernel against the torch loop on random complex64 right-hand sides."""
    from fdtd2d_tpu_torch.ops import fdfd_rowsweep as rs

    rng = np.random.default_rng(seed)
    shape = tuple(f.Ws.shape[:-3]) + (K,) + tuple(f.Ws.shape[-3:-1])
    b = torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                     dtype=torch.complex64, device=f.Ws.device)
    nv, sv = f.nvals.contiguous(), f.svals.contiguous()
    before = trace.counters()
    x = rs.row_sweep(f.Ws, nv, sv, b)
    torch.cuda.synchronize()
    launches = trace.delta(before, "fdfd.kernels.row_sweeps")
    want = rs.row_sweep_reference(f.Ws, nv, sv, b)
    assert x.shape == want.shape and x.dtype == torch.complex64
    err = (torch.linalg.vector_norm(x - want, dim=(-2, -1))
           / torch.linalg.vector_norm(want, dim=(-2, -1)))
    return float(err.max()), launches


@pytest.mark.parametrize("N, K", [(128, 1), (128, 16), (128, 40),
                                  (1024, 1), (1024, 16), (1024, 40)])
def test_row_sweep_matches_the_loop_on_stacked_factors(dev, N, K):
    """The kernel against its plain version on the card, in complex64, on
    the stacked factors of the hard binary scene: one launch a direction
    (K = 40 runs as three chunks in the same launch)."""
    err, launches = _sweep_vs_loop(_stacked_factor(N), K)
    assert launches == 2
    assert err <= ROWSWEEP_TOL, (N, K, err)


def test_row_sweep_matches_the_loop_on_an_odd_grid(dev):
    """129^2: one sublattice a call, rows of 65 and 64 (the odd rows take the
    kernel's 8-byte copies), couplings that are strided views; through
    solve_factored, the field of the kernel against that of the loop."""
    from fdtd2d_tpu_torch.fdfd import direct
    from fdtd2d_tpu_torch.ops import fdfd_rowsweep as rs
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    eps, mu, src = _hard(129)
    f = direct.factor(make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=12, device=dev))
    assert {s.Ws.shape[-1] for s in f.subs} == {64, 65}
    for k, sub in enumerate(f.subs):
        err, launches = _sweep_vs_loop(sub, 16, seed=k)
        assert launches == 2 and err <= ROWSWEEP_TOL, (k, err)
    b = torch.tensor(-1j * 17e9 * src, dtype=torch.complex64, device=dev)
    before = trace.counters()
    x = direct.solve_factored(f, b)
    assert trace.delta(before, "fdfd.kernels.row_sweeps") == 8
    loop = [rs.row_sweep_reference(s.Ws, s.nvals, s.svals, b[None, px::2, py::2])[0]
            for s, (px, py) in zip(f.subs, direct._PARITIES)]
    want = torch.zeros_like(b)
    for xs, (px, py) in zip(loop, direct._PARITIES):
        want[px::2, py::2] = xs
    err = float(torch.linalg.vector_norm(x - want) / torch.linalg.vector_norm(want))
    assert err <= ROWSWEEP_TOL, err


def test_row_sweep_matches_the_loop_on_a_scene_batch(dev):
    """A scene-batched stacked factor of three scenes at 96^2 (12 groups):
    two right-hand sides a scene."""
    from fdtd2d_tpu_torch.fdfd.direct import factor_stacked
    from fdtd2d_tpu_torch.models.datagen import make_operator_traced

    B, N = 3, 96
    rng = np.random.default_rng(N)
    eps = np.where(rng.random((B, N, N)) > 0.5, 5.0, 1.0) * constants.EPSILON_0
    mu = np.full((B, N, N), constants.MU_0)
    omega = rng.uniform(18e9, 30e9, B)
    op = make_operator_traced(torch.tensor(eps, device=dev), torch.tensor(mu, device=dev), 1e-3,
                              1e-3, torch.tensor(omega, device=dev), 8, dtype=torch.complex64)
    f = factor_stacked(op).stacked
    assert f.Ws.shape == (4, B, N // 2, N // 2, N // 2)
    err, launches = _sweep_vs_loop(f, 2)
    assert launches == 2 and err <= ROWSWEEP_TOL, err


def test_solve_batched_takes_the_row_sweep(dev, monkeypatch):
    """DirectSolver.solve_batched at 256^2: two row-sweep launches an inner
    solve; the same refinement rounds as with the torch loop in their
    place, and fields within 1e-6 of the loop's."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd import direct
    from fdtd2d_tpu_torch.ops import fdfd_rowsweep as rs

    N, B = 256, 4
    eps, mu, _ = hard_binary_scene(N)
    solver = direct.DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, device=dev)
    ij = np.random.default_rng(0).integers(N // 4, 3 * N // 4, size=(B, 2))
    srcs = np.zeros((B, N, N))
    srcs[np.arange(B), ij[:, 0], ij[:, 1]] = 1.0
    before = trace.counters()
    x, res, tr = solver.solve_batched(srcs, refine_target=1e-6)
    inner = trace.delta(before, "fdfd.backsolve")
    assert inner == len(tr) - 1 >= 1
    assert trace.delta(before, "fdfd.kernels.row_sweeps") == 2 * inner
    monkeypatch.setattr(direct, "_solve_rows",
                        lambda f, b: rs.row_sweep_reference(f.Ws, f.nvals, f.svals, b))
    before = trace.counters()
    x_loop, res_loop, tr_loop = solver.solve_batched(srcs, refine_target=1e-6)
    assert trace.delta(before, "fdfd.kernels.row_sweeps") == 0
    assert len(tr) == len(tr_loop), (tr, tr_loop)
    assert float(res.max()) <= 1e-6 and float(res_loop.max()) <= 1e-6
    err = (torch.linalg.vector_norm(x - x_loop, dim=(1, 2))
           / torch.linalg.vector_norm(x_loop, dim=(1, 2)))
    assert float(err.max()) <= 1e-6, err


def test_refused_row_sweep_launch_raises(dev):
    """A plan forced past the CTAs the card holds resident at once: the
    runtime refuses the cooperative launch and the wrapper raises, counting
    nothing; the next launch on the same device runs."""
    from fdtd2d_tpu_torch.ops import fdfd_rowsweep as rs

    rng = np.random.default_rng(1)
    G, nr, nc, K = 4, 2, 512, 16

    def c64(*shape):
        return torch.tensor(rng.standard_normal(shape) + 1j * rng.standard_normal(shape),
                            dtype=torch.complex64, device=dev) / nc

    Ws, nv, sv, b = c64(G, nr, nc, nc), c64(G, nr, nc), c64(G, nr, nc), c64(G, K, nr, nc)
    plan = rs.plan_row_sweep(G, nr, nc, K, *fdtd_fused.device_numbers(dev)[::2])
    too_many = dataclasses.replace(plan, ctas=4 * plan.ctas)
    exch = torch.empty(too_many.per_launch * 2 * nc * too_many.kp, dtype=torch.complex64,
                       device=dev)
    before = trace.counters()
    with pytest.raises(RuntimeError, match=f"refused {too_many.grid} CTAs"):
        rs.launch(Ws, nv, sv, b, torch.empty_like(b), exch, too_many, False, 0)
    assert trace.delta(before, "fdfd.kernels.row_sweeps") == 0
    x = rs.row_sweep(Ws, nv, sv, b)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(torch.view_as_real(x)).all())
    assert trace.delta(before, "fdfd.kernels.row_sweeps") == 2


# -- the refinement's residual kernels (ops/fdfd_residual.py) ------------------------

def _residual_op(dev, N, M):
    """The complex128 operator of the hard binary scene at N^2, else of a
    random medium at N x M (PML up to a third of the smaller side)."""
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    if N == M and N >= 64:
        eps, mu, _ = _hard(N)
    else:
        rng = np.random.default_rng(N * 7 + M)
        eps = rng.uniform(1.0, 4.0, (N, M)) * constants.EPSILON_0
        mu = np.full((N, M), constants.MU_0)
    return make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=min(40, N // 3, M // 3),
                         dtype=torch.complex128, device=dev)


def _c128(shape, dev, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex128, device=dev, generator=g) * scale


def _c64_ulps(got, want):
    """Largest difference of two complex64 tensors in units of the last place
    of ``want``'s parts."""
    g, w = torch.view_as_real(got).double(), torch.view_as_real(want).double()
    spacing = torch.tensor(np.spacing(np.abs(torch.view_as_real(want).cpu().numpy())),
                           dtype=torch.float64, device=want.device)
    return float(((g - w).abs() / spacing).max())


@pytest.mark.parametrize("N, M, B", [(1024, 1024, 16), (2048, 2048, 16), (203, 157, 1),
                                     (203, 157, None), (6, 6, None), (6, 6, 3)])
def test_residual_kernel_matches_plain(dev, N, M, B):
    """One residual pass by the kernels against the plain version: ||r||
    within 1e-13 relative, r / ||r|| within 2 complex64 units of the last
    place. With b = A x + 1e-8 noise, where r is all rounding-sensitive
    cancellation, r / ||r|| equals the operator's residual scaled by the
    kernels' own norm bit for bit: r is the chain's r."""
    from fdtd2d_tpu_torch.ops import fdfd_residual as fr

    op = _residual_op(dev, N, M)
    shape = (N, M) if B is None else (B, N, M)
    x = _c128(shape, dev, 1)
    noise = _c128(shape, dev, 2, 1e10)
    for b in (noise, op.apply(x) + 1e-8 * noise):
        before = trace.counters()
        rc, rn = fr.residual_pass(op, b, x)
        torch.cuda.synchronize()
        assert trace.delta(before, "fdfd.kernels.residual_passes") == 1
        want_rc, want_rn = fr.residual_pass_reference(op, b, x)
        assert rn.shape == want_rn.shape == shape[:-2] and rc.dtype == torch.complex64
        assert float(((rn - want_rn).abs() / want_rn).max()) <= 1e-13
        assert _c64_ulps(rc, want_rc) <= 2.0
        inv = 1.0 / rn
        assert torch.equal(rc, (op.residual(b, x) * inv[..., None, None]).to(torch.complex64))
        nb = fr.norms(b)
        assert float(((nb - fr.norms_reference(b)).abs() / nb).max()) <= 1e-13


def test_residual_norms_repeat_bit_for_bit(dev):
    """No atomics: two passes over the same input give the same bits."""
    from fdtd2d_tpu_torch.ops import fdfd_residual as fr

    op = _residual_op(dev, 1024, 1024)
    x, b = _c128((16, 1024, 1024), dev, 3), _c128((16, 1024, 1024), dev, 4, 1e10)
    rc1, rn1 = fr.residual_pass(op, b, x)
    rc2, rn2 = fr.residual_pass(op, b, x)
    assert torch.equal(rn1, rn2) and torch.equal(rc1, rc2)
    assert torch.equal(fr.norms(b), fr.norms(b))


@pytest.mark.parametrize("shape", [(16, 1024, 1024), (203, 157)])
def test_update_kernel_matches_plain(dev, shape):
    """x += ||r|| d in place, within 1e-15 relative of the plain update (the
    same two roundings a part: bit for bit on an H100)."""
    from fdtd2d_tpu_torch.ops import fdfd_residual as fr

    x = _c128(shape, dev, 5)
    d = _c128(shape, dev, 6).to(torch.complex64)
    rn = torch.rand(shape[:-2], dtype=torch.float64, device=dev) * 1e6
    got = x.clone()
    before = trace.counters()
    assert fr.update(got, rn, d) is got
    assert trace.delta(before, "fdfd.kernels.refine_updates") == 1
    want = fr.update_reference(x.clone(), rn, d)
    assert float(((got - want).abs() / want.abs().clamp_min(1e-300)).max()) <= 1e-15


@pytest.mark.parametrize("mode", ["block-Thomas 1024", "hps 512"])
def test_solve_batched_takes_the_residual_kernels(dev, monkeypatch, mode):
    """DirectSolver.solve_batched with the kernels against torch's chain in
    their place: the same rounds; one residual pass a round plus one and one
    update a round by the kernels, none by the chain; the kernel path's
    residuals within 1e-12 of the chain's residual of the same iterates. The
    two paths' iterates differ by ~1e-18 of their norm: the norms sum in
    another order, which moves a rare complex64 rounding of r / ||r||."""
    from fdtd2d_tpu_torch.fdfd import direct
    from fdtd2d_tpu_torch.ops import fdfd_residual as fr

    N, B = (1024, 16) if mode.startswith("block") else (512, 8)
    eps, mu = _bench_scene(N)
    solver = direct.DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, hps=mode.startswith("hps"),
                                 device=dev)
    ij = np.random.default_rng(0).integers(N // 4, 3 * N // 4, size=(B, 2))
    srcs = np.zeros((B, N, N))
    srcs[np.arange(B), ij[:, 0], ij[:, 1]] = 1.0
    before = trace.counters()
    x, res, tr = solver.solve_batched(srcs, refine_target=1e-6, return_split=True)
    rounds = len(tr) - 1
    assert rounds >= 1 and float(res.max()) <= 1e-6
    assert trace.delta(before, "fdfd.kernels.residual_passes") == rounds + 1
    assert trace.delta(before, "fdfd.kernels.refine_updates") == rounds
    b64 = solver._rhs(srcs, None)
    chain_res = (torch.linalg.vector_norm(solver.op64.residual(b64, x), dim=(1, 2))
                 / torch.linalg.vector_norm(b64, dim=(1, 2))).cpu().numpy()
    assert np.max(np.abs(res - chain_res) / chain_res) <= 1e-12
    monkeypatch.setattr(fr, "takes_kernel", lambda *args, **kwargs: False)
    before = trace.counters()
    x_c, res_c, tr_c = solver.solve_batched(srcs, refine_target=1e-6, return_split=True)
    assert trace.delta(before, "fdfd.kernels.residual_passes") == 0
    assert trace.delta(before, "fdfd.kernels.refine_updates") == 0
    assert len(tr_c) == len(tr), (tr, tr_c)
    err = (torch.linalg.vector_norm(x - x_c, dim=(1, 2))
           / torch.linalg.vector_norm(x_c, dim=(1, 2)))
    assert float(err.max()) <= 1e-15, err


def _bench_scene(N):
    """eps and mu of the benchmark's hard binary scene at N^2."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene

    eps, mu, _ = hard_binary_scene(N)
    return eps, mu


def test_refine_on_card_leaves_x0_and_counts(dev):
    """refine with a supplied x0 on the card: the kernels run (a pass a round
    plus one, an update a round) and x0 comes back unmodified."""
    from fdtd2d_tpu_torch.fdfd import direct
    from fdtd2d_tpu_torch.fdfd.refine import refine

    N = 256
    eps, mu = _bench_scene(N)
    solver = direct.DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, device=dev)
    b = torch.zeros((N, N), dtype=torch.complex128, device=dev)
    b[N // 2, N // 3] = -1j * 17e9
    x0 = 1e-3 * _c128((N, N), dev, 7)
    kept = x0.clone()
    before = trace.counters()
    out = refine(solver.op64, b, solver._solve, target=1e-9, x0=x0)
    assert out.rounds >= 1 and out.relative_residual <= 1e-9
    assert trace.delta(before, "fdfd.kernels.residual_passes") == len(out.trace)
    assert trace.delta(before, "fdfd.kernels.refine_updates") == out.rounds
    assert torch.equal(x0, kept)


@pytest.mark.parametrize("case", ["stacked operator", "complex64 operator",
                                  "non-contiguous field", "patch-stacked operator"])
def test_residual_rule_sends_the_rest_to_the_chain_on_card(dev, case):
    """On the card, what lies outside the rule runs torch's chain: the rule
    refuses it, no kernel counter moves, and the step returns the chain's
    values."""
    from fdtd2d_tpu_torch.fdfd.refine import _residual_step, scaled_norm
    from fdtd2d_tpu_torch.ops import fdfd_residual as fr
    from fdtd2d_tpu_torch.fdfd.tiled import stack_patch_operators
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator, stack_operators

    rng = np.random.default_rng(8)
    eps = rng.uniform(1.0, 4.0, (24, 24)) * constants.EPSILON_0
    mu = np.full((24, 24), constants.MU_0)

    def op_at(w, dtype=torch.complex128):
        return make_operator(eps, mu, 1e-3, 1e-3, w, pml_thickness=4, dtype=dtype, device=dev)

    op, shape = op_at(17e9), (3, 24, 24)
    if case == "stacked operator":
        op = stack_operators([op_at(15e9), op_at(17e9), op_at(19e9)])
    elif case == "complex64 operator":
        op = op_at(17e9, torch.complex64)
    elif case == "patch-stacked operator":
        op = stack_patch_operators(eps, mu, np.array([[0, 0], [8, 8], [12, 12]]), 12, 1e-3,
                                   1e-3, 17e9, 2, torch.complex128, device=dev)
        shape = (3, 12, 12)
    x, b = _c128(shape, dev, 9), _c128(shape, dev, 10, 1e10)
    if case == "non-contiguous field":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    kernel = fr.takes_kernel(op, b, x, torch.complex64)
    assert not kernel
    before = trace.counters()
    rc, rn = _residual_step(op, b, x, torch.complex64, kernel)
    torch.cuda.synchronize()
    assert trace.delta(before, "fdfd.kernels.residual_passes") == 0
    r = op.residual(b, x)
    want_rn = scaled_norm(r, batched=True)
    assert torch.equal(rn, want_rn)
    assert torch.equal(rc, (r / want_rn[:, None, None]).to(torch.complex64))


@pytest.mark.parametrize("case", ["complex64 x", "non-contiguous b"])
def test_residual_wrapper_raises_on_card(dev, case):
    """The wrapper refuses what the kernels do not take, before a launch."""
    from fdtd2d_tpu_torch.ops import fdfd_residual as fr

    op = _residual_op(dev, 24, 24)
    x, b = _c128((2, 24, 24), dev, 11), _c128((2, 24, 24), dev, 12)
    if case == "complex64 x":
        x = x.to(torch.complex64)
    else:
        b = b.transpose(1, 2).contiguous().transpose(1, 2)
    before = trace.counters()
    with pytest.raises(ValueError, match="complex128|contiguous"):
        fr.residual_pass(op, b, x)
    assert trace.delta(before, "fdfd.kernels.residual_passes") == 0


# -- the HPS level kernel (ops/fdfd_hps.py) -----------------------------------------

# The kernel and the torch path make the same complex64 products with float32
# FMAs and sum them in another order (the kernel each chunk of terms in order,
# then the chunks' sums; cuBLAS in its tiles), so their answers differ by
# float32 rounding carried through the two sweeps: on an H100 at most 1.17e-6
# of a right-hand side's 2-norm on random factors, 64^2 to 512^2.
HPS_TOL = 1e-5


def _random_hps_factors(plan, lead, dev, seed, y_t=False):
    """Complex64 factors of ``plan``'s shapes with the leading axes ``lead``:
    normal entries scaled by the inverse square root of a row's terms, so
    that the sweeps neither grow nor shrink the right-hand sides much; with
    ``y_t`` each Y stored transposed, as torch.linalg.inv leaves it on the card."""
    from fdtd2d_tpu_torch.fdfd import hps

    gen = torch.Generator(device=dev).manual_seed(seed)

    def c(*shape, t=False):
        a = torch.randn(*lead, *shape, dtype=torch.complex64, device=dev,
                        generator=gen) / float(np.sqrt(shape[-1]))
        return a.mT.contiguous().mT if t else a

    lf = plan.leaf
    nI, rho = len(lf.idx_I), len(lf.idx_R)
    levels = tuple(hps.LevelFactors(Y=c(mp.n_parents, len(mp.idx_J), len(mp.idx_J), t=y_t),
                                    E=c(mp.n_parents, len(mp.idx_J), len(mp.idx_R)))
                   for mp in plan.merges)
    top = len(plan.root_coords)
    return hps.SubHPSFactors(leaf=hps.LevelFactors(Y=c(lf.n_boxes, nI, nI, t=y_t),
                                                   E=c(lf.n_boxes, nI, rho)),
                             levels=levels, Yroot=c(top, top, t=y_t))


def _rhs_err(x, want):
    """The worst relative 2-norm error of a right-hand side, (..., K, points)."""
    return float((torch.linalg.vector_norm(x - want, dim=-1)
                  / torch.linalg.vector_norm(want, dim=-1)).max())


@pytest.mark.parametrize("K", [1, 5, 16, 20])
@pytest.mark.parametrize("N", [64, 128, 256, 512])
def test_hps_sweeps_match_solve_cols_on_random_factors(dev, N, K):
    """The kernel against the plain torch path (``_solve_cols``, cuBLAS) and
    against its own plain version on the card, four sublattices of an N^2
    grid on random complex64 factors, each Y stored transposed at 64^2 and
    256^2: one launch a level and direction, the leaf included, a chunk of
    at most 16 right-hand sides (K = 20 runs two)."""
    from fdtd2d_tpu_torch.fdfd import hps
    from fdtd2d_tpu_torch.ops import fdfd_hps

    plan = hps.build_plan(N // 2, N // 2, 8)
    f = _random_hps_factors(plan, (4,), dev, seed=N + K, y_t=N in (64, 256))
    gen = torch.Generator(device=dev).manual_seed(K)
    b = torch.randn(4, K, plan.nr * plan.nc, dtype=torch.complex64, device=dev, generator=gen)
    ops = hps._sweep_operands(f, plan, b.device)
    before = trace.counters()
    x = fdfd_hps.hps_sweeps(*ops, b)
    torch.cuda.synchronize()
    chunks = -(-K // 16)
    assert trace.delta(before, "fdfd.kernels.hps_sweeps") == 2 * (len(plan.merges) + 1) * chunks
    want = hps._solve_cols(f, plan, b.movedim(-1, -2).contiguous()).movedim(-1, -2)
    walked = fdfd_hps.hps_sweeps_reference(*ops, b)
    assert x.shape == b.shape and x.dtype == torch.complex64
    err, err_walk = _rhs_err(x, want), _rhs_err(x, walked)
    print(f"N {N}, K {K}: kernel vs _solve_cols {err:.3e}, vs its plain version {err_walk:.3e}")
    assert err <= HPS_TOL and err_walk <= HPS_TOL, (err, err_walk)


def test_hps_design_step_takes_the_level_kernel_with_a_member_axis(dev):
    """A decade-style design step (apps/inverse_design.py, solver "hps") at
    128^2 over 3 omegas: on the card one set of level launches an inner
    solve for every member (the (4, F) groups), none on the CPU (the torch
    path), and the card's loss and gradient within 1e-6 and 1e-5 of the
    CPU's, both refined to 1e-6."""
    from fdtd2d_tpu_torch.apps import inverse_design as invdes
    from fdtd2d_tpu_torch.fdfd import hps

    N = 128
    d0 = None
    out = {}
    for device in (dev, torch.device("cpu")):
        p = invdes.lowpass_problem(N=N, n_freqs=3, device=device)
        rs, cs = p.design_region
        if d0 is None:
            d0 = np.random.default_rng(0).uniform(1.0, 3.0, (rs.stop - rs.start, cs.stop - cs.start))
        state = invdes.design_state(p, solver="hps", design0=torch.as_tensor(d0))
        before = trace.counters()
        step = invdes.design_step(state)
        out[device.type] = (float(step.loss), step.grad.cpu(),
                            trace.delta(before, "fdfd.kernels.hps_sweeps"),
                            trace.delta(before, "fdfd.hps.solves"))
    launches = 2 * (len(hps.build_plan(N // 2, N // 2, 8).merges) + 1)
    loss, grad, swept, solves = out["cuda"]
    assert solves >= 2 and swept == launches * solves and out["cpu"][2] == 0
    assert abs(loss - out["cpu"][0]) <= 1e-6 * out["cpu"][0]
    assert float((grad - out["cpu"][1]).norm() / out["cpu"][1].norm()) <= 1e-5


def test_hps_solve_batched_takes_the_level_kernel(dev, monkeypatch):
    """DirectSolver(hps=True).solve_batched at 256^2: 2 (levels + 1) launches
    an inner solve, and the same refinement rounds as the torch path in the
    kernel's place, fields within 1e-6 of its; solve (one right-hand side)
    goes through the kernel too."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd import hps
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    N, B = 256, 4
    eps, mu, src = hard_binary_scene(N)
    solver = DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, hps=True, device=dev)
    launches = 2 * (len(hps.build_plan(N // 2, N // 2, 8).merges) + 1)
    ij = np.random.default_rng(0).integers(N // 4, 3 * N // 4, size=(B, 2))
    srcs = np.zeros((B, N, N))
    srcs[np.arange(B), ij[:, 0], ij[:, 1]] = 1.0
    before = trace.counters()
    x, res, tr = solver.solve_batched(srcs, refine_target=1e-6, return_split=True)
    inner = trace.delta(before, "fdfd.backsolve")
    assert inner == len(tr) - 1 >= 1
    assert trace.delta(before, "fdfd.kernels.hps_sweeps") == launches * inner
    before = trace.counters()
    _, tr1 = solver.solve(src, refine_target=1e-6)
    assert trace.delta(before, "fdfd.kernels.hps_sweeps") == launches * (len(tr1) - 2)
    monkeypatch.setattr(hps, "_on_card", lambda f, b: False)
    before = trace.counters()
    x_torch, res_torch, tr_torch = solver.solve_batched(srcs, refine_target=1e-6,
                                                        return_split=True)
    torch.cuda.synchronize()
    assert trace.delta(before, "fdfd.kernels.hps_sweeps") == 0
    assert len(tr) == len(tr_torch), (tr, tr_torch)
    assert float(res.max()) <= 1e-6 and float(res_torch.max()) <= 1e-6
    err = (torch.linalg.vector_norm(x - x_torch, dim=(1, 2))
           / torch.linalg.vector_norm(x_torch, dim=(1, 2)))
    assert float(err.max()) <= 1e-6, err


def test_hps_sweeps_on_the_hard_scene_factor(dev):
    """The stacked complex64 factor of the hard binary scene at 512^2 at
    K = 16: the kernel's solve as near the solve with the complex128 factor
    as the torch path's, and its raw residual as small, within a quarter.
    Both are far from exact here (raw residual ~1.5e-4: the complex64 error
    grows about tenfold a grid doubling, fdfd/hps.py), and the two sum in
    another order, so they differ by that much and either may be nearer
    (on an H100: kernel 1.073e-4 from the complex128 solve, torch path
    1.031e-4; raw residuals 1.513e-4 and 1.497e-4)."""
    from fdtd2d_tpu_torch.fdfd import hps
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    N = 512
    eps, mu, _ = _hard(N)
    ops = {dt: make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=40, dtype=dt, device=dev)
           for dt in (torch.complex64, torch.complex128)}
    op = ops[torch.complex64]
    f = hps.hps_factor(op, m=8)
    gen = torch.Generator(device=dev).manual_seed(3)
    b = torch.randn(16, N, N, dtype=torch.complex64, device=dev, generator=gen)
    x = hps.hps_solve(f, b)
    wide = hps.hps_solve(hps.hps_factor(ops[torch.complex128], m=8), b.to(torch.complex128))
    plan = hps.build_plan(N // 2, N // 2, 8)
    cols = torch.stack(hps.split_sublattices(b)).flatten(-2)
    want = hps._solve_cols(f.stacked, plan, cols.movedim(-1, -2).contiguous()).movedim(-1, -2)
    x_torch = torch.empty_like(x)
    hps.merge_sublattices(want.reshape(4, 16, N // 2, N // 2), x_torch)

    def err(x):
        return float((torch.linalg.vector_norm(x - wide, dim=(1, 2))
                      / torch.linalg.vector_norm(wide, dim=(1, 2))).max())

    def residual(x):
        return float((torch.linalg.vector_norm(op.apply(x) - b, dim=(1, 2))
                      / torch.linalg.vector_norm(b, dim=(1, 2))).max())

    got = (err(x), err(x_torch), residual(x), residual(x_torch))
    print("512^2 hard scene, K 16: from the complex128 factor's solve, kernel %.3e, torch path "
          "%.3e; raw residual kernel %.3e, torch path %.3e" % got)
    assert got[0] <= 1.25 * got[1] and got[2] <= 1.25 * got[3], got


@pytest.mark.parametrize("case", ["complex128 b", "non-contiguous b", "a CPU table"])
def test_hps_level_kernel_raises_on_card(dev, case):
    """The wrapper refuses what the kernel does not take, before a launch."""
    from fdtd2d_tpu_torch.fdfd import hps
    from fdtd2d_tpu_torch.ops import fdfd_hps

    plan = hps.build_plan(32, 32, 8)
    f = _random_hps_factors(plan, (4,), dev, seed=1)
    leaf, levels, Yroot = hps._sweep_operands(f, plan, dev)
    b = torch.randn(4, 3, 32 * 32, dtype=torch.complex64, device=dev)
    if case == "complex128 b":
        b = b.to(torch.complex128)
    elif case == "non-contiguous b":
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        leaf = (leaf[0], leaf[1], leaf[2].cpu())
    before = trace.counters()
    with pytest.raises(ValueError, match="complex64|contiguous|cpu"):
        fdfd_hps.hps_sweeps(leaf, levels, Yroot, b)
    assert trace.delta(before, "fdfd.kernels.hps_sweeps") == 0


def test_refused_hps_level_launch_raises(dev):
    """A plan that counts fewer items a CTA than a block meets: the C entry
    refuses it, the wrapper raises and counts nothing; the next call runs."""
    from fdtd2d_tpu_torch.fdfd import hps
    from fdtd2d_tpu_torch.ops import fdfd_hps

    plan = hps.build_plan(32, 32, 8)
    f = _random_hps_factors(plan, (4,), dev, seed=2)
    leaf, levels, Yroot = hps._sweep_operands(f, plan, dev)
    b = torch.randn(4, 16, 32 * 32, dtype=torch.complex64, device=dev)
    Y, E, table, order = levels[0]
    P, nJ, nR = E.shape[-3:]
    lp = fdfd_hps.plan_level(4 * P, nJ, nR, 16, False)
    assert lp.ni > 1
    child = torch.zeros(4, P * (nJ + nR), 16, dtype=torch.complex64, device=dev)
    parent = torch.empty(4, P, nR, 16, dtype=torch.complex64, device=dev)
    g = torch.empty(4, P, nJ, 16, dtype=torch.complex64, device=dev)
    space = fdfd_hps.Space(child.data_ptr(), child[0].numel(), 16, 1, 16)
    before = trace.counters()
    with pytest.raises(RuntimeError, match="refused"):
        fdfd_hps.launch(dataclasses.replace(lp, ni=1), Y, E, None, levels[1][3], space, parent,
                        g, P)
    assert trace.delta(before, "fdfd.kernels.hps_sweeps") == 0
    x = fdfd_hps.hps_sweeps(leaf, levels, Yroot, b)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(torch.view_as_real(x)).all())


@pytest.mark.parametrize("K", [1, 16])
def test_hps_level_layout_matches_planner_at_2048(dev, K):
    """Every launch of a 2048^2 solve: the built kernel asks for the shared
    memory that the planner counts on the device's own numbers, and an SM
    holds one of its CTAs."""
    from fdtd2d_tpu_torch.fdfd import hps
    from fdtd2d_tpu_torch.ops import fdfd_hps, fdtd_fused

    plan = hps.build_plan(1024, 1024, 8)
    sms, _, smem = fdtd_fused.device_numbers(dev)
    lf = plan.leaf
    dims = [(lf.n_boxes, len(lf.idx_I), len(lf.idx_R))] + [
        (mp.n_parents, len(mp.idx_J), len(mp.idx_R)) for mp in plan.merges]
    for P, nJ, nR in dims:
        for down in (False, True):
            lp = fdfd_hps.plan_level(4 * P, nJ, nR, fdfd_hps.kpad(K), down, sms, smem)
            assert fdfd_hps.ctas_an_sm(down, lp.kp, lp.tc, lp.ni, dev) >= 1
