"""K1, K2 and K3 mode on the card: the CUDA kernels against their plain
versions; and the FDFD solvers on the card against complex128 on the CPU.

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

DT, DX, FC = 5e-14, 1e-4, 30e9
Z0 = 376.73  # vacuum impedance: scales the random H to the random Ez

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


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
    """An odd grid with a random medium, one run and two chunks. The float64
    plain run takes the kernel's float32 coefficients and state; the kernel
    differs from it by float32 rounding (FMA contraction, expf) only.

    From a zero state the wave spreads about 18 cells in 120 steps, which
    checks the source but leaves most of the Mur bands near zero. The random
    state puts a field in every band and corner (asserted to be at least
    1e-3 of max |Ez|, so that a wrong value there is about 100 times the
    tolerance) and in the cells the step never writes."""
    rows, cols = 61, 47
    nsteps = 120 if start == "zero" else 60
    rng = np.random.default_rng(0)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = precompute_coefficients(torch.tensor(eps, device=dev),
                                           torch.tensor(mu, device=dev), DT, DX)
    if start == "zero":
        state = grid_init(rows, cols, torch.float32, dev)
    else:
        state = tuple(torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                   device=dev) / scale
                      for shape, scale in (((rows, cols), 1.0), ((rows, cols - 1), Z0),
                                           ((rows - 1, cols), Z0)))

    before = fdtd_fused.launches
    one = fdtd_fused.fdtd_multistep_fused(*state, ce, ch, coef, DT, FC,
                                          *source, nsteps, kind, 0)
    two = fdtd_fused.fdtd_multistep_fused(*state, ce, ch, coef, DT, FC,
                                          *source, 25, kind, 0)
    two = fdtd_fused.fdtd_multistep_fused(*two, ce, ch, coef, DT, FC, *source,
                                          nsteps - 25, kind, 25)
    plain = fdtd_fused.fdtd_multistep_fused_reference(
        *(f.double() for f in state), ce.double(), ch.double(), coef.double(), DT, FC,
        *source, nsteps, kind, 0)
    torch.cuda.synchronize()
    assert fdtd_fused.launches - before == 3 * 2 * nsteps
    if start == "random":
        assert boundary_cover(plain[0]) >= 1e-3
    for k, c, p in zip(one, two, plain):
        assert k.shape == p.shape and torch.equal(k, c)
        err = float((k.double() - p).abs().max() / p.abs().max())
        assert err <= 1e-5, f"relative error {err:.3e}"


def test_simulate_auto_uses_kernel(dev):
    N = 64
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=40, source_xy=(20, 33), source_fc=FC,
                     nframes=4, device="cuda")
    before = fdtd_fused.launches
    (Ez, Hx, Hy), snaps = simulate(eps, mu, cfg)
    assert fdtd_fused.launches - before == 3 * 40
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
    before = fdtd_fused.launches
    with pytest.raises(ValueError):
        fdtd_fused.fdtd_multistep_fused(Ez, Hx, Hy, ce, ch, 0.5, DT, FC, 16, 16, 5,
                                        "ricker", 0)
    assert fdtd_fused.launches == before


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
    module = fdtd_ttiled if mode == "K2" else fdtd_blocked

    def run(fields, n, offset):
        if mode == "K2":
            return fdtd_ttiled.fdtd_multistep_ttiled(*fields, ce, ch, coef, DT, FC, *source,
                                                     n, kind, offset, K=K, tile=tile)
        return fdtd_blocked.fdtd_multistep_blocked(*fields, ce, ch, coef, DT, FC, *source,
                                                   n, kind, offset, tile=tile)

    before = module.launches
    one = run(state, nsteps, 0)
    two = run(run(state, 25, 0), nsteps - 25, 25)
    torch.cuda.synchronize()
    sweeps = lambda n: -(-n // K)  # noqa: E731
    assert module.launches - before == sweeps(nsteps) + sweeps(25) + sweeps(nsteps - 25)
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


def test_simulate_ttiled_uses_kernel(dev):
    N = 64
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=40, source_xy=(20, 33), source_fc=FC,
                     nframes=4, backend="ttiled", device="cuda")
    K, _, _ = fdtd_ttiled.pick_sweep_depth(N, N)
    before = fdtd_ttiled.launches
    (Ez, Hx, Hy), snaps = simulate(eps, mu, cfg)
    assert fdtd_ttiled.launches - before == 4 * -(-10 // K)
    plain, plain_snaps = simulate(eps, mu, dataclasses.replace(cfg, backend="torch",
                                                               dtype=torch.float64))
    for k, p in zip((Ez, Hx, Hy, snaps), (*plain, plain_snaps)):
        assert float((k.double() - p).abs().max() / p.abs().max()) <= 1e-5


def test_tiled_kernel_raises_on_float64(dev):
    N = 32
    Ez, Hx, Hy = (torch.zeros(s, device=dev, dtype=torch.float64)
                  for s in ((N, N), (N, N - 1), (N - 1, N)))
    ce, ch = (torch.ones(s, device=dev, dtype=torch.float64) for s in ((N, N), (N - 1, N - 1)))
    before = fdtd_ttiled.launches, fdtd_blocked.launches
    with pytest.raises(ValueError, match="float32 only"):
        fdtd_ttiled.fdtd_multistep_ttiled(Ez, Hx, Hy, ce, ch, 0.5, DT, FC, 16, 16, 5,
                                          "ricker", 0)
    with pytest.raises(ValueError, match="float32 only"):
        fdtd_blocked.fdtd_multistep_blocked(Ez, Hx, Hy, ce, ch, 0.5, DT, FC, 16, 16, 5,
                                            "ricker", 0)
    assert (fdtd_ttiled.launches, fdtd_blocked.launches) == before


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
    op = make_operator(eps, mu, dx, dx, omega, dtype=torch.complex128)
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
                                      dtype=torch.complex128), torch.as_tensor(b))
    assert float((res.x.cpu().to(torch.complex128) - want).abs().max()
                 / want.abs().max()) <= 1e-4
