"""K1 module (fdtd2d_tpu_torch.ops.fdtd_fused) on the CPU: its plain path and
the emulation of its resident tiling against the Pallas kernel run in
interpret mode and against each other, the resident planner, the layout
check, the launch counter, the input checks and the build's failure mode.
The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdtd import step as jax_step
from fdtd2d_tpu.ops.pallas_fdtd import fdtd_multistep_pallas
from fdtd2d_tpu_torch.fdtd.step import precompute_coefficients
from fdtd2d_tpu_torch.ops import _build, fdtd_fused

DT, DX, FC = 5e-14, 1e-4, 30e9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These grids gain nothing from intra-op threads, and in a parallel
    test run the threads of every worker oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coefficients(eps, mu):
    return precompute_coefficients(torch.from_numpy(eps), torch.from_numpy(mu),
                                   DT, DX, torch.float32)


def _zeros(rows, cols):
    return (torch.zeros(rows, cols), torch.zeros(rows, cols - 1),
            torch.zeros(rows - 1, cols))


@pytest.mark.parametrize("kind", ["ricker", "sinusoidal"])
def test_cpu_path_matches_pallas_interpret(kind):
    """The 48x64 case of tests/test_fdtd_pallas.py, from a random state."""
    _against_pallas_interpret(kind, None)


@pytest.mark.parametrize("kind", ["ricker", "sinusoidal"])
def test_resident_emulation_matches_pallas_interpret(kind):
    """The same case through the emulation of the resident tiling (2 x 2
    tiles, a one-cell ring exchanged a step)."""
    _against_pallas_interpret(kind, "resident")


def _against_pallas_interpret(kind, mode):
    rows, cols, nsteps = 48, 64, 30
    rng = np.random.default_rng(0)
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[20:30, 40:50] *= 3.0
    mu = np.full((rows, cols), constants.MU_0)
    state = [rng.standard_normal(s).astype(np.float32)
             for s in ((rows, cols), (rows, cols - 1), (rows - 1, cols))]

    jce, jch, jcoef = jax_step.precompute_coefficients(eps, mu, DT, DX, jnp.float32)
    ref = fdtd_multistep_pallas(*(jnp.asarray(a) for a in state), jce, jch, jcoef,
                                DT, FC, rows // 2, cols // 2, nsteps, kind, 0,
                                interpret=True)
    ce, ch, coef = _coefficients(eps, mu)
    ours = fdtd_fused.fdtd_multistep_fused(
        *(torch.from_numpy(a) for a in state), ce, ch, coef, DT, FC,
        rows // 2, cols // 2, nsteps, kind, 0, mode=mode)
    for o, r in zip(ours, ref):
        r = np.asarray(r, np.float64)
        assert tuple(o.shape) == r.shape  # staggered shapes kept
        err = np.max(np.abs(o.double().numpy() - r)) / np.max(np.abs(r))
        assert err < 1e-5, f"relative error {err:.3e}"


def _random_case(rows, cols, start, seed=3):
    """A seeded random medium with its float32 coefficients, and a state."""
    rng = np.random.default_rng(seed)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    if start == "zero":
        return _coefficients(eps, mu), _zeros(rows, cols)
    return _coefficients(eps, mu), tuple(
        torch.from_numpy((rng.standard_normal(shape) / scale).astype(np.float32))
        for shape, scale in (((rows, cols), 1.0), ((rows, cols - 1), 376.73),
                             ((rows - 1, cols), 376.73)))


@pytest.mark.parametrize("start", ["zero", "random"])
@pytest.mark.parametrize("kind", ["ricker", "sinusoidal"])
@pytest.mark.parametrize("shape,tiles", [
    ((16, 16), None), ((37, 53), None), ((203, 157), None), ((203, 157), (9, 7)),
    ((400, 360), None)], ids=["16", "37x53", "203x157", "203x157-9x7", "400x360"])
def test_resident_emulation_equals_plain_step(shape, tiles, kind, start):
    """The emulation of the resident tiling (tiles from the planner, or a
    forced 9 x 7 grid whose seams cross every Mur band; a one-cell Ez ring
    exchanged a step; Hx and Hy of the ring recomputed, never exchanged)
    equals the plain step bit for bit, as one call and as two chunks. The
    Ricker source sits in the bottom right corner region, the sinusoidal one
    at the centre."""
    rows, cols = shape
    (ce, ch, coef), state = _random_case(rows, cols, start)
    sx, sy = (rows - 3, cols - 2) if kind == "ricker" else (rows // 2, cols // 2)
    nsteps, split = 14, 5

    def run(fn, fields, n, offset, **kw):
        return fn(*fields, ce, ch, coef, DT, FC, sx, sy, n, kind, offset, **kw)

    plain = run(fdtd_fused.fdtd_multistep_fused_reference, state, nsteps, 0)
    resident = dict(mode="resident", tiles=tiles)
    one = run(fdtd_fused.fdtd_multistep_fused, state, nsteps, 0, **resident)
    two = run(fdtd_fused.fdtd_multistep_fused, state, split, 0, **resident)
    two = run(fdtd_fused.fdtd_multistep_fused, two, nsteps - split, split, **resident)
    assert float(plain[0].abs().max()) > 0.0
    for p, a, b in zip(plain, one, two):
        assert a.shape == p.shape and torch.equal(a, p) and torch.equal(b, p)


H100_SHAPES = [(16, 16), (128, 128), (200, 200), (256, 256), (512, 512), (768, 768),
               (1024, 1024), (1034, 1034), (203, 157), (37, 530), (16, 1500)]


@pytest.mark.parametrize("shape", H100_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resident_planner_with_the_h100s_numbers(shape):
    """From the grid and the device's numbers (132 SMs, 65,536 registers an
    SM, 232,448 B of shared memory a block) to a tile grid: at least two
    tiles each way, every tile owns at least 6 cells a side, every window
    (a tile and its ring) fits the variant's, and no more blocks than the
    card holds resident at once."""
    N, M = shape
    plan = fdtd_fused.plan_resident(N, M, *fdtd_fused.H100)
    WH, WW = plan.variant.window
    assert plan.nth >= 2 and plan.ntw >= 2
    assert plan.blocks <= fdtd_fused.coresident_blocks(plan.variant, *fdtd_fused.H100) <= 132
    for n, nt, extent in ((N, plan.nth, WH), (M, plan.ntw, WW)):
        bounds = fdtd_fused.tile_bounds(n, nt)
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert min(hi - lo for lo, hi in bounds) >= fdtd_fused.S == 6
        ringed = [(hi - lo) + (t > 0) + (t < nt - 1) for t, (lo, hi) in enumerate(bounds)]
        assert max(ringed) <= fdtd_fused.window_extent(n, nt) <= extent
    # the fastest variant that holds the grid: no earlier one admits it
    for earlier in fdtd_fused.VARIANTS[: plan.variant.index]:
        nth = next((nt for nt in range(2, N // 6 + 1)
                    if fdtd_fused.window_extent(N, nt) <= earlier.window[0]), N)
        ntw = next((nt for nt in range(2, M // 6 + 1)
                    if fdtd_fused.window_extent(M, nt) <= earlier.window[1]), M)
        with pytest.raises(ValueError):
            fdtd_fused.check_resident_plan(N, M, fdtd_fused.ResidentPlan(earlier, nth, ntw),
                                           *fdtd_fused.H100)


@pytest.mark.parametrize("shape,tiles,numbers,match", [
    ((1035, 1035), None, fdtd_fused.H100, "beyond the resident mode"),
    ((2048, 2048), None, fdtd_fused.H100, "beyond the resident mode"),
    ((16, 300000), None, fdtd_fused.H100, "beyond the resident mode"),
    ((512, 512), None, (20, 65_536, 232_448), "beyond the resident mode"),  # a small card
    ((512, 512), None, (132, 32_768, 232_448), "beyond the resident mode"),  # no block fits
    ((12, 64), None, fdtd_fused.H100, "smaller than 16"),
    ((64, 64), (1, 2), fdtd_fused.H100, "at least two tiles"),
    ((64, 64), (11, 2), fdtd_fused.H100, "at least 6 cells"),  # 64 // 11 = 5
    ((203, 157), (2, 2), fdtd_fused.H100, "exceed the"),        # 102-row tiles
])
def test_resident_planner_raises(shape, tiles, numbers, match):
    with pytest.raises(ValueError, match=match):
        fdtd_fused.plan_resident(*shape, *numbers, tiles)


def test_resident_limit_on_an_h100():
    """The largest square the resident mode admits on an H100: the size that
    simulate's "auto" rule and chip_smoke.py's main path turn on."""
    admitted = [n for n in range(1000, 1100) if _admitted(n)]
    assert admitted == list(range(1000, 1035))


def _admitted(n):
    try:
        fdtd_fused.plan_resident(n, n, *fdtd_fused.H100)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("variant", fdtd_fused.VARIANTS, ids=lambda v: f"variant{v.index}")
@pytest.mark.parametrize("off", [None, 0, 1, 2, 3, 4, 5, 6],
                         ids=["agrees", "static", "dynamic", "rows", "columns", "threads",
                              "registers", "resident blocks"])
def test_layout_check_against_the_kernel(monkeypatch, variant, off):
    """Every resident launch first holds the planner's copy of the kernel's
    layout to what the built library reports (fdtd_fused_resident_layout:
    static and dynamic shared memory, window rows and columns, threads,
    registers a thread, blocks the device holds resident); a library that
    differs in any of them raises before a launch. The library is faked
    here: the real one is held to the planner on the card
    (tests/test_torch_cuda.py)."""
    device = torch.device("cuda", 0)

    class Lib:
        def fdtd_device_numbers(self, out):
            out[:] = fdtd_fused.H100
            return 0

        def fdtd_fused_resident_layout(self, v, out):
            assert v == variant.index
            out[:] = (variant.static_smem, variant.dynamic_smem, *variant.window,
                      variant.threads, variant.registers,
                      fdtd_fused.coresident_blocks(variant, *fdtd_fused.H100))
            if off is not None:
                out[off] += 1
            return 0

    monkeypatch.setattr(fdtd_fused._build, "load", Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    caches = (fdtd_fused._check_layout, fdtd_fused.device_numbers)
    for cache in caches:
        cache.cache_clear()
    try:
        if off is None:
            fdtd_fused._check_layout(variant, device)
        else:
            with pytest.raises(RuntimeError, match="the planner's"):
                fdtd_fused._check_layout(variant, device)
    finally:
        for cache in caches:
            cache.cache_clear()


def test_variants_fit_an_sm():
    """Each variant's registers and shared memory fit one block an SM of an
    H100, and the three are ordered by the cells a window holds."""
    sms, registers, smem = fdtd_fused.H100
    for v in fdtd_fused.VARIANTS:
        assert v.threads * v.registers <= registers and v.threads <= 1024
        assert v.static_smem + v.dynamic_smem <= smem
        assert fdtd_fused.coresident_blocks(v, *fdtd_fused.H100) == sms
    cells = [v.window[0] * v.window[1] for v in fdtd_fused.VARIANTS]
    assert cells == sorted(cells)


@pytest.mark.parametrize("mode", [None, "resident", "streaming"])
def test_advance_padded_equals_the_staggered_entry(mode):
    """advance_padded takes and returns the padded layout, with the phantom
    cells zero, and computes what fdtd_multistep_fused does."""
    rows, cols = 33, 41
    (ce, ch, coef), state = _random_case(rows, cols, "random")
    args = (coef, DT, FC, 30, 38, 9, "ricker", 4)
    want = fdtd_fused.fdtd_multistep_fused(*state, ce, ch, *args, mode=mode)
    padded = fdtd_fused.pad_state(*state)
    got = fdtd_fused.advance_padded(*padded, ce, fdtd_fused.pad_field(ch, rows, cols), *args,
                                    mode=mode)
    assert all(tuple(g.shape) == (rows, cols) and g.is_contiguous() for g in got)
    assert not got[1][:, -1].any() and not got[2][-1].any()
    for g, w in zip(fdtd_fused.unpad_state(*got), want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unknown K1 mode"):
        fdtd_fused.fdtd_multistep_fused(*state, ce, ch, *args, mode="banded")


def test_chunked_offsets_match_single_run():
    """Two chunks with a step offset == one contiguous run (source timing)."""
    rows = cols = 32
    eps = np.full((rows, cols), constants.EPSILON_0)
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = _coefficients(eps, mu)
    run = fdtd_fused.fdtd_multistep_fused
    a = run(*_zeros(rows, cols), ce, ch, coef, DT, FC, 16, 16, 20, "ricker", 0)
    b = run(*_zeros(rows, cols), ce, ch, coef, DT, FC, 16, 16, 10, "ricker", 0)
    b = run(*b, ce, ch, coef, DT, FC, 16, 16, 10, "ricker", 10)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_cpu_tensors_launch_nothing_and_are_not_modified():
    rows, cols = 24, 20
    rng = np.random.default_rng(1)
    eps = np.full((rows, cols), constants.EPSILON_0)
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = _coefficients(eps, mu)
    fields = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
              for t in _zeros(rows, cols)]
    before = [f.clone() for f in fields]
    launches = fdtd_fused.launches
    out = fdtd_fused.fdtd_multistep_fused(*fields, ce, ch, coef, DT, FC, 5, 7,
                                          8, "sinusoidal", 3)
    assert fdtd_fused.launches == launches == 0
    for f, b, o in zip(fields, before, out):
        assert torch.equal(f, b) and not torch.equal(o, b)


def test_pad_unpad_roundtrip():
    Ez, Hx, Hy = (torch.randn(s, generator=torch.Generator().manual_seed(2))
                  for s in ((9, 11), (9, 10), (8, 11)))
    padded = fdtd_fused.pad_state(Ez, Hx, Hy)
    assert all(tuple(p.shape) == (9, 11) and p.is_contiguous() for p in padded)
    assert not padded[1][:, -1].any() and not padded[2][-1].any()
    for a, b in zip(fdtd_fused.unpad_state(*padded), (Ez, Hx, Hy)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,match", [
    ("float64", "float32 only"),
    ("shape", "Hx has shape"),
    ("small", "smaller than 16"),
    ("source", "outside the grid"),
    ("huge", "32-bit"),
])
def test_kernel_input_checks_raise(case, match):
    N, M = 20, 18
    fields = list(_zeros(N, M))
    ce, ch = torch.ones(N, M), torch.ones(N - 1, M - 1)
    sx, sy = 3, 4
    if case == "float64":
        ce = ce.double()
    elif case == "shape":
        fields[1] = torch.zeros(N, M - 2)
    elif case == "small":
        fields, ce, ch = list(_zeros(12, M)), torch.ones(12, M), torch.ones(11, M - 1)
    elif case == "source":
        sx = N
    elif case == "huge":  # 46341^2 > 2^31 cells, as expanded views of one element
        n = 46341
        fields = [torch.zeros(1, 1).expand(*s) for s in ((n, n), (n, n - 1), (n - 1, n))]
        ce, ch = torch.ones(1, 1).expand(n, n), torch.ones(1, 1).expand(n - 1, n - 1)
    with pytest.raises(ValueError, match=match):
        fdtd_fused.check_kernel_inputs(*fields, ce, ch, sx, sy, 10)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert _build._lib is None
