"""K2 and K3 modules (fdtd2d_tpu_torch.ops.fdtd_ttiled, .fdtd_blocked) on the
CPU: the tile emulation against the port's plain step, the JAX kernels run in
interpret mode and the NumPy oracle; the planner; resolve_backend against the
JAX package's. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.fdtd import step as jax_step
from fdtd2d_tpu.fdtd.reference import numpy_simulate
from fdtd2d_tpu.fdtd.simulate import FDTDConfig as JaxConfig
from fdtd2d_tpu.fdtd.simulate import resolve_backend as jax_resolve_backend
from fdtd2d_tpu.fdtd.simulate import simulate as jax_simulate
from fdtd2d_tpu.ops.pallas_fdtd_blocked import fdtd_multistep_blocked as jax_blocked
from fdtd2d_tpu.ops.pallas_fdtd_ttiled import fdtd_multistep_ttiled as jax_ttiled
from fdtd2d_tpu_torch.fdtd.simulate import resolve_backend
from fdtd2d_tpu_torch.fdtd.step import MUR_BAND, precompute_coefficients
from fdtd2d_tpu_torch.ops import fdtd_blocked, fdtd_fused, fdtd_ttiled
from fdtd2d_tpu_torch.ops.fdtd_ttiled import S

DT, DX, FC = 5e-14, 1e-4, 30e9
Z0 = 376.73  # vacuum impedance: scales the random H to the random Ez


def _rel(ours, ref):
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(ours.double().numpy() - ref)) / np.max(np.abs(ref))


def _random_state(rng, rows, cols):
    return [(rng.standard_normal(shape) / scale).astype(np.float32)
            for shape, scale in (((rows, cols), 1.0), ((rows, cols - 1), Z0),
                                 ((rows - 1, cols), Z0))]


def _zero_state(rows, cols):
    return [np.zeros(s, np.float32) for s in ((rows, cols), (rows, cols - 1),
                                              (rows - 1, cols))]


def _coefficients(eps, mu):
    return precompute_coefficients(torch.from_numpy(eps), torch.from_numpy(mu),
                                   DT, DX, torch.float32)


def _block_scene(rows, cols):
    """The scene of tests/test_fdtd_ttiled.py and test_fdtd_blocked.py."""
    eps = np.full((rows, cols), constants.EPSILON_0)
    eps[20:40, 50:70] *= 3.0
    return eps, np.full((rows, cols), constants.MU_0)


def boundary_cover(Ez, b=MUR_BAND):
    """Smallest max |Ez| over the four Mur bands and the four corners,
    relative to max |Ez| over the grid."""
    parts = (Ez[b:-b, :b], Ez[b:-b, -b:], Ez[:b, b:-b], Ez[-b:, b:-b],
             Ez[:b, :b], Ez[:b, -b:], Ez[-b:, :b], Ez[-b:, -b:])
    return float(min(p.abs().max() for p in parts) / Ez.abs().max())


# A 42x54 grid: 7x9 and 6x6 tiles divide it; 9x8 and 12x16 leave 6-cell
# last tiles. With 7x9 tiles at K=8 (and 9x8 at K=3, 7 - 3 < 6) windows of
# non-edge tiles start at the domain edge and hold band cells. Source rows
# and columns: (19, 25) lies in the overlap of 9x8 tiles' halos at K=3
# (owned by tile (2, 3), in the halo of (1, 2)); (2, 51) and (40, 1) are in
# corner tiles.
EMULATION_CASES = {
    "K1-7x9-divides-random-centre": (1, (7, 9), "random", (21, 27)),
    "K3-9x8-ragged-random-halo-overlap": (3, (9, 8), "random", (19, 25)),
    "K8-7x9-band-in-halo-random-corner-tile": (8, (7, 9), "random", (2, 51)),
    "K8-12x16-ragged-zero-corner-tile": (8, (12, 16), "zero", (40, 1)),
    "K3-one-tile-zero": (3, (42, 54), "zero", (21, 27)),
    "K1-6x6-smallest-tiles-random": (1, (6, 6), "random", (5, 5)),
}


@pytest.mark.parametrize("case", list(EMULATION_CASES))
def test_emulation_equals_plain_step(case):
    """The tile emulation against the port's plain multistep, float32: equal
    bit for bit (each owned cell's value comes from the same expression on
    the same inputs). 19 steps from step 3: K = 3 and K = 8 leave a short
    last sweep. The random states put a field in every band and corner
    (asserted >= 1e-3 of max |Ez|)."""
    K, tile, start, (sx, sy) = EMULATION_CASES[case]
    rows, cols, nsteps = 42, 54, 19
    rng = np.random.default_rng(3)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = _coefficients(eps, mu)
    state = _random_state(rng, rows, cols) if start == "random" else _zero_state(rows, cols)
    state = [torch.from_numpy(a) for a in state]
    kind = "sinusoidal" if K == 3 else "ricker"
    plain = fdtd_fused.fdtd_multistep_fused_reference(*state, ce, ch, coef, DT, FC,
                                                      sx, sy, nsteps, kind, 3)
    emu = fdtd_ttiled.fdtd_multistep_ttiled_reference(*state, ce, ch, coef, DT, FC,
                                                      sx, sy, nsteps, kind, 3, K, tile)
    if start == "random":
        assert boundary_cover(plain[0]) >= 1e-3
    for e, p in zip(emu, plain):
        assert e.shape == p.shape and torch.equal(e, p)


@pytest.mark.parametrize("nsteps,src", [(24, (32, 64)), (16, (17, 64))],
                         ids=["multisweep", "source-in-halo"])
def test_matches_jax_ttiled_interpret(nsteps, src):
    """The multisweep and source-in-halo cases of tests/test_fdtd_ttiled.py
    (64x128, K = 8, PH = 16, zero state) against the JAX kernel in interpret
    mode, all three fields within 1e-5 relative. The port tiles 16x32."""
    rows, cols = 64, 128
    eps, mu = _block_scene(rows, cols)
    jce, jch, jcoef = jax_step.precompute_coefficients(eps, mu, DT, DX, jnp.float32)
    state = _zero_state(rows, cols)
    ref = jax_ttiled(*(jnp.asarray(a) for a in state), jce, jch, jcoef, DT, FC,
                     *src, nsteps, "ricker", 0, K=8, PH=16, interpret=True)
    ce, ch, coef = _coefficients(eps, mu)
    ours = fdtd_ttiled.fdtd_multistep_ttiled(*(torch.from_numpy(a) for a in state),
                                             ce, ch, coef, DT, FC, *src, nsteps,
                                             "ricker", 0, K=8, tile=(16, 32))
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        assert _rel(o, r) < 1e-5


def test_blocked_matches_jax_blocked_interpret():
    """The 64x128, 25-step case of tests/test_fdtd_blocked.py: the port's K3
    (the K = 1 emulation on the CPU) against the JAX kernel in interpret
    mode, all three fields within 1e-5 relative."""
    rows, cols, nsteps = 64, 128, 25
    eps, mu = _block_scene(rows, cols)
    jce, jch, jcoef = jax_step.precompute_coefficients(eps, mu, DT, DX, jnp.float32)
    state = _zero_state(rows, cols)
    ref = jax_blocked(*(jnp.asarray(a) for a in state), jce, jch, jcoef, DT, FC,
                      rows // 2, cols // 2, nsteps, "ricker", 0, PH=16, interpret=True)
    ce, ch, coef = _coefficients(eps, mu)
    before = fdtd_blocked.launches
    ours = fdtd_blocked.fdtd_multistep_blocked(*(torch.from_numpy(a) for a in state),
                                               ce, ch, coef, DT, FC, rows // 2,
                                               cols // 2, nsteps, "ricker", 0, PH=16)
    assert fdtd_blocked.launches == before  # CPU tensors launch nothing
    for o, r in zip(ours, ref):
        assert tuple(o.shape) == r.shape
        assert _rel(o, r) < 1e-5


@pytest.mark.parametrize("rows,nsteps,src", [(72, 24, (36, 64)), (64, 16, (7, 9))],
                         ids=["padded-rows", "near-boundary"])
def test_matches_numpy_oracle(rows, nsteps, src):
    """The padded-rows (72 rows: not a multiple of the JAX panel) and
    near-boundary cases of tests/test_fdtd_ttiled.py against the float64
    NumPy oracle at 1e-5, with 16x32 tiles at K = 8 (72 % 16 = 8 >= S)."""
    cols = 128
    eps, mu = _block_scene(rows, cols)
    ce, ch, coef = _coefficients(eps, mu)
    Ez, Hx, Hy = fdtd_ttiled.fdtd_multistep_ttiled(
        *(torch.from_numpy(a) for a in _zero_state(rows, cols)), ce, ch, coef, DT,
        FC, *src, nsteps, "ricker", 0, K=8, tile=(16, 32))
    ref = numpy_simulate(eps, mu, DT, DX, nsteps, src, FC)
    assert _rel(Ez, ref) < 1e-5
    assert tuple(Hx.shape) == (rows, cols - 1) and tuple(Hy.shape) == (rows - 1, cols)


def test_records_jax_band_in_halo_fault():
    """Reference behaviour the parity tests must not treat as truth (ROADMAP
    Queue 3). The JAX K2 applies the top Mur band only in panel 0 and the
    bottom band only in the last panel; at 72x64, K = 8, PH = 16 the last
    panel is 8 rows (BOT < GH + 5), so the penultimate panel's halo holds
    bottom-band rows that it steps as interior cells, and the error walks
    into its own rows. From a random state (a zero state never brings a
    field to the band) the JAX kernel misses the JAX plain step by more
    than 1e-6 relative, while the port's emulation at the same K and panel
    height equals the port's plain step bit for bit."""
    rows, cols, nsteps = 72, 64, 8
    rng = np.random.default_rng(0)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    state = _random_state(rng, rows, cols)
    src = (rows // 2, cols // 2)
    jce, jch, jcoef = jax_step.precompute_coefficients(eps, mu, DT, DX, jnp.float32)
    jax_kernel = jax_ttiled(*(jnp.asarray(a) for a in state), jce, jch, jcoef, DT, FC,
                            *src, nsteps, "ricker", 0, K=8, PH=16, interpret=True)
    jax_plain, _ = jax_simulate(eps, mu, JaxConfig(dt=DT, dx=DX, nsteps=nsteps,
                                                   source_xy=src, source_fc=FC,
                                                   backend="jax"),
                                state=[jnp.asarray(a) for a in state])
    jax_err = max(np.max(np.abs(np.asarray(k, np.float64) - np.asarray(p, np.float64)))
                  / np.max(np.abs(np.asarray(p, np.float64)))
                  for k, p in zip(jax_kernel, jax_plain))
    assert jax_err > 1e-6

    ce, ch, coef = _coefficients(eps, mu)
    fields = [torch.from_numpy(a) for a in state]
    ours = fdtd_ttiled.fdtd_multistep_ttiled(*fields, ce, ch, coef, DT, FC, *src,
                                             nsteps, "ricker", 0, K=8, tile=(16, cols))
    plain = fdtd_fused.fdtd_multistep_fused_reference(*fields, ce, ch, coef, DT, FC,
                                                      *src, nsteps, "ricker", 0)
    for o, p, j in zip(ours, plain, jax_plain):
        assert torch.equal(o, p)
        assert _rel(o, j) < 1e-6


SHAPES = [(4096, 4096), (8192, 8192), (2305, 2305), (4104, 4096), (3001, 4999),
          (203, 157), (72, 64), (64, 128), (16, 16), (17, 9000)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{n}x{m}" for n, m in SHAPES])
def test_planner_admits_and_fits(shape):
    """The planner's tiling fits the kernel's budget: the dynamic shared
    memory (the edge body's staged window, or the interior window copied in
    ahead) plus the static exchange buffers fit the 227 KB a block may use,
    one 480-thread block an SM; interior windows fit the register body's
    80 x 96 cells. Every tile owns >= S cells a side, every window covers its
    tile plus a halo of K (clipped at the domain) and starts and ends at the
    domain edge or >= S cells inside it, and the redundant compute stays
    within the cap."""
    N, M = shape
    K, TH, TW = fdtd_ttiled.pick_sweep_depth(N, M)
    assert K in fdtd_ttiled.DEPTHS
    WH, WW = fdtd_ttiled.window_extent(N, TH, K), fdtd_ttiled.window_extent(M, TW, K)
    assert fdtd_ttiled.smem_bytes(WH, WW) <= fdtd_ttiled.SMEM_BUDGET
    assert fdtd_ttiled.SMEM_BUDGET + fdtd_ttiled.STATIC_SMEM_BYTES == fdtd_ttiled.SMEM_LIMIT
    if fdtd_ttiled.interior_tiles(N, M, K, TH, TW):
        assert TH + 2 * K <= fdtd_ttiled.WINDOW[0] and TW + 2 * K <= fdtd_ttiled.WINDOW[1]
    assert fdtd_ttiled.redundancy(N, M, K, TH, TW) <= fdtd_ttiled.MAX_REDUNDANCY
    for n, T in ((N, TH), (M, TW)):
        spans = fdtd_ttiled.tile_spans(n, T, K)
        assert spans[0][0] == 0 and spans[-1][1] == n
        for (o0, o1, w0, w1), nxt in zip(spans, spans[1:] + [(n,)]):
            assert o1 == nxt[0] and o1 - o0 >= min(S, n)
            assert w0 <= max(o0 - K, 0) and w1 >= min(o1 + K, n)
            assert w0 == 0 or w0 >= S
            assert w1 == n or w1 <= n - S
    if shape in ((4096, 4096), (8192, 8192)):
        assert (K, TH, TW) == (8, 64, 80)  # the shape fdtd_ttiled.cu's header bounds


# (shape, K, tile); None takes the planner's choice. Forced cases: the
# smoke's 203x157 7x10 tiles at K = 7 (interior windows of 21x24 between
# seams), one tile (no interior), 6x6 tiles at K = 1.
ORDER_CASES = [((4096, 4096), None, None), ((8192, 8192), None, None),
               ((2048, 2048), 1, None), ((400, 360), None, None),
               ((203, 157), 7, (7, 10)), ((42, 54), 3, (42, 54)),
               ((42, 54), 1, (6, 6)), ((3001, 4999), None, None)]


@pytest.mark.parametrize("shape,K,tile", ORDER_CASES,
                         ids=[f"{n}x{m}-K{K}-{t}" for (n, m), K, t in ORDER_CASES])
def test_tile_order_classifies_every_tile_once(shape, K, tile):
    """The list the kernel's persistent blocks walk holds every tile exactly
    once, the edge tiles first. An interior tile's window lies >= S cells
    inside the domain on all four sides, so it holds no Mur band cell, no
    corner cell and no cell of a pre-step strip, and every cell has
    1 <= i < N-1, 1 <= j < M-1; every edge tile's window reaches the domain's
    edge on some side. The planner's grids of 400x360 and up have interior
    tiles (4096^2: 3,328 tiles, 3,100 interior)."""
    N, M = shape
    K, TH, TW = fdtd_ttiled.resolve_plan(N, M, K, tile)
    order, n_edge = fdtd_ttiled.tile_order(N, M, K, TH, TW)
    rows, cols = fdtd_ttiled.tile_spans(N, TH, K), fdtd_ttiled.tile_spans(M, TW, K)
    assert sorted(order) == [(a, b) for a in range(len(rows)) for b in range(len(cols))]
    assert len(order) - n_edge == fdtd_ttiled.interior_tiles(N, M, K, TH, TW)
    for t, (a, b) in enumerate(order):
        (_, _, r0, r1), (_, _, c0, c1) = rows[a], cols[b]
        inside = S <= r0 and r1 <= N - S and S <= c0 and c1 <= M - S
        assert inside == (t >= n_edge)
        if inside:
            assert MUR_BAND < r0 and r1 < N - MUR_BAND and MUR_BAND < c0 and c1 < M - MUR_BAND
        else:
            assert r0 == 0 or r1 == N or c0 == 0 or c1 == M
    if min(N, M) >= 400:
        assert len(order) - n_edge > 0
    if shape == (4096, 4096):
        assert (len(order), len(order) - n_edge) == (3328, 3100)


def test_emulation_follows_the_kernel_plan():
    """The emulation at the planner's plan on a 400x360 grid, where 15 of 35
    tiles are interior with seams between them, equals the plain step bit
    for bit from a random state over two sweeps and a short one, in the
    kernel's tile order."""
    rows, cols, nsteps = 400, 360, 19
    K, TH, TW = fdtd_ttiled.pick_sweep_depth(rows, cols)
    order, n_edge = fdtd_ttiled.tile_order(rows, cols, K, TH, TW)
    assert (K, len(order), len(order) - n_edge) == (8, 35, 15)
    rng = np.random.default_rng(4)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = _coefficients(eps, mu)
    state = [torch.from_numpy(a) for a in _random_state(rng, rows, cols)]
    src = (rows // 2, cols // 2)
    plain = fdtd_fused.fdtd_multistep_fused_reference(*state, ce, ch, coef, DT, FC, *src,
                                                      nsteps, "ricker", 5)
    emu = fdtd_ttiled.fdtd_multistep_ttiled(*state, ce, ch, coef, DT, FC, *src, nsteps,
                                            "ricker", 5)
    for e, p in zip(emu, plain):
        assert e.shape == p.shape and torch.equal(e, p)


@pytest.mark.parametrize("shape,K,tile,match", [
    ((42, 54), 0, (7, 9), "K must be >= 1"),
    ((42, 54), 2, (5, 9), "at least 6"),
    ((42, 54), 2, (8, 9), "at least 6"),         # 42 % 8 = 2: a 2-row last tile
    ((400, 540), 2, (400, 540), "shared memory"),  # one window of the whole grid
    ((65_536, 32_768), 1, (80, 96), "32-bit"),     # 2^31 cells
    ((400, 360), 6, (70, 84), "register body"),    # 82-row interior windows
])
def test_check_plan_raises(shape, K, tile, match):
    with pytest.raises(ValueError, match=match):
        fdtd_ttiled.check_plan(*shape, K, *tile)


@pytest.mark.parametrize("off", [(0, 0, 0, 0), (16, 0, 0, 0), (0, 4, 0, 0), (0, 0, 16, 0),
                                 (0, 0, 0, 32)],
                         ids=["agrees", "static", "dynamic", "rows", "columns"])
def test_layout_check_against_the_kernel(monkeypatch, off):
    """Every launch first holds the planner's copy of the kernel's layout to
    what the built library reports (fdtd_ttiled_layout: static and dynamic
    shared memory, interior window rows and columns); a library that differs
    in any of them raises before a launch. The library is faked here: the
    real one is held to the planner on the card (tests/test_torch_cuda.py)."""
    WH, WW = 80, 96

    class Lib:
        def fdtd_ttiled_layout(self, wh, ww, out):
            planned = (fdtd_ttiled.STATIC_SMEM_BYTES, fdtd_ttiled.smem_bytes(wh, ww),
                       *fdtd_ttiled.WINDOW)
            for i, (v, d) in enumerate(zip(planned, off)):
                out[i] = v + d
            return 0

    monkeypatch.setattr(fdtd_ttiled._build, "load", Lib)
    fdtd_ttiled._check_layout.cache_clear()
    try:
        if any(off):
            with pytest.raises(RuntimeError, match="the planner's"):
                fdtd_ttiled._check_layout(WH, WW)
        else:
            fdtd_ttiled._check_layout(WH, WW)
    finally:
        fdtd_ttiled._check_layout.cache_clear()


def test_cpu_tensors_launch_nothing_and_are_not_modified():
    rows, cols = 24, 20
    rng = np.random.default_rng(1)
    eps = np.full((rows, cols), constants.EPSILON_0)
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = _coefficients(eps, mu)
    fields = [torch.from_numpy(a) for a in _random_state(rng, rows, cols)]
    before = [f.clone() for f in fields]
    counts = fdtd_ttiled.launches, fdtd_blocked.launches
    out = fdtd_ttiled.fdtd_multistep_ttiled(*fields, ce, ch, coef, DT, FC, 5, 7, 8,
                                            "sinusoidal", 3, K=3, tile=(12, 10))
    blocked = fdtd_blocked.fdtd_multistep_blocked(*fields, ce, ch, coef, DT, FC, 5, 7,
                                                  8, "sinusoidal", 3)
    assert (fdtd_ttiled.launches, fdtd_blocked.launches) == counts == (0, 0)
    for f, b, o, k in zip(fields, before, out, blocked):
        assert torch.equal(f, b) and not torch.equal(o, b) and torch.equal(o, k)


def test_padded_layout_accepted():
    rows, cols = 30, 26
    rng = np.random.default_rng(2)
    eps = np.full((rows, cols), constants.EPSILON_0)
    mu = np.full((rows, cols), constants.MU_0)
    ce, ch, coef = _coefficients(eps, mu)
    fields = [torch.from_numpy(a) for a in _random_state(rng, rows, cols)]
    args = (coef, DT, FC, 9, 9, 7, "ricker", 0)
    staggered = fdtd_ttiled.fdtd_multistep_ttiled(*fields, ce, ch, *args, K=2)
    padded = fdtd_ttiled.fdtd_multistep_ttiled(
        *fdtd_fused.pad_state(*fields), ce,
        torch.nn.functional.pad(ch, (0, 1, 0, 1)), *args, K=2)
    for s, p in zip(staggered, padded):
        assert torch.equal(s, p)


RESOLVE_SHAPES = [(16, 16), (64, 128), (2048, 2048), (2304, 2304), (16, 300000),
                  (2305, 2304), (2400, 2400), (4096, 4096), (4104, 4096),
                  (2056, 4096), (8192, 8192), (3001, 4999), (1034, 1034), (1035, 1035)]


def test_resolve_backend_matches_jax():
    """On a CUDA device 'auto' follows what was timed on the H100 (PERF.md
    section 6), not the JAX rule: K1 ("fused", JAX "pallas") only where its
    resident mode holds the grid in the card's SMs, K2 ("ttiled") past that.
    So it agrees with the JAX package up to the resident limit and past
    JAX's (2048+256)^2, and departs from it in between, where JAX's on-chip
    kernel still holds the state and K1 on this card streams it from device
    memory. Never the plain path on the card, whatever the call's length.
    (Below 16 cells a side the port has no kernel and raises, where JAX
    tries its ttiled kernel.)"""
    names = {"pallas": "fused", "ttiled": "ttiled"}
    for shape in RESOLVE_SHAPES:
        jax_name = names[jax_resolve_backend("auto", shape)]
        resident = shape[0] * shape[1] <= 1034 * 1034 and max(shape) <= 1500
        ours = resolve_backend("auto", shape, "cuda")
        assert ours == ("fused" if resident else "ttiled")
        assert (ours == jax_name) == (resident or jax_name == "ttiled")
        for steps in (1, 5, 8, 200):
            assert resolve_backend("auto", shape, "cuda", steps) in ("fused", "ttiled")
        assert resolve_backend("auto", shape, "cpu") == "torch"
