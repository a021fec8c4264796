"""The port's core (fdtd2d_tpu_torch.core) against the JAX package's.

constants, materials and guards are copies of the NumPy-only originals;
grid and sources are torch counterparts. Inputs come from a numpy seed and
go through both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from fdtd2d_tpu import constants as jax_constants
from fdtd2d_tpu.core import guards as jax_guards
from fdtd2d_tpu.core import grid as jax_grid
from fdtd2d_tpu.core import sources as jax_sources
from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.core import guards, grid, sources

DT, FC = 5e-14, 30e9


def test_constants_are_copied():
    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names
    for name in names:
        assert getattr(constants, name) == getattr(jax_constants, name), name


@pytest.mark.parametrize("with_image", [False, True])
def test_scene_from_image_matches_jax(tmp_path, with_image):
    path = None
    if with_image:
        rng = np.random.default_rng(0)
        path = str(tmp_path / "structure.png")
        Image.fromarray(rng.integers(0, 256, (37, 29), dtype=np.uint8)).save(path)
    ours = grid.Scene.from_image(path, 24, 20, dx=1e-4, black_point=3.0,
                                 dtype=torch.float64, device="cpu")
    ref = jax_grid.Scene.from_image(path, 24, 20, dx=1e-4, black_point=3.0,
                                    dtype=jnp.float64)
    assert ours.shape == ref.shape == (24, 20) and ours.dx == ref.dx
    np.testing.assert_array_equal(ours.eps.numpy(), np.asarray(ref.eps))
    np.testing.assert_array_equal(ours.mu.numpy(), np.asarray(ref.mu))


def test_scene_vacuum_and_point_source_match_jax():
    ours = grid.Scene.vacuum(12, 17, 1e-4, device="cpu")
    ref = jax_grid.Scene.vacuum(12, 17, 1e-4)
    assert ours.eps.dtype == torch.float32
    np.testing.assert_array_equal(ours.eps.numpy(), np.asarray(ref.eps))
    np.testing.assert_array_equal(ours.mu.numpy(), np.asarray(ref.mu))
    np.testing.assert_array_equal(ours.point_source(3, 5).numpy(),
                                  np.asarray(ref.point_source(3, 5)))


def test_guards_are_copied():
    rng = np.random.default_rng(1)
    eps = constants.EPSILON_0 * (1.0 + rng.random((16, 16)))
    mu = np.full((16, 16), constants.MU_0)
    assert guards.check_courant(eps, mu, DT, 1e-4) == jax_guards.check_courant(eps, mu, DT, 1e-4)
    for mod in (guards, jax_guards):
        with pytest.raises(ValueError, match="Courant"):
            mod.check_courant(eps, mu, 1e-9, 1e-4)
        with pytest.raises(ValueError, match="lambda_min/10"):
            mod.check_resolution(eps, mu, 17e9, 1e-1)
        mod.check_resolution(eps, mu, 17e9, 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_init_shapes(dtype):
    Ez, Hx, Hy = grid.grid_init(20, 33, dtype=dtype, device="cpu")
    assert (Ez.shape, Hx.shape, Hy.shape) == ((20, 33), (20, 32), (19, 33))
    assert all(t.dtype == dtype and not t.any() for t in (Ez, Hx, Hy))


@pytest.mark.parametrize("kind", ["ricker", "sinusoidal"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("float64", 1e-12)])
def test_source_amplitudes_match_jax(kind, dtype, tol):
    steps = np.random.default_rng(2).integers(0, 8000, 64)
    t = steps.astype(dtype) * np.asarray(DT, dtype)
    jfn = jax_sources.ricker_amplitude if kind == "ricker" else jax_sources.sinusoidal_amplitude
    tfn = sources.ricker_amplitude if kind == "ricker" else sources.sinusoidal_amplitude
    ref = np.asarray(jfn(jnp.asarray(t), jnp.asarray(FC, dtype)))
    ours = tfn(torch.from_numpy(t), torch.tensor(FC, dtype=getattr(torch, dtype))).numpy()
    assert ours.dtype == ref.dtype == np.dtype(dtype)
    err = np.max(np.abs(ours - ref)) / np.max(np.abs(ref))
    assert err <= tol, f"relative error {err:.3e}"


def test_source_amplitudes_index_global_steps():
    amps = sources.source_amplitudes("ricker", 40, 10, DT, FC, torch.float64)
    t = torch.arange(40, 50, dtype=torch.float64) * DT
    torch.testing.assert_close(amps, sources.ricker_amplitude(t, torch.tensor(FC, dtype=torch.float64)),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="source kind"):
        sources.source_amplitudes("gaussian", 0, 4, DT, FC)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_region_drawer_matches_jax(seed, tmp_path):
    """The port's copy of RegionDrawer draws the JAX package's masks bit for
    bit: every primitive at seeded positions and sizes, the permittivity
    exports and the PNG."""
    from fdtd2d_tpu.core.geometry import RegionDrawer as JaxDrawer
    from fdtd2d_tpu_torch.core import RegionDrawer

    rng = np.random.default_rng(seed)
    W, H = (int(v) for v in rng.integers(40, 90, 2))

    def pt():
        return (float(rng.uniform(0, W)), float(rng.uniform(0, H)))

    calls = [("draw_waveguide", (pt(), pt(), int(rng.integers(1, 6)))),
             ("draw_ring_resonator", (pt(), int(rng.integers(4, 15)), int(rng.integers(1, 4)))),
             ("draw_sphere", (pt(), int(rng.integers(2, 9)), int(rng.integers(0, 3)))),
             ("draw_curved_waveguide", (pt(), pt(), pt(), int(rng.integers(1, 5)))),
             ("draw_directional_coupler", (pt(), int(rng.integers(10, 30)),
                                           int(rng.integers(1, 6)), int(rng.integers(1, 4)))),
             ("draw_box", ((int(rng.integers(5, 20)), int(rng.integers(5, 20))),
                           int(rng.integers(8, 20)), int(rng.integers(1, 4)))),
             ("draw_waveguide", ((10.0, 10.0), (10.0, 10.0), 3))]   # a zero-length segment
    ours, theirs = RegionDrawer(W, H), JaxDrawer(W, H)
    for name, args in calls:
        getattr(ours, name)(*args)
        getattr(theirs, name)(*args)
        np.testing.assert_array_equal(ours.canvas, theirs.canvas, err_msg=name)
    assert 0 < ours.canvas.sum() < W * H
    np.testing.assert_array_equal(ours.to_eps(4.0), theirs.to_eps(4.0))
    ours.save(str(tmp_path / "a.png"))
    theirs.save(str(tmp_path / "b.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "b.png")))


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    """trace_profile writes a Chrome trace under its directory that names an
    op run inside the block, and the program's spans (utils/trace.py) as
    host annotations."""
    import json

    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate
    from fdtd2d_tpu_torch.utils import trace_profile

    log_dir = tmp_path / "trace"
    eps, mu = np.full((16, 16), constants.EPSILON_0), np.full((16, 16), constants.MU_0)
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=2, source_xy=(8, 8), source_fc=30e9,
                     backend="torch", device="cpu")
    with trace_profile(str(log_dir)) as where:
        torch.linalg.qr(torch.ones((8, 8), dtype=torch.float64) + torch.eye(8))
        simulate(eps, mu, cfg)
    assert where == str(log_dir)
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    assert any("linalg_qr" in str(e.get("name", "")) for e in events)
    assert any(e.get("name") == "fdtd.simulate" and e.get("cat") == "user_annotation"
               for e in events)
