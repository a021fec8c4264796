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
