"""The patch-sharded tiled Schwarz solve of the port (fdtd2d_tpu_torch/
parallel/tiled_sharded.py) on meshes of CPU entries: against the JAX
package's run_fdfd_tiled_sharded on 4 of the 8 virtual CPU devices of
tests/conftest.py, and against the port's single-device two-level solve
with the patch level forced on (itself held to JAX's in
tests/test_torch_tiled.py)."""

import jax
import numpy as np
import pytest
import torch

from fdtd2d_tpu import constants
from fdtd2d_tpu.parallel import make_mesh as jax_make_mesh
from fdtd2d_tpu.parallel.tiled_sharded import _pad_patches as jax_pad_patches
from fdtd2d_tpu.parallel.tiled_sharded import run_fdfd_tiled_sharded as jax_run
from fdtd2d_tpu_torch.fdfd.tiled import TiledSolver, generate_patches, pou_weights
from fdtd2d_tpu_torch.parallel import make_mesh, tiled_sharded
from fdtd2d_tpu_torch.parallel.tiled_sharded import _pad_patches, run_fdfd_tiled_sharded


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(D):
    return make_mesh((D,), axis_names=("p",), devices=["cpu"] * D)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("D", [3, 4, 8])
def test_pad_patches_equals_jax(D):
    origins = generate_patches(64, 64, 24, 12)
    weights = pou_weights(origins, 48, 64, 64, 6, 12)
    got, want = _pad_patches(origins, weights, D), jax_pad_patches(origins, weights, D)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) % D == 0 and not got[1][len(origins):].any()


def test_dryrun_configuration_matches_jax():
    """The JAX dry run's stage 5 (__graft_entry__.py:170-176: 64^2, patch 24,
    padding 12, PML 6 / 8, solver_tol 1e-2, 4 iterations, 4 inner, no
    refinement, complex64) on 4 entries against JAX's on 4 devices: <= 1e-5;
    one patch-level application an outer iteration (a cycle of 30)."""
    N = 64
    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    mu = np.full((N, N), constants.MU_0, np.float32)
    src = np.zeros((N, N), np.float32)
    src[N // 2, N // 2] = 1.0
    kw = dict(patch_size=24, padding=12, pml_thickness=6, global_pml_thickness=8,
              solver_tol=1e-2, solver_maxiter=4, inner_iters=4, refine_target=None)
    want, wtrace = jax_run(eps, mu, 1e-3, 1e-3, 17e9, src,
                           jax_make_mesh((4,), axis_names=("p",), devices=jax.devices()[:4]),
                           **kw)
    tiled_sharded.applications = 0
    got, trace = run_fdfd_tiled_sharded(eps, mu, 1e-3, 1e-3, 17e9, src, _mesh(4), **kw)
    assert got.dtype == torch.complex64 and got.shape == (N, N)
    assert _rel(got.numpy(), want) < 1e-5
    assert trace[0] < 1e-2 and trace[0] == pytest.approx(wtrace[0], rel=0.5)
    assert tiled_sharded.applications == 30


def _block_scene(N):
    """A 2.5x block and a source of 10 at the centre: at 160^2 the scene of
    tests/test_sharded.py:94-125 (eps[60:100, 40:70])."""
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N * 3 // 8: N * 5 // 8, N // 4: N * 7 // 16] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N))
    source[N // 2, N // 2] = 10.0
    return eps, mu, source


def _against_single_device(N, D, patch, padding, pml, gpml, maxiter, inner):
    """The sharded solve refined to 1e-7 against TiledSolver with the patch
    level forced on (adaptive=False), restart 30 as the sharded outer level:
    trace[-2] < 1e-7, trace[-1] < 5e-5 and the fields within 1e-5."""
    eps, mu, source = _block_scene(N)
    kw = dict(patch_size=patch, padding=padding, pml_thickness=pml, global_pml_thickness=gpml,
              inner_iters=inner)
    got, trace = run_fdfd_tiled_sharded(eps, mu, 1e-3, 1e-3, 17e9, source, _mesh(D),
                                        solver_tol=1e-6, solver_maxiter=maxiter,
                                        refine_target=1e-7, **kw)
    solver = TiledSolver(eps, mu, 1e-3, 1e-3, 17e9, outer_restart=30, device="cpu", **kw)
    want, wtrace = solver.solve(source, solver_tol=1e-6, solver_maxiter=maxiter,
                                refine_target=1e-7, adaptive=False)
    assert trace[-2] < 1e-7, f"sharded tiled true residual: {trace[-2]:.2e}"
    assert trace[-1] < 5e-5 and wtrace[-2] < 1e-7
    assert _rel(got.numpy(), want.numpy()) < 1e-5


def test_refined_solve_equals_single_device():
    """64^2, patch 24 (9 patches padded to 12 over 4 entries), one outer
    cycle a round."""
    _against_single_device(64, 4, 24, 12, 6, 12, maxiter=30, inner=6)


@pytest.mark.slow
def test_sharded_tiled_160_equals_single_device():
    """The configuration of tests/test_sharded.py:94-125 (160^2, its block
    scene, patch 64, padding 24, PML 10 / 40, solver_tol 1e-6, 60
    iterations, 15 inner, refined to 1e-7) on 8 entries (9 patches padded to
    16). About 105 s on one CPU thread, so marked slow as JAX marks its
    own."""
    _against_single_device(160, 8, 64, 24, 10, 40, maxiter=60, inner=15)


def test_refuses_a_2d_mesh():
    eps, mu, source = _block_scene(64)
    with pytest.raises(ValueError, match="1D mesh"):
        run_fdfd_tiled_sharded(eps, mu, 1e-3, 1e-3, 17e9, source,
                               make_mesh((2, 2), devices=["cpu"] * 4), patch_size=24,
                               padding=12)
