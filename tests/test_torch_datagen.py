"""The port's datagen (fdtd2d_tpu_torch/models/datagen.py) against the JAX
package's: scenes from JAX's draws, labels of the same scenes, the
scene-batched operator, the dataset files both ways, and sharded resume."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from fdtd2d_tpu.models import datagen as jdg
from fdtd2d_tpu_torch.models import datagen as tdg

DX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_permittivity_from_jax_draws():
    """JAX's noise and blur width through the port's blur and threshold:
    eps equal except where the blurred field lies within 1e-6 of 0.5."""
    shape = (64, 64)
    for i in range(4):
        key = jax.random.PRNGKey(i)
        k_noise, k_sigma = jax.random.split(key)
        noise = np.asarray(jax.random.uniform(k_noise, shape))
        sigma = np.asarray(jax.random.uniform(k_sigma, ())) * 4.0 + 2.0
        want = np.asarray(jdg.random_permittivity(key, shape)[0])
        eps, mu = tdg._permittivity_from_draws(torch.tensor(noise)[None],
                                               torch.tensor(sigma).reshape(1))
        c = np.arange(tdg.KERNEL_SIZE) - tdg.KERNEL_SIZE // 2
        kern = np.exp(-(c[:, None] ** 2 + c[None, :] ** 2) / (2 * sigma**2))
        blurred = scipy.signal.convolve2d(noise, kern / kern.sum(), mode="same")
        sure = np.abs(blurred - 0.5) >= 1e-6
        assert sure.mean() > 0.999
        np.testing.assert_array_equal(eps[0].numpy()[sure], want[sure])
        assert eps.dtype == mu.dtype == torch.float64 and float(mu.max()) == tdg.MU_REF
    assert set(np.unique(want)) == {jdg.EPS_LO, jdg.EPS_HI}


def test_sources_and_omegas_from_jax_draws():
    shape = (64, 48)
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    want = np.asarray(jax.vmap(lambda k: jdg.random_source(k, shape))(keys))

    def draws(key):
        k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
        sx0, sx1, sy0, sy1, L = tdg._source_spans(shape)
        return (jax.random.uniform(k1, ()) < 0.5, jax.random.uniform(k2, ()) < 0.5,
                jax.random.randint(k3, (), sx0, sx1), jax.random.randint(k4, (), sy0, sy1),
                jax.random.randint(k5, (), sy0, max(sy1 - L, sy0 + 1)),
                jax.random.randint(k6, (), sx0, max(sx1 - L, sx0 + 1)))

    d = [torch.tensor(np.asarray(a)) for a in jax.vmap(draws)(keys)]
    got = tdg._source_from_draws(shape, *d).numpy()
    np.testing.assert_array_equal(got, want)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys))
    np.testing.assert_allclose(tdg._omega_from_uniform(torch.tensor(u)).numpy(),
                               np.asarray(jax.vmap(jdg.random_omega)(keys)), rtol=1e-15)


def test_scene_statistics():
    """The port's own draws: binary eps with both values well represented,
    every scene a source, lines and points both, every source pixel in the
    middle 80%, omega in [18, 30] GHz."""
    g = torch.Generator().manual_seed(0)
    shape = (64, 64)
    eps, mu, src, omega = tdg.random_scenes(g, shape, 64)
    assert set(np.unique(eps.numpy())) == {tdg.EPS_LO, tdg.EPS_HI}
    frac = (eps == tdg.EPS_HI).double().mean(dim=(1, 2))
    assert 0.05 < float(frac.mean()) < 0.95
    counts = src.sum(dim=(1, 2))
    assert int(counts.min()) >= 1 and (counts > 1).any() and (counts == 1).any()
    sx0, sx1, sy0, sy1, L = tdg._source_spans(shape)
    assert int(counts.max()) <= L
    r, c = np.nonzero(src.numpy().any(axis=0))
    assert r.min() >= sx0 and r.max() < sx1 + L and c.min() >= sy0 and c.max() < sy1 + L
    assert float(omega.min()) >= 18e9 and float(omega.max()) <= 30e9


def test_scene_batched_operator_matches_jax():
    """make_operator_traced on (B,) omegas: each scene's stretch vectors,
    eps, 1/mu and omega equal the JAX operator of that scene."""
    rng = np.random.default_rng(0)
    B, N, pml = 3, 32, 8
    eps = np.where(rng.random((B, N, N)) > 0.5, jdg.EPS_HI, jdg.EPS_LO)
    mu = np.full((B, N, N), jdg.MU_REF)
    omega = rng.uniform(18e9, 30e9, B)
    op = tdg.make_operator_traced(torch.tensor(eps), torch.tensor(mu), DX, DX,
                                  torch.tensor(omega), pml)
    assert op.batch_shape == (B,) and op.field_shape == (B, N, N)
    for i in range(B):
        j = jdg.make_operator_traced(jnp.asarray(eps[i]), jnp.asarray(mu[i]), DX, DX,
                                     jnp.asarray(omega[i]), pml)
        for name in ("eps", "inv_mu", "inv_s_row", "inv_s_col", "omega"):
            np.testing.assert_array_equal(getattr(op, name)[i].numpy(),
                                          np.asarray(getattr(j, name)), err_msg=name)
        for name in ("inv_2dx", "inv_2dy"):
            assert float(getattr(op, name)) == float(getattr(j, name))


def test_labels_match_jax():
    """The scenes of JAX's ``_generate_batch_direct_device`` (48^2, batch 3,
    PML 8) through the port's batched factor, solve and refinement round:
    every true float64 residual < 1e-5 (tests/test_models.py's bound), and
    the labels within 1e-5 of JAX's (max |x - x_jax| / max |x_jax|; 2.9e-7
    measured; both are complex64 solves refined once, each with its own
    rounding)."""
    key, B, shape, pml = jax.random.PRNGKey(0), 3, (48, 48), 8
    *_, want = jdg._generate_batch_direct_device(key, batch=B, shape=shape, dx=DX,
                                                 pml_thickness=pml)
    scenes = []
    for k in jax.random.split(key, B):
        k_eps, k_src, k_om = jax.random.split(k, 3)
        eps, mu = jdg.random_permittivity(k_eps, shape)
        scenes.append((eps, mu, jdg.random_source(k_src, shape), jdg.random_omega(k_om)))
    eps, mu, src, omega = (torch.tensor(np.stack([np.asarray(s[i]) for s in scenes]))
                           for i in range(4))
    x = tdg._solve_scenes(eps, mu, src, omega, DX, pml)
    assert x.dtype == torch.complex64 and x.shape == (B,) + shape
    res = tdg._five_point_residual_host(eps.numpy(), mu.numpy(), src.numpy(),
                                        omega.numpy(), x.numpy(), DX, pml)
    np.testing.assert_allclose(res, jdg._five_point_residual_host(
        eps.numpy(), mu.numpy(), src.numpy(), omega.numpy(), x.numpy(), DX, pml), rtol=1e-12)
    assert res.max() < 1e-5, res
    want = np.asarray(want)
    assert np.abs(x.numpy() - want).max() / np.abs(want).max() < 1e-5


def test_generate_dataset_batches_and_queue():
    """generate_dataset's queued batches are the batches generate_batch
    draws one after another from the same generator; host numpy out, with
    residuals < 1e-5 and omegas in range."""
    shape = (32, 32)
    data = tdg.generate_dataset(7, 6, shape, batch=4, pml_thickness=8, device="cpu")
    g = torch.Generator().manual_seed(7)
    parts = [tdg.generate_batch(g, batch=b, shape=shape, pml_thickness=8, device="cpu")
             for b in (4, 2)]
    for k in ("eps", "mu", "src", "omega", "Ez", "residuals"):
        assert isinstance(data[k], np.ndarray) and data[k].shape[0] == 6
        np.testing.assert_array_equal(data[k], np.concatenate([p[k] for p in parts]),
                                      err_msg=k)
    assert data["Ez"].dtype == np.float32 and data["Ez"].shape == (6,) + shape
    assert data["residuals"].max() < 1e-5
    assert data["omega"].min() >= 18e9 and data["omega"].max() <= 30e9
    times = {}
    tdg._generate_batch_compact_device(torch.Generator().manual_seed(0), batch=2, shape=shape,
                                       dx=DX, pml_thickness=8, device="cpu", times=times)
    assert set(times) == {"draw", "factor", "solve", "refine"}


def test_generate_dataset_takes_the_jax_keywords():
    """The call of the JAX package's own test (tests/test_models.py:105-106):
    ``maxiter``, ``M`` and ``to_host`` are accepted and dropped, by
    generate_dataset and generate_batch alike, and leave the data as it is
    without them."""
    shape = (48, 48)
    M = tdg.default_preconditioner(shape, pml_thickness=8, device="cpu")
    data = tdg.generate_dataset(5, 6, shape, batch=4, pml_thickness=8, maxiter=100, M=M,
                                to_host=True, device="cpu")
    assert isinstance(data["Ez"], np.ndarray) and data["Ez"].shape == (6,) + shape
    assert np.all(np.isfinite(data["Ez"]))
    plain = tdg.generate_dataset(5, 6, shape, batch=4, pml_thickness=8, device="cpu")
    for k in plain:
        np.testing.assert_array_equal(data[k], plain[k], err_msg=k)
    one = tdg.generate_batch(torch.Generator().manual_seed(5), batch=4, shape=shape,
                             pml_thickness=8, M=M, maxiter=100, device="cpu")
    np.testing.assert_array_equal(one["Ez"], plain["Ez"][:4])


def test_generate_batch_krylov_runs():
    """The Krylov-labelled batch (kept for comparison): the scene-batched
    operator under one batched FGMRES with the shared FDM preconditioner."""
    shape = (32, 32)
    M = tdg.default_preconditioner(shape, pml_thickness=8, device="cpu")
    out = tdg.generate_batch_krylov(0, batch=3, shape=shape, pml_thickness=8, maxiter=80, M=M,
                                    device="cpu")
    assert out["Ez"].shape == (3,) + shape and bool(torch.isfinite(out["Ez"]).all())
    assert out["residuals"].shape == (3,) and float(out["residuals"].max()) < 1.0


@pytest.mark.parametrize("compact", [True, False])
def test_dataset_files_cross_between_packages(tmp_path, compact):
    """Each package's save_dataset is read by the other's load_dataset bit
    for bit, in the compact and the plain format."""
    data = tdg.generate_dataset(1, 4, (32, 32), batch=4, pml_thickness=8, device="cpu")
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    tdg.save_dataset(ours, data, compact=compact)
    jdg.save_dataset(theirs, data, compact=compact)
    for path in (ours, theirs):
        a, b = tdg.load_dataset(path), jdg.load_dataset(path)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
            np.testing.assert_array_equal(np.asarray(a[k]), data[k], err_msg=k)
        raw_a, raw_b = tdg.load_dataset(path, decode=False), jdg.load_dataset(path, decode=False)
        assert raw_a.keys() == raw_b.keys()
    assert not os.path.exists(ours + ".tmp.npz")


def test_dataset_shards_resume(tmp_path):
    """Shard i draws from (seed, i) alone: a resumed run rewrites a missing
    shard bit for bit and skips the others; both packages read the
    directory alike."""
    d = str(tmp_path / "shards")
    kw = dict(shard_size=4, batch=4, pml_thickness=8, device="cpu", verbose=False)
    assert tdg.generate_dataset_shards(3, 10, (32, 32), d, **kw) == 3
    first = tdg.load_dataset(d)
    assert first["Ez"].shape == (10, 32, 32)
    assert not np.array_equal(first["Ez"][0], first["Ez"][4])
    os.remove(os.path.join(d, "shard_00001.npz"))
    assert tdg.generate_dataset_shards(3, 10, (32, 32), d, **kw) == 1
    assert tdg.generate_dataset_shards(3, 10, (32, 32), d, **kw) == 0
    again, jax_read = tdg.load_dataset(d), jdg.load_dataset(d)
    for k in first:
        np.testing.assert_array_equal(again[k], first[k], err_msg=k)
        np.testing.assert_array_equal(np.asarray(jax_read[k]), first[k], err_msg=k)
