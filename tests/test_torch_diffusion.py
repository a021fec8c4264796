"""The port's DDPM schedule, loss weights, importance sampler and sampler
(fdtd2d_tpu_torch/models/diffusion.py) against the JAX package's, fed the
same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdtd2d_tpu.models import diffusion as jd
from fdtd2d_tpu_torch.models import diffusion as td

KEY = jax.random.PRNGKey(0)


def _schedules(T=1000):
    """JAX's schedule, and the port's holding the same arrays: the tests
    below hold the port's arithmetic to JAX's on one schedule (the two
    ``create``s differ in the last bits of alphas_cumprod, which 1 - abar
    amplifies near t = 0; test_schedule_matches_jax bounds that)."""
    js = jd.DDPMSchedule.create(T)
    return js, td.DDPMSchedule(betas=torch.tensor(np.asarray(js.betas)),
                               alphas_cumprod=torch.tensor(np.asarray(js.alphas_cumprod)))


def test_schedule_matches_jax():
    """Betas (float64 and the float32 schedule) at 1e-7. alphas_cumprod: the
    port takes the product of the float32 betas in float64 and rounds once,
    so it is held at 1e-7 to that product; JAX's float32 scan rounds at
    every step, and the port is held to it at the scan's own distance from
    the float64 product (1.5e-6 relative on this schedule), 2e-6."""
    np.testing.assert_allclose(td.cosine_beta_schedule(1000).numpy(),
                               np.asarray(jd.cosine_beta_schedule(1000)), rtol=0, atol=1e-15)
    js, ts = jd.DDPMSchedule.create(1000), td.DDPMSchedule.create(1000, device="cpu")
    assert ts.betas.dtype == ts.alphas_cumprod.dtype == torch.float32
    assert ts.num_timesteps == js.num_timesteps == 1000
    np.testing.assert_allclose(ts.betas.numpy(), np.asarray(js.betas), rtol=1e-7, atol=0)
    exact = np.cumprod(1.0 - np.asarray(js.betas, np.float64))
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), exact, rtol=1e-7, atol=0)
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), np.asarray(js.alphas_cumprod),
                               rtol=2e-6, atol=0)
    np.testing.assert_array_equal(ts.inference_timesteps(50),
                                  np.asarray(js.inference_timesteps(50)))


def test_add_noise_matches_jax():
    js, ts = _schedules()
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((3, 8, 8)).astype(np.float32)
    noise = rng.standard_normal((3, 8, 8)).astype(np.float32)
    t = np.array([0, 400, 999])
    want = np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    got = ts.add_noise(torch.tensor(x0), torch.tensor(noise), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weighting", ["snr_gamma", "min_snr", "uniform"])
@pytest.mark.parametrize("prediction_type", ["epsilon", "x0"])
def test_loss_weight_matches_jax(weighting, prediction_type):
    js, ts = _schedules()
    t = np.array([0, 5, 100, 500, 700, 900, 999])
    want = np.asarray(jd.loss_weight(js, jnp.asarray(t), weighting, prediction_type))
    got = td.loss_weight(ts, torch.tensor(t), weighting, prediction_type).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(td.snr_gamma_weight(ts, torch.tensor(t)).numpy(),
                               np.asarray(jd.snr_gamma_weight(js, jnp.asarray(t))),
                               rtol=1e-5, atol=1e-30)
    with pytest.raises(ValueError):
        td.loss_weight(ts, torch.tensor(t), "nope", prediction_type)


def test_importance_sampler_fed_jax_uniforms():
    """JAX's own uniforms through the port's inverse CDF give JAX's t, except
    where a uniform lies within 1e-6 of a CDF step (the two cumsums round
    differently there)."""
    js, ts = _schedules()
    B = 4096
    k = jax.random.PRNGKey(7)
    want = np.asarray(jd.importance_sample_timesteps(js, k, B, gamma=1.3))
    u = np.asarray(jax.random.uniform(k, (B,)))
    got = td.timesteps_from_uniforms(ts, torch.tensor(u), gamma=1.3).numpy()
    snr = np.asarray(js.alphas_cumprod) / (1.0 - np.asarray(js.alphas_cumprod))
    cdf = np.cumsum(snr**1.3 / np.sum(snr**1.3))
    near = np.min(np.abs(u[:, None] - cdf[None, :]), axis=1) < 1e-6
    assert (got[~near] == want[~near]).all(), np.nonzero((got != want) & ~near)
    assert near.mean() < 0.01
    # the port's own draws: in range and skewed toward low t (high SNR)
    t = td.importance_sample_timesteps(ts, torch.Generator().manual_seed(0), B)
    assert int(t.min()) >= 0 and int(t.max()) < 1000 and float(t.float().mean()) < 500


def _jax_chain_draws(key, shape, n_steps, stochastic):
    """The initial field and per-step noises jd.sample draws from ``key``."""
    key, k0 = jax.random.split(key)
    x = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    noises = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    return x, (noises if stochastic else None)


@pytest.mark.parametrize("prediction_type", ["epsilon", "x0"])
def test_step_matches_jax(prediction_type):
    js, ts = _schedules()
    rng = np.random.default_rng(1)
    x, pred, noise = (rng.standard_normal((2, 8, 8)).astype(np.float32) * 3 for _ in range(3))
    for t, t_prev in ((999, 979), (500, 480), (20, 0), (0, -1)):
        want = np.asarray(js.step(jnp.asarray(pred), t, t_prev, jnp.asarray(x),
                                  prediction_type=prediction_type))
        got = ts.step(torch.tensor(pred), t, t_prev, torch.tensor(x),
                      prediction_type=prediction_type).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
        # the stochastic step with JAX's noise for the key
        k = jax.random.PRNGKey(t)
        want = np.asarray(js.step(jnp.asarray(pred), t, t_prev, jnp.asarray(x), key=k,
                                  prediction_type=prediction_type))
        n = np.asarray(jax.random.normal(k, x.shape, jnp.float32))
        got = ts.step(torch.tensor(pred), t, t_prev, torch.tensor(x), noise=torch.tensor(n),
                      prediction_type=prediction_type).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("stochastic", [False, True])
def test_chain_matches_jax(stochastic):
    """A 10-step chain with a deterministic stand-in for the model, fed JAX's
    initial noise (and per-step noises), at 1e-5 relative."""
    js, ts = _schedules()
    rng = np.random.default_rng(2)
    eps, mu, src = (rng.standard_normal((2, 16, 16)).astype(np.float32) for _ in range(3))
    omega = np.array([1.8, 2.4], np.float32)

    def jfn(e, m, s, x, t, om):
        return 0.3 * x + 0.1 * e - 0.05 * s + 1e-4 * t.astype(jnp.float32)[:, None, None]

    def tfn(e, m, s, x, t, om):
        return 0.3 * x + 0.1 * e - 0.05 * s + 1e-4 * t.float()[:, None, None]

    for t_start in (None, 400):
        n = len([t for t in np.asarray(js.inference_timesteps(10))
                 if t_start is None or t <= t_start])
        want = np.asarray(jd.sample(js, jfn, KEY, *map(jnp.asarray, (eps, mu, src, omega)),
                                    num_inference_steps=10, stochastic=stochastic,
                                    t_start=t_start))
        x0, noises = _jax_chain_draws(KEY, eps.shape, n, stochastic)
        draws = (torch.tensor(x0), None if noises is None else [torch.tensor(v) for v in noises])
        got = td.sample(ts, tfn, None, *map(torch.tensor, (eps, mu, src, omega)),
                        num_inference_steps=10, stochastic=stochastic, t_start=t_start,
                        draws=draws).numpy()
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 1e-5, (t_start, rel)
    with pytest.raises(ValueError):
        td.sample(ts, tfn, None, *map(torch.tensor, (eps, mu, src, omega)),
                  num_inference_steps=10, t_start=-1, draws=draws)


def test_sample_draws_come_from_the_generator():
    _, ts = _schedules()
    a = td.sample_draws(ts, torch.Generator().manual_seed(3), (2, 4, 4), 10)
    b = td.sample_draws(ts, torch.Generator().manual_seed(3), (2, 4, 4), 10)
    assert torch.equal(a[0], b[0]) and len(a[1]) == 10
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    assert td.sample_draws(ts, torch.Generator(), (2, 4, 4), 10, stochastic=False)[1] is None
