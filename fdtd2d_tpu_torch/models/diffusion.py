"""DDPM noise schedule, loss weighting and sampling on torch tensors.

Counterpart of ``fdtd2d_tpu/models/diffusion.py`` (the same math as
``diffusers.DDPMScheduler`` with ``beta_schedule="squaredcos_cap_v2"``):

- cosine beta schedule: beta_t = min(1 - abar(t+1)/abar(t), 0.999),
  abar(u) = cos^2(((u/T + 0.008)/1.008) * pi/2)
- ``add_noise``: sqrt(abar_t) x0 + sqrt(1-abar_t) noise
- ancestral ``step`` with the "fixed_small" variance
- SNR^gamma loss weight w(t) = SNR^g/(SNR^g + 1)
- SNR^gamma importance-sampled timesteps by inverse CDF

Randomness comes from an explicit ``torch.Generator``, and each draw is kept
apart from the arithmetic it feeds: :func:`importance_sample_timesteps`
draws uniforms and hands them to :func:`timesteps_from_uniforms`;
:meth:`DDPMSchedule.step` takes its noise as a tensor; :func:`sample` takes
its initial field and per-step noises from :func:`sample_draws` or from the
caller. A generator lies on the device of the tensors it draws, so that no
draw waits on a copy from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


def cosine_beta_schedule(num_timesteps: int = 1000, max_beta: float = 0.999,
                         dtype=torch.float64, device="cpu") -> torch.Tensor:
    """'squaredcos_cap_v2' betas, computed in float64 and stored at ``dtype``."""
    u = np.arange(num_timesteps + 1) / num_timesteps
    abar = np.cos(((u + 0.008) / 1.008) * np.pi / 2) ** 2
    betas = np.clip(1.0 - abar[1:] / abar[:-1], 0.0, max_beta)
    return torch.as_tensor(betas).to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class DDPMSchedule:
    betas: torch.Tensor           # (T,)
    alphas_cumprod: torch.Tensor  # (T,)

    @staticmethod
    def create(num_timesteps: int = 1000, dtype=torch.float32,
               device="cuda") -> "DDPMSchedule":
        betas = cosine_beta_schedule(num_timesteps, dtype=dtype, device=device)
        # the product of the stored betas taken in float64: a float32 scan
        # rounds by up to ~1.5e-6 relative (the JAX package's, on the CPU)
        abar = torch.cumprod(1.0 - betas.to(torch.float64), 0).to(dtype)
        return DDPMSchedule(betas=betas, alphas_cumprod=abar)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def add_noise(self, x0, noise, t):
        """Forward process q(x_t | x_0); t is a (B,) integer tensor."""
        abar = self.alphas_cumprod[t]
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return (torch.sqrt(abar).reshape(shape) * x0
                + torch.sqrt(1.0 - abar).reshape(shape) * noise)

    def step(self, noise_pred, t: int, t_prev: int, sample, noise=None,
             clip_sample: Optional[float] = 20.0, prediction_type: str = "epsilon"):
        """One ancestral denoising step from t to t_prev (DDPM).

        ``noise``: the step's N(0, 1) draw, shaped like ``sample``; None
        gives the deterministic step (the posterior mean). ``clip_sample``
        bounds the reconstructed x0 in normalized units (None disables):
        without it the 1/sqrt(abar_t) amplification at early timesteps blows
        predictions up. ``prediction_type``: "epsilon" (the model predicts
        the added noise) or "x0" (the clean field)."""
        abar_t = self.alphas_cumprod[t]
        abar_prev = (self.alphas_cumprod[t_prev] if t_prev >= 0
                     else torch.ones_like(abar_t))
        alpha_t = abar_t / abar_prev
        beta_t = 1.0 - alpha_t

        if prediction_type == "x0":
            x0 = noise_pred
        else:
            x0 = (sample - torch.sqrt(1.0 - abar_t) * noise_pred) / torch.sqrt(abar_t)
        if clip_sample is not None:
            x0 = torch.clamp(x0, -clip_sample, clip_sample)

        coef_x0 = torch.sqrt(abar_prev) * beta_t / (1.0 - abar_t)
        coef_xt = torch.sqrt(alpha_t) * (1.0 - abar_prev) / (1.0 - abar_t)
        mean = coef_x0 * x0 + coef_xt * sample

        var = beta_t * (1.0 - abar_prev) / (1.0 - abar_t)  # "fixed_small"
        if noise is None:
            return mean
        scale = torch.sqrt(torch.clamp(var, min=0.0)) if t_prev >= 0 else torch.zeros_like(var)
        return mean + scale * noise

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Strided timestep ladder (diffusers set_timesteps parity), on the
        host: the sampler's loop runs over it."""
        stride = self.num_timesteps // num_inference_steps
        return (np.arange(0, num_inference_steps) * stride)[::-1]


def snr_gamma_weight(schedule: DDPMSchedule, t, gamma: float = 5.0):
    """w(t) = SNR^gamma / (SNR^gamma + 1)."""
    abar = schedule.alphas_cumprod[t]
    snr = abar / (1.0 - abar)
    return snr**gamma / (snr**gamma + 1.0)


def loss_weight(schedule: DDPMSchedule, t, weighting: str,
                prediction_type: str, gamma: float = 5.0):
    """Per-timestep loss weight applied to the MSE of the model's own target
    (noise for "epsilon", the clean field for "x0"): "snr_gamma" (the
    reference's SNR^g/(SNR^g+1) on the epsilon-MSE; it leaves t > ~500
    untrained), "min_snr" (min(SNR, g)/SNR on the epsilon-MSE, min(SNR, g)
    on the x0-MSE) or "uniform" (1; with "x0" the recipe that generates
    scene-locked fields). See the JAX module for the measurements behind
    these remarks."""
    abar = schedule.alphas_cumprod[t]
    snr = abar / (1.0 - abar)
    if weighting == "snr_gamma":
        w = snr**gamma / (snr**gamma + 1.0)
        return w if prediction_type == "epsilon" else w * snr
    if weighting == "min_snr":
        w = torch.clamp(snr, max=gamma)
        return w / snr if prediction_type == "epsilon" else w
    if weighting == "uniform":
        return torch.ones_like(snr)
    raise ValueError(f"unknown weighting {weighting!r}")


def timesteps_from_uniforms(schedule: DDPMSchedule, u, gamma: float = 1.3):
    """t ~ SNR(t)^gamma by inverse CDF of the uniforms ``u`` (B,)."""
    snr = schedule.alphas_cumprod / (1.0 - schedule.alphas_cumprod)
    w = snr**gamma
    cdf = torch.cumsum(w / torch.sum(w), 0)
    t = torch.searchsorted(cdf, u.to(cdf.dtype), right=True)
    return torch.clamp(t, 0, schedule.num_timesteps - 1)


def importance_sample_timesteps(schedule: DDPMSchedule, generator: torch.Generator,
                                batch_size: int, gamma: float = 1.3):
    """Draw t ~ SNR(t)^gamma (B,) on the generator's device."""
    u = torch.rand((batch_size,), generator=generator, device=generator.device)
    return timesteps_from_uniforms(schedule, u, gamma)


def _ladder(schedule: DDPMSchedule, num_inference_steps: int,
            t_start: Optional[int]) -> np.ndarray:
    ts = schedule.inference_timesteps(num_inference_steps)
    if t_start is not None:
        ts = ts[ts <= t_start]
        if ts.size == 0:
            raise ValueError(f"t_start={t_start} leaves no inference steps")
    return ts


def sample_draws(schedule: DDPMSchedule, generator: torch.Generator, shape,
                 num_inference_steps: int = 50, stochastic: bool = True,
                 t_start: Optional[int] = None, dtype=torch.float32):
    """(initial field, per-step noises or None) for :func:`sample`."""
    n = len(_ladder(schedule, num_inference_steps, t_start))
    dev = generator.device
    x = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
    noises = ([torch.randn(shape, generator=generator, device=dev, dtype=dtype)
               for _ in range(n)] if stochastic else None)
    return x, noises


def sample(schedule: DDPMSchedule, apply_fn: Callable, generator, eps, mu, src, omega,
           num_inference_steps: int = 50, stochastic: bool = True,
           clip_sample=20.0, prediction_type: str = "epsilon",
           t_start: Optional[int] = None,
           draws: Optional[tuple] = None):
    """Full DDPM inference loop, a Python loop over the timestep ladder.

    ``t_start`` truncates the chain to timesteps <= t_start (still starting
    from pure N(0, 1) noise: for unit-std training data the forward marginal
    has unit variance at every t). ``draws``: ``(x, noises)`` as
    :func:`sample_draws` returns them; drawn from ``generator`` when None.
    ``apply_fn(eps, mu, src, x, t, omega)`` takes t as a (B,) tensor."""
    ts = _ladder(schedule, num_inference_steps, t_start)
    ts_prev = list(ts[1:]) + [-1]
    if draws is None:
        draws = sample_draws(schedule, generator, eps.shape, num_inference_steps,
                             stochastic, t_start, eps.dtype)
    x, noises = draws
    x = x.to(eps.device)
    for i, (t, t_prev) in enumerate(zip(ts.tolist(), ts_prev)):
        tb = torch.full((eps.shape[0],), t, device=eps.device, dtype=torch.int64)
        noise_pred = apply_fn(eps, mu, src, x, tb, omega)
        x = schedule.step(noise_pred, t, int(t_prev), x,
                          noise=None if noises is None else noises[i],
                          clip_sample=clip_sample, prediction_type=prediction_type)
    return x

