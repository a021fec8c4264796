"""Excitation sources: scalar amplitude functions plus an injection site.

Counterpart of ``fdtd2d_tpu/core/sources.py``. The amplitude functions take
tensors (or Python floats) and compute in the dtype of their tensor input.
"""

from __future__ import annotations

import math

import torch


def ricker_amplitude(t, fc):
    """Ricker wavelet amplitude at time ``t`` for center frequency ``fc``:
    ``tau = pi*fc*(t - 1/fc); (1 - 2 tau^2) exp(-tau^2)``."""
    tau = math.pi * fc * (t - 1.0 / fc)
    return (1.0 - 2.0 * tau**2) * torch.exp(-(tau**2))


def sinusoidal_amplitude(t, fc):
    """Gaussian-ramped sinusoid."""
    envelope = 1.0 - torch.exp(-((t - 3000.0 / fc) ** 2) / (2.0 * (2.0 / fc) ** 2))
    return envelope * torch.sin(2.0 * math.pi * fc * t)


def point_source(Ez, x, y, amplitude):
    """Additively inject a scalar amplitude at one grid node (in place)."""
    Ez[x, y] += amplitude
    return Ez


def source_amplitudes(kind: str, step_offset: int, nsteps: int, dt, fc,
                      dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``(nsteps,)`` amplitudes ``amp[i] = source(t=(step_offset + i) * dt)``.

    Computed in ``dtype`` as the JAX rollout does (``(t0 + i).astype(dtype) *
    dt``), so the kernel and the plain path inject identical values and a
    rollout split into chunks at any offset injects what one run does.
    """
    if kind not in ("ricker", "sinusoidal"):
        raise ValueError(f"unknown source kind {kind!r}")
    dt = torch.as_tensor(dt, dtype=dtype, device=device)
    fc = torch.as_tensor(fc, dtype=dtype, device=device)
    steps = torch.arange(step_offset, step_offset + nsteps, device=device)
    t = steps.to(dtype) * dt
    if kind == "ricker":
        return ricker_amplitude(t, fc)
    return sinusoidal_amplitude(t, fc)
