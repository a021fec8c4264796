"""Canonical benchmark/test scenes (a copy of ``fdtd2d_tpu/core/scenes.py``).

The hard scene thresholds a blurred uniform field at its MEDIAN, so it has a
genuine 50% duty cycle at any feature size (a threshold far from the median
gives an accidentally near-uniform medium). It matches the surrogate datagen
distribution (binary eps0 / 5*eps0) at benchmark scale: the regime the
direct sublattice factorization (fdfd/direct.py) owns.
"""

from __future__ import annotations

import numpy as np

from fdtd2d_tpu_torch import constants


def hard_binary_scene(N: int, *, seed: int = 7, sigma: float | None = None,
                      contrast: float = 5.0, source_xy=None,
                      source_amp: float = 1.0):
    """50%-duty binary ``contrast``x permittivity scene with a point source.

    Returns ``(eps, mu, src)`` float64 numpy arrays. ``sigma`` (feature
    size of the blurred-noise threshold mask) defaults to ``N / 64`` so
    features scale with the grid; the mask thresholds at the MEDIAN of the
    blurred field, guaranteeing a genuine 50% duty cycle at any sigma.
    """
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    blur = gaussian_filter(rng.random((N, N)),
                           sigma=N / 64 if sigma is None else sigma)
    eps = np.where(blur > np.median(blur), contrast, 1.0) * constants.EPSILON_0
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    sx, sy = (N // 2, N // 2) if source_xy is None else source_xy
    src[sx, sy] = source_amp
    return eps, mu, src
