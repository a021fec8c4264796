"""core/scenes.py's hard scene, copied: uniform noise from ``seed``,
blurred at sigma N/64 and thresholded at its median, so that half the cells
hold ``contrast`` x eps0 at any size; float64 (eps, mu)."""

import numpy as np

EPSILON_0 = 8.85418e-12
MU_0 = 4.0e-7 * 3.141592653589793


def make(N: int, *, seed: int, contrast: float = 5.0):
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    blur = gaussian_filter(rng.random((N, N)), sigma=N / 64)
    eps = np.where(blur > np.median(blur), contrast, 1.0) * EPSILON_0
    mu = np.full((N, N), MU_0)
    return eps, mu
