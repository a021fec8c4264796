"""bench.py's FDTD scene, copied: vacuum with a 4x dielectric block at
[N/4:N/2, N/4:N/3]; float32 (eps, mu)."""

import numpy as np

EPSILON_0 = 8.85418e-12
MU_0 = 4.0e-7 * 3.141592653589793


def make(N: int):
    eps = np.full((N, N), EPSILON_0, np.float32)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    mu = np.full((N, N), MU_0, np.float32)
    return eps, mu
