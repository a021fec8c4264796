"""The upstream's low-pass filter scene (github.com/skunnavakkam/fdtd-2d,
python-src/inverse_design.py:38-61) on an N x N grid over its 250 mm
domain, every index of its 250-cell grid scaled by N/250 and rounded:
vacuum with two eps = 3 waveguide arms (rows 100-150, columns 0-75 and
175-250), a line source of amplitude 3 (rows 110-140, column 40), the
design region (rows and columns 75-175) and the probe (rows 110-140,
column 210). Relative permittivity, float64; each region a pair of
(start, stop) index pairs, rows then columns."""

import numpy as np

UPSTREAM_GRID = 250


def make(N: int, *, arm_eps: float = 3.0, source_amp: float = 3.0):
    scale = N / UPSTREAM_GRID

    def r(v):
        return int(round(v * scale))

    eps = np.ones((N, N))
    eps[r(100) : r(150), 0 : r(75)] = arm_eps
    eps[r(100) : r(150), r(175) : N] = arm_eps
    source = np.zeros((N, N))
    source[r(110) : r(140), r(40)] = source_amp
    return {"eps": eps, "source": source,
            "design": ((r(75), r(175)), (r(75), r(175))),
            "probe": ((r(110), r(140)), (r(210), r(210) + 1))}
