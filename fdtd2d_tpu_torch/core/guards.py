"""Physics stability / resolution guards.

Equivalents of the reference's inline runtime asserts:
- Courant condition (reference: python-src/fdtd.py:24-28)
- FDFD resolution window lambda/20 <= dx <= lambda/10
  (reference: python-src/fdfd.py:97-105)
"""

from __future__ import annotations

import numpy as np


def courant_number(eps, mu, dt: float, dx: float) -> float:
    c = 1.0 / np.sqrt(float(np.min(eps)) * float(np.min(mu)))
    return c * dt / dx


def check_courant(eps, mu, dt: float, dx: float) -> float:
    """Raise if the explicit leapfrog scheme would be unstable."""
    courant = courant_number(eps, mu, dt, dx)
    if courant > 1.0:
        raise ValueError(
            f"Courant stability condition not met: c*dt/dx = {courant:.4f} > 1"
        )
    return courant


def min_wavelength(eps, mu, omega: float) -> float:
    c_min = float(np.min(1.0 / np.sqrt(np.asarray(eps) * np.asarray(mu))))
    return c_min / omega


def check_resolution(eps, mu, omega: float, dx: float) -> None:
    """Enforce the lambda/20 <= dx <= lambda/10 sampling window."""
    lam = min_wavelength(eps, mu, omega)
    if dx > lam / 10.0:
        raise ValueError(
            f"dx must be <= lambda_min/10: dx={dx:g}, lambda_min/10={lam / 10.0:g}"
        )
    if dx < lam / 20.0:
        raise ValueError(
            f"dx too small (< lambda_min/20 = {lam / 20.0:g}); "
            "you're throwing away compute"
        )
