"""Reference workflow 2: steady-state FDFD of a ring resonator (counterpart
of ``examples/ring_resonator.py``).

A bus waveguide coupled to a ring resonator, driven by a line source at a
fixed frequency, solved in the frequency domain with FDM-preconditioned
FGMRES (``run_fdfd(rhs_scale=omega, tol=1e-5, maxiter=600)``, the reference
driver's convention) and rendered. The geometry is the JAX script's on its
512^2 grid; another ``N`` moves every index by ``N / 512``.

Writes ``OUT/ring_resonator.npz`` (Ez / max|Ez| and the relative
permittivity, float16) and ``ring_resonator_Ez.png``.

Run: python -m fdtd2d_tpu_torch.apps.ring_resonator [--device cuda|cpu]
        [--out DIR] [--draw DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.apps._common import cli, half, scaled, timed
from fdtd2d_tpu_torch.core import RegionDrawer, check_resolution
from fdtd2d_tpu_torch.fdfd import run_fdfd

N0 = 512
DX, OMEGA = 1e-3, 17e9
TOL, MAXITER = 1e-5, 600


def ring_scene(N: int = N0):
    """``(eps, mu, source)`` numpy arrays of the script's scene at ``N``."""
    def s(v):
        return scaled(v, N, N0)

    drawer = RegionDrawer(N, N)
    drawer.draw_waveguide((s(60), s(160)), (N - s(60), s(160)), s(10))   # bus waveguide
    drawer.draw_ring_resonator((N // 2, s(280)), s(90), s(10))           # ring below it
    eps = drawer.to_eps(black_point=3.0)
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N), np.float32)
    source[s(150):s(170), s(80)] = 10.0   # line source feeding the bus guide
    return eps, mu, source


def run(N: int = N0, *, device="cuda", out=None) -> dict:
    """The script's solve; returns its numbers (the field under ``arrays``)."""
    eps, mu, source = ring_scene(N)
    check_resolution(eps, mu, OMEGA, DX)
    res, seconds = timed(lambda: run_fdfd(eps, mu, DX, DX, OMEGA, source,
                                          rhs_scale=OMEGA,  # reference driver convention
                                          tol=TOL, maxiter=MAXITER, device=device), device)
    print(f"relative residual: {float(res.relative_residual):.2e}")
    Ez = res.x.real.cpu().numpy()
    if out is not None:
        Ez16, m = half(Ez)
        np.savez_compressed(os.path.join(out, "ring_resonator.npz"), Ez=Ez16, max_abs_Ez=m,
                            eps_r=(eps / constants.EPSILON_0).astype(np.float16))
    return {"N": N, "dx": DX, "omega": OMEGA, "tol": TOL, "maxiter": MAXITER,
            "relative_residual": float(res.relative_residual),
            "converged": bool(res.converged), "iterations": int(res.iterations),
            "seconds": seconds, "max_abs_Ez": float(np.abs(Ez).max()),
            "arrays": {"x": res.x.cpu().numpy(), "eps": eps}}


def draw(out_dir: str) -> list:
    from fdtd2d_tpu_torch.viz import plot_Ez

    d = np.load(os.path.join(out_dir, "ring_resonator.npz"))
    path = os.path.join(out_dir, "ring_resonator_Ez.png")
    plot_Ez(d["Ez"].astype(np.float64), d["eps_r"].astype(np.float64) * constants.EPSILON_0,
            path, vmax=1.0, vmin=-1.0)
    return [path]


def main(argv=None) -> int:
    return cli("ring_resonator", __doc__, run, draw, argv)


if __name__ == "__main__":
    sys.exit(main())
