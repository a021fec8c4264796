"""Reference workflow 3: the tiled (domain-decomposed) solve beside the
global one (counterpart of ``examples/tiled_vs_direct.py``).

One scene, a 2.5x dielectric block and a point source, solved by the
global FDM-FGMRES (``run_fdfd(tol=1e-6, maxiter=600)``) and by the tiled
Schwarz solver in its krylov mode (two-level ORAS with a partition of unity
inside complex128 refinement: ``run_fdfd_tiled(patch_size=100, padding=30,
mode="krylov", solver_maxiter=240, refine_target=1e-8)``), with the true
residuals of the tiled iterate and of its complex64 downcast and the field
error between the two solves. The geometry is the JAX script's on its 512^2
grid; another ``N`` moves every index by ``N / 512`` (pass a patch and
padding that fit it).

Writes ``OUT/tiled_vs_direct.npz`` (both real fields over their common
max |Ez|, float16) and ``tiled_vs_direct.png``.

Run: python -m fdtd2d_tpu_torch.apps.tiled_vs_direct [--device cuda|cpu]
        [--out DIR] [--draw DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.apps._common import cli, scaled, timed
from fdtd2d_tpu_torch.fdfd import run_fdfd, run_fdfd_tiled

N0 = 512
DX, OMEGA = 1e-3, 17e9
TOL, MAXITER = 1e-6, 600                       # the global solve
SOLVER_MAXITER, REFINE_TARGET = 240, 1e-8      # the tiled one


def block_scene(N: int = N0):
    """``(eps, mu, source)`` numpy arrays of the script's scene at ``N``."""
    def s(v):
        return scaled(v, N, N0)

    eps = np.full((N, N), constants.EPSILON_0)
    eps[s(180):s(330), s(140):s(240)] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N), np.float32)
    source[N // 2, N // 2] = 10.0
    return eps, mu, source


def run(N: int = N0, patch_size: int = 100, padding: int = 30, *, device="cuda",
        out=None) -> dict:
    """The script's two solves; returns its numbers (fields under ``arrays``)."""
    eps, mu, source = block_scene(N)
    direct, direct_s = timed(lambda: run_fdfd(eps, mu, DX, DX, OMEGA, source, tol=TOL,
                                              maxiter=MAXITER, device=device), device)
    print(f"global solve residual: {float(direct.relative_residual):.2e}")

    # krylov mode: two-level ORAS+PoU preconditioner + complex128 iterative
    # refinement; the stationary modes reproduce the reference's approximate
    # behavior
    (tiled, trace), tiled_s = timed(lambda: run_fdfd_tiled(
        eps, mu, DX, DX, OMEGA, source, patch_size=patch_size, padding=padding,
        mode="krylov", solver_maxiter=SOLVER_MAXITER, refine_target=REFINE_TARGET,
        device=device), device)
    print(f"tiled (krylov) iterate true residual: {trace[-2]:.2e}; "
          f"returned-field (c64 downcast) residual: {trace[-1]:.2e}")

    a = direct.x.real.cpu().numpy()
    b = tiled.real.cpu().numpy()
    err = float(np.abs(a - b).max() / np.abs(a).max())
    print(f"tiled vs direct relative field error: {err:.2e}")
    if out is not None:
        m = float(max(np.abs(a).max(), np.abs(b).max())) or 1.0
        np.savez_compressed(os.path.join(out, "tiled_vs_direct.npz"),
                            direct=(a / m).astype(np.float16), tiled=(b / m).astype(np.float16),
                            max_abs=m)
    return {"N": N, "patch_size": patch_size, "padding": padding,
            "solver_maxiter": SOLVER_MAXITER, "refine_target": REFINE_TARGET,
            "tol": TOL, "maxiter": MAXITER,
            "direct_relative_residual": float(direct.relative_residual),
            "direct_converged": bool(direct.converged),
            "direct_iterations": int(direct.iterations), "direct_s": direct_s,
            "tiled_iterate_residual": float(trace[-2]), "tiled_returned_residual": float(trace[-1]),
            "tiled_rounds": len(trace) - 2, "tiled_trace": [float(t) for t in trace],
            "tiled_s": tiled_s, "field_error": err,
            "arrays": {"direct": direct.x.cpu().numpy(), "tiled": tiled.cpu().numpy()}}


def draw(out_dir: str) -> list:
    from fdtd2d_tpu_torch.viz.plots import plot_ref_v_inference

    d = np.load(os.path.join(out_dir, "tiled_vs_direct.npz"))
    path = os.path.join(out_dir, "tiled_vs_direct.png")
    plot_ref_v_inference(d["direct"].astype(np.float32), d["tiled"].astype(np.float32), path)
    return [path]


def main(argv=None) -> int:
    return cli("tiled_vs_direct", __doc__, run, draw, argv)


if __name__ == "__main__":
    sys.exit(main())
