"""The JAX package's own readings, on the CPU, of two results of the
example workflows that depart from the JAX records (ROADMAP Queue 3):

    JAX_PLATFORMS=cpu python tools/examples_jax_witness.py [fdfd512] [hps N]

- ``fdfd512``: ``run_fdfd`` on ``examples/tiled_vs_direct.py``'s 512^2 scene
  (``tol=1e-6, maxiter=600``) and on ``examples/ring_resonator.py``'s
  (``rhs_scale=omega, tol=1e-5, maxiter=600``): the relative residual and
  the package's ``converged`` (relative residual < 10 tol).
- ``hps N`` (N = 1024 by default): ``DirectSolver(hps=True)`` on
  ``examples/direct_large.py``'s hard scene at N^2; for each of the script's
  8 sweep sources, the true residual after one complex64 solve (the
  factor's raw accuracy: ``trace[1]`` of a one-round solve); the source's
  own solve to 1e-8 (its trace); and the script's ``solve_batched`` sweep to
  1e-8 (its worst-residual trace and each source's last residual).

With no argument both run. The last line is one JSON object of the
readings. This is the reference side of the port's card runs
(``tools/examples_run.py``); it imports the JAX package, never the port.
"""

from __future__ import annotations

import json
import sys
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from fdtd2d_tpu import constants  # noqa: E402
from fdtd2d_tpu.core import RegionDrawer  # noqa: E402
from fdtd2d_tpu.core.scenes import hard_binary_scene  # noqa: E402
from fdtd2d_tpu.fdfd import run_fdfd  # noqa: E402
from fdtd2d_tpu.fdfd.direct import DirectSolver  # noqa: E402

OMEGA, DX = 17e9, 1e-3


def fdfd512() -> dict:
    N = 512
    eps = np.full((N, N), constants.EPSILON_0)             # examples/tiled_vs_direct.py
    eps[180:330, 140:240] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    source = np.zeros((N, N), np.float32)
    source[N // 2, N // 2] = 10.0
    tvd = run_fdfd(eps, mu, DX, DX, OMEGA, source, tol=1e-6, maxiter=600)

    drawer = RegionDrawer(N, N)                            # examples/ring_resonator.py
    drawer.draw_waveguide((60, 160), (N - 60, 160), 10)
    drawer.draw_ring_resonator((N // 2, 280), 90, 10)
    ring_eps = drawer.to_eps(black_point=3.0)
    ring_source = np.zeros((N, N), np.float32)
    ring_source[150:170, 80] = 10.0
    ring = run_fdfd(ring_eps, mu, DX, DX, OMEGA, ring_source, rhs_scale=OMEGA, tol=1e-5,
                    maxiter=600)
    out = {}
    for name, res in (("tiled_vs_direct_run_fdfd", tvd), ("ring_resonator_run_fdfd", ring)):
        out[name] = {"relative_residual": float(res.relative_residual),
                     "converged": bool(res.converged)}
        print(f"{name} at 512^2: relative residual {out[name]['relative_residual']:.3e}, "
              f"converged {out[name]['converged']}", flush=True)
    return out


def hps(N: int) -> dict:
    eps, mu, src = hard_binary_scene(N, seed=7, source_xy=(N // 3, N // 3))
    rng = np.random.default_rng(11)                        # examples/direct_large.py's sweep
    srcs = np.zeros((8, N, N), np.complex64)
    srcs[0] = src
    for i in range(1, 8):
        r, c = rng.integers(N // 4, 3 * N // 4, 2)
        srcs[i, r, c] = 10.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the stall warnings: read below
        solver = DirectSolver(eps, mu, DX, DX, OMEGA, hps=True)
        raw = [float(solver.solve(s, refine_target=1e-8, max_refine_rounds=1)[1][1])
               for s in srcs]
        print(f"hps {N}^2: raw residual a source {[f'{v:.2e}' for v in raw]}", flush=True)
        _, trace = solver.solve(src, refine_target=1e-8)
        print(f"hps {N}^2: the source's solve, {len(trace) - 2} rounds, trace "
              f"{[f'{v:.2e}' for v in trace]}", flush=True)
        _, per, btrace = solver.solve_batched(srcs, refine_target=1e-8)
    per = [float(v) for v in np.asarray(per)]
    print(f"hps {N}^2: 8-source sweep, {len(btrace) - 1} rounds, worst "
          f"{[f'{v:.2e}' for v in btrace]}; last a source {[f'{v:.2e}' for v in per]}",
          flush=True)
    return {f"hps_{N}": {"raw_residuals": raw, "factor_growth": float(solver.factor_growth),
                         "solve_trace": [float(v) for v in trace], "solve_rounds": len(trace) - 2,
                         "sweep_trace": [float(v) for v in btrace],
                         "sweep_rounds": len(btrace) - 1, "sweep_last": per}}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv) or ["fdfd512", "hps"]
    out = {}
    while argv:
        what = argv.pop(0)
        if what == "fdfd512":
            out.update(fdfd512())
        elif what == "hps":
            out.update(hps(int(argv.pop(0)) if argv and argv[0].isdigit() else 1024))
        else:
            raise SystemExit(f"unknown reading {what!r}: fdfd512 or hps [N]")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
