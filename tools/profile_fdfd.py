"""Device-time profile of the FDFD solves on the GPU, with torch.profiler.

    python tools/profile_fdfd.py [--size 512] [--paths factor,direct,fgmres] [--out DIR]

On the scene of ``bench.py``'s fdfd512 rows (512^2 by default: a 2.5x
dielectric block, a point source at the centre carrying -1j*omega, dx 1e-3 m,
omega 17e9, PML 40), for each path of ``--paths``:

- ``factor``: one ``DirectSolver`` construction (complex64 stacked
  block-Thomas factors) to warm up, then a second one under torch.profiler;
- ``direct``: a ``DirectSolver``, one warm-up solve, then one warm solve
  with ``rhs_scale=1.0, refine_target=1e-6`` under torch.profiler;
- ``fgmres``: FDM-preconditioned FGMRES in complex64 (restart 20, tol 1e-6,
  maxiter 3000, the fdfd512iter row), one warm-up solve, then one under
  torch.profiler.

It writes each window's Chrome trace to ``--out`` (by default ``profile/`` in
the repo's git-ignored output directory) and prints one JSON line per path,
then the card's name and power limit as nvidia-smi gives them. Besides the
fields of tools/profile_fdtd.py's summary (wall, device busy and busy
share, idle gaps, per-kernel calls and microseconds), a line holds
``launches`` (device kernels in the window), ``launches_per_ms`` of wall
time, and the solve's own result (residual trace or iterations).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from profile_fdtd import summarize  # noqa: E402

PATHS = ("factor", "direct", "fgmres")
TOP = 12


def path_list(text: str):
    """``--paths``: a comma-separated list of names in PATHS."""
    names = [name for name in text.split(",") if name]
    bad = [name for name in names if name not in PATHS]
    if bad or not names:
        raise argparse.ArgumentTypeError(f"paths must be among {PATHS}, got {text!r}")
    return names


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--paths", type=path_list, default=list(PATHS))
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "profile")
    return parser.parse_args(argv)


def window_summary(trace: Path, wall_s: float) -> dict:
    """The profile_fdtd summary of one solve (a "step" is the whole solve),
    with the launch count and the top kernels only."""
    s = summarize(trace, steps=1, wall_s=wall_s)
    launches = sum(k["calls"] for k in s["kernels"].values())
    top = dict(list(s["kernels"].items())[:TOP])
    for k in top.values():
        del k["us_per_step"]
    return {**s, "launches": launches, "launches_per_ms": launches / s["wall_ms"],
            "kernel_names": len(s["kernels"]), "kernels": top}


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fdfd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver
    from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator
    from fdtd2d_tpu_torch.utils.metrics import Timer, device_info

    N, dx, omega, dev = args.size, 1e-3, 17e9, torch.device("cuda:0")
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex128)
    src[N // 2, N // 2] = -1j * omega
    args.out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    for path in args.paths:
        if path == "factor":
            def run():
                return {"factor_growth": DirectSolver(eps, mu, dx, dx, omega,
                                                      device=dev).factor_growth}
        elif path == "direct":
            solver = DirectSolver(eps, mu, dx, dx, omega, device=dev)

            def run():
                return {"residual_trace": solver.solve(src, rhs_scale=1.0,
                                                          refine_target=1e-6)[1]}
        else:
            op = make_operator(eps, mu, dx, dx, omega, device=dev)
            b = torch.tensor(src, dtype=torch.complex64, device=dev)
            M, _ = resolve_preconditioner(op, "fdm")

            def run():
                res = solve_fdfd(op, b, preconditioner=M, tol=1e-6, maxiter=3000, restart=20)
                return {"iterations": res.iterations,
                        "relative_residual": res.relative_residual}
        run()
        with torch.profiler.profile(activities=activities) as prof:
            with Timer(dev) as timer:
                result = run()
        trace = args.out / f"trace_fdfd_{path}_{N}.json"
        prof.export_chrome_trace(str(trace))
        print(json.dumps({"path": path, "size": N, **result,
                          "trace_file": str(trace.relative_to(ROOT))
                          if trace.is_relative_to(ROOT) else str(trace),
                          **window_summary(trace, timer.seconds)}))
    print(device_info()["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
