"""ms a step of K2 and K3 mode on the GPU, for one checkout of the port.

    python tools/bench_ttiled.py [--root DIR] [--ksweep 2,4,6,8]

``--root`` names the checkout whose ``fdtd2d_tpu_torch`` is imported (by
default the one holding this script), so that one call to the card can time
two versions of the kernel, each in its own process, in turns (for example
the parent commit unpacked with ``git archive`` into a git-ignored
directory: parent, this tree, this tree, parent). It checks no parity:
``chip_smoke.py`` phases 6-8 hold the kernel to the float64 plain step.

1. ms a step on the bench scene of bench.py's fdtd rows (4x block, Ricker
   source at the centre) from a seeded random state, CUDA events after a
   warm-up, in turns: K1, K2, K2, K1 at 4096^2 (500 steps a run) and 8192^2
   (200); K1, K3, K3, K1 at 2048^2 (1000).
2. ``--ksweep``: K2's ms a step at 4096^2 for each sweep depth listed, the
   tiles of ``plan_tiles`` at that depth, each depth timed twice (the list,
   then the list reversed).

Prints one JSON line with the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

DT, DX, FC = 5e-14, 1e-4, 30e9
Z0 = 376.73  # vacuum impedance: scales the random H to the random Ez


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--ksweep", default="")
    return parser.parse_args(argv)


def ms_per_step(fn, steps: int) -> float:
    """One timed run of ``fn`` after one warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ttiled: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdtd.step import precompute_coefficients
    from fdtd2d_tpu_torch.ops import fdtd_blocked, fdtd_fused, fdtd_ttiled
    from fdtd2d_tpu_torch.utils.metrics import device_info

    dev = torch.device("cuda:0")
    out = {"root": str(args.root)}

    def scene(N):
        eps = torch.full((N, N), constants.EPSILON_0, dtype=torch.float32, device=dev)
        eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
        mu = torch.full((N, N), constants.MU_0, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(1)
        state = tuple(torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                                   device=dev) / scale
                      for shape, scale in (((N, N), 1.0), ((N, N - 1), Z0), ((N - 1, N), Z0)))
        return state, precompute_coefficients(eps, mu, DT, DX)

    def runs(N, steps, fields, coeffs, K=None):
        tail = (*coeffs, DT, FC, N // 2, N // 2, steps, "ricker", 0)
        return {"K1": lambda: fdtd_fused.fdtd_multistep_fused(*fields, *tail),
                "K2": lambda: fdtd_ttiled.fdtd_multistep_ttiled(*fields, *tail, K=K),
                "K3": lambda: fdtd_blocked.fdtd_multistep_blocked(*fields, *tail)}

    # -- 1. ms a step -------------------------------------------------------------
    times = {}
    for N, steps, order in ((4096, 500, ("K1", "K2", "K2", "K1")),
                            (8192, 200, ("K1", "K2", "K2", "K1")),
                            (2048, 1000, ("K1", "K3", "K3", "K1"))):
        fields, coeffs = scene(N)
        fns = runs(N, steps, fields, coeffs)
        timed = {name: [] for name in order}
        for name in order:
            timed[name].append(ms_per_step(fns[name], steps))
        times[N] = {"ms_per_step": timed, "best": {k: min(v) for k, v in timed.items()},
                    "plan": list(fdtd_ttiled.resolve_plan(N, N, 1 if "K3" in order else None))}
        del fields, coeffs, fns
        torch.cuda.empty_cache()
    out["times"] = times

    # -- 2. K sweep at 4096^2 -------------------------------------------------------
    if args.ksweep:
        depths = [int(k) for k in args.ksweep.split(",")]
        fields, coeffs = scene(4096)
        sweep = {K: [] for K in depths}
        for K in depths + depths[::-1]:
            sweep[K].append(ms_per_step(runs(4096, 480, fields, coeffs, K)["K2"], 480))
        out["ksweep_4096"] = {K: {"ms_per_step": v,
                                  "plan": list(fdtd_ttiled.resolve_plan(4096, 4096, K))}
                              for K, v in sweep.items()}
    info = device_info()
    out["card"], out["power_limit"] = info["name"], info["power_limit"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
