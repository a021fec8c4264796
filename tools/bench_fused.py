"""ms a step of K1's two modes beside K2 on the GPU, over grid sizes and
steps a call.

    python tools/bench_fused.py [--sizes 128,200,...] [--steps 5,8,200] [--check]
                                [--root DIR]

For each size N and each number of steps a call, the bench scene of
bench.py's fdtd rows (4x block, Ricker source at the centre) from a seeded
random state is advanced by back-to-back calls of that many steps (enough
calls for about ``--total`` steps), timed with CUDA events after a warm-up,
in turns: resident K1, streaming K1, K2, K2, streaming K1, resident K1
(resident only where its planner admits the grid). K1 is called as
``simulate`` calls it (``advance_padded`` on the padded state), K2 through
``fdtd_multistep_ttiled``. Prints one JSON line per size, then one with the
card's name and power limit from nvidia-smi.

``--check`` first prints ptxas' report of the K1 kernels and holds both K1
modes to the float64 plain step (1e-5) and to each other bit for bit, at
203x157 with a forced 9 x 7 tile grid and at every size of ``--sizes`` the
resident mode admits (2, 7 and 40 steps from a random state), and exits
non-zero on a mismatch. ``--root`` names the checkout whose
``fdtd2d_tpu_torch`` is imported (default: the one holding this script).
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
SIZES = "128,200,256,512,658,768,910,1024,1034,1536,2048,2304"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    parser.add_argument("--sizes", default=SIZES)
    parser.add_argument("--steps", default="5,8,200")
    parser.add_argument("--total", type=int, default=2000)
    parser.add_argument("--check", action="store_true")
    return parser.parse_args(argv)


def ms_per_step(fn, calls: int, steps: int) -> float:
    """``calls`` back-to-back calls of ``fn`` after a warm-up, CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * steps)


def scene(N: int, M: int, dev, random_medium: bool = False):
    """``(Ez, Hx, Hy), (ce, ch, coef)`` on ``dev``: a seeded random state over
    the bench scene's 4x block, or over a seeded random medium."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdtd.step import precompute_coefficients

    rng = np.random.default_rng(1)
    if random_medium:
        eps = torch.tensor(constants.EPSILON_0 * (1.0 + 3.0 * rng.random((N, M))),
                           dtype=torch.float32, device=dev)
    else:
        eps = torch.full((N, M), constants.EPSILON_0, dtype=torch.float32, device=dev)
        eps[N // 4 : N // 2, M // 4 : M // 3] *= 4.0
    mu = torch.full((N, M), constants.MU_0, dtype=torch.float32, device=dev)
    state = tuple(torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=dev) / scale
                  for shape, scale in (((N, M), 1.0), ((N, M - 1), Z0), ((N - 1, M), Z0)))
    return state, precompute_coefficients(eps, mu, DT, DX)


def resident_plan(N: int, M: int, dev, tiles=None):
    """The resident plan of an (N, M) grid on ``dev``, or None beyond it."""
    from fdtd2d_tpu_torch.ops import fdtd_fused

    try:
        return fdtd_fused.plan_resident(N, M, *fdtd_fused.device_numbers(dev), tiles)
    except ValueError:
        return None


def time_modes(N: int, steps_list, total: int, dev, plain_at=()) -> dict:
    """One row: ms a step of resident K1 (where admitted), streaming K1 and
    K2 at N x N for each number of steps a call, each run twice, in turns;
    the plain float32 step too for the steps a call in ``plain_at``."""
    from fdtd2d_tpu_torch.ops import fdtd_fused, fdtd_ttiled

    state, (ce, ch, coef) = scene(N, N, dev)
    padded = fdtd_fused.pad_state(*state)
    chp = fdtd_fused.pad_field(ch, N, N)
    plan = resident_plan(N, N, dev)
    row = {"size": N, "resident_plan": None if plan is None else
           [plan.variant.index, plan.nth, plan.ntw],
           "k2_plan": list(fdtd_ttiled.pick_sweep_depth(N, N)), "ms_per_step": {}}
    for steps in steps_list:
        tail = (coef, DT, FC, N // 2, N // 2, steps, "ricker", 0)
        fns = {"streaming": lambda: fdtd_fused.advance_padded(*padded, ce, chp, *tail,
                                                              mode="streaming"),
               "K2": lambda: fdtd_ttiled.fdtd_multistep_ttiled(*state, ce, ch, *tail)}
        if plan is not None:
            fns["resident"] = lambda: fdtd_fused.advance_padded(*padded, ce, chp, *tail,
                                                                mode="resident")
        if steps in plain_at:
            fns["plain"] = lambda: fdtd_fused.fdtd_multistep_fused_reference(*state, ce, ch,
                                                                             *tail)
        order = [n for n in ("resident", "streaming", "K2", "plain", "plain", "K2",
                             "streaming", "resident") if n in fns]
        calls = max(total // steps, 1)
        timed = {name: [] for name in order}
        for name in order:
            timed[name].append(ms_per_step(fns[name], calls, steps))
        row["ms_per_step"][steps] = timed
    return row


def check_modes(sizes, dev) -> bool:
    """Both K1 modes against the float64 plain step and each other; prints a
    line a case and returns whether all agreed."""
    from fdtd2d_tpu_torch.ops import fdtd_fused

    all_ok = True
    cases = [(203, 157, (9, 7), (200, 150)), (16, 16, None, (3, 12)), (37, 530, None, (35, 3))] + [
        (N, N, None, (N // 2, N // 2)) for N in sizes if resident_plan(N, N, dev) is not None]
    for N, M, tiles, source in cases:
        state, (ce, ch, coef) = scene(N, M, dev, random_medium=True)
        plan = resident_plan(N, M, dev, tiles)
        for nsteps in (2, 7, 40):
            tail = (DT, FC, *source, nsteps, "ricker", 3)
            res = fdtd_fused.fdtd_multistep_fused(*state, ce, ch, coef, *tail,
                                                  mode="resident", tiles=tiles)
            stream = fdtd_fused.fdtd_multistep_fused(*state, ce, ch, coef, *tail,
                                                     mode="streaming")
            plain = fdtd_fused.fdtd_multistep_fused_reference(
                *(f.double() for f in state), ce.double(), ch.double(), coef.double(),
                *tail)
            torch.cuda.synchronize()
            errs = {}
            for fname, r, s, p in zip(("Ez", "Hx", "Hy"), res, stream, plain):
                scale = float(p.abs().max())
                errs[fname] = {"resident": float((r.double() - p).abs().max()) / scale,
                               "streaming": float((s.double() - p).abs().max()) / scale,
                               "equal": bool(torch.equal(r, s))}
            ok = all(e["equal"] and e["resident"] <= 1e-5 and e["streaming"] <= 1e-5
                     for e in errs.values())
            all_ok &= ok
            print(json.dumps({"check": [N, M], "variant": plan.variant.index,
                              "tiles": [plan.nth, plan.ntw], "steps": nsteps, "ok": ok,
                              "errors": errs}), flush=True)
    return all_ok


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fused: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    from fdtd2d_tpu_torch.ops import _build
    from fdtd2d_tpu_torch.utils.metrics import device_info

    dev = torch.device("cuda:0")
    sizes = [int(n) for n in args.sizes.split(",")]
    if args.check:
        log = _build.build().parent / "build.log"
        name = "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line) and any(
                    k in name for k in ("resident_steps", "e_update", "h_update")):
                print(f"ptxas {name[:60]}: {line.strip()}", flush=True)
        if not check_modes(sizes, dev):
            return 1
    for N in sizes:
        print(json.dumps(time_modes(N, [int(s) for s in args.steps.split(",")], args.total,
                                    dev)), flush=True)
        torch.cuda.empty_cache()
    info = device_info()
    print(json.dumps({"card": info["name"], "power_limit": info["power_limit"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
