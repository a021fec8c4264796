"""Device-time profile of one FDTD rollout on the GPU, with torch.profiler.

    python tools/profile_fdtd.py [--size 2048] [--steps 200] [--frames 0]
                                 [--backends fused,torch] [--mesh RxC] [--out DIR]
    python tools/profile_fdtd.py --size 4096 --backends ttiled,fused
    python tools/profile_fdtd.py --size 200 --steps 1000 --frames 200 --backends fused,ttiled
    python tools/profile_fdtd.py --size 8192 --steps 64 --backends ttiled --mesh 2x2

``--frames n`` cuts the rollout into n frames (``simulate``'s ``nframes``), so
that each kernel call advances ``steps / n`` steps, as the CLI's rollouts do.
``--mesh RxC`` (or ``R`` for a 1D mesh of row blocks) runs the rollout through
``simulate_sharded`` on a mesh whose every entry is the one card: the halo
exchange's strip copies and one K2 launch a block a sweep (no copy between
two cards is made).
For each backend of ``--backends`` (``fused``: K1; ``ttiled``: K2; ``torch``:
the plain path) it runs the bench scene of ``bench.py``'s fdtd rows (2048^2
by default: a 4x dielectric block, Ricker source at the centre, fc 30 GHz,
dt 5e-14 s, dx 1e-4 m, float32) through ``simulate`` once to warm up, then
once more from the warm-up's state under torch.profiler, with the scene
already on the card. It writes each window's Chrome trace to ``--out`` (by
default ``profile/`` in the repo's git-ignored output directory) and
prints one JSON line per backend, then the card's name and power limit as
nvidia-smi gives them:

- ``wall_ms``: host clock around the profiled call, with the device
  synchronized before and after, so it includes the profiler's host cost;
  ``wall_unprofiled_ms``: the same call once more with no profiler;
- ``device_busy_ms``: the union of the trace's device intervals (kernels,
  memcpy, memset), so that work that overlaps counts once;
- ``busy_share``: ``device_busy_ms / wall_ms``;
- ``idle_gaps``: the gaps between device intervals, from the first device
  interval to the last: their count, total, and the longest five with their
  start, in microseconds from the first device interval;
- ``device_launches``: the kernels, copies and memsets of the window;
- ``kernels``: per kernel name, its calls, total and per-call microseconds
  (for K2 a call is one sweep of K steps), and microseconds per step
  (total / steps).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
BACKENDS = ("fused", "ttiled", "torch")


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + (cur_end - cur_start if cur_end is not None else 0.0)


def idle_gaps(intervals, top: int = 5) -> dict:
    """Gaps between the union of ``(start, end)`` intervals, from the first
    start to the last end: count, total, and the ``top`` longest as
    ``[offset from the first start, length]``."""
    gaps, first, cur_end = [], None, None
    for start, end in sorted(intervals):
        if first is None:
            first = start
        elif start > cur_end:
            gaps.append([cur_end - first, start - cur_end])
        cur_end = end if cur_end is None else max(cur_end, end)
    return {"count": len(gaps), "total_us": sum(g[1] for g in gaps),
            "longest": sorted(gaps, key=lambda g: -g[1])[:top]}


def summarize(trace_path: Path, steps: int, wall_s: float) -> dict:
    events = json.loads(trace_path.read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not any(e["cat"] == "kernel" for e in device):
        raise RuntimeError(f"{trace_path} holds no kernel on the device")
    kernels = {}
    for e in device:
        if e["cat"] != "kernel":
            continue
        k = kernels.setdefault(e["name"], {"calls": 0, "total_us": 0.0})
        k["calls"] += 1
        k["total_us"] += e["dur"]
    for k in kernels.values():
        k["us_per_call"] = k["total_us"] / k["calls"]
        k["us_per_step"] = k["total_us"] / steps
    intervals = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    busy_us = union_us(intervals)
    memcpy_us = sum(e["dur"] for e in device if e["cat"] != "kernel")
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / (wall_s * 1e3),
            "memcpy_memset_ms": memcpy_us / 1e3, "device_launches": len(device),
            "idle_gaps": idle_gaps(intervals),
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["total_us"]))}


def backend_list(text: str):
    """``--backends``: a comma-separated list of names in BACKENDS."""
    names = [name for name in text.split(",") if name]
    bad = [name for name in names if name not in BACKENDS]
    if bad or not names:
        raise argparse.ArgumentTypeError(f"backends must be among {BACKENDS}, got {text!r}")
    return names


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--frames", type=int, default=0)
    parser.add_argument("--backends", type=backend_list, default=["fused", "torch"])
    parser.add_argument("--mesh", type=lambda text: tuple(int(d) for d in text.split("x")),
                        default=None)
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "profile")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fdtd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate
    from fdtd2d_tpu_torch.parallel import make_mesh, simulate_sharded
    from fdtd2d_tpu_torch.utils.metrics import Timer, device_info

    N, dev = args.size, torch.device("cuda:0")
    if args.mesh is None:
        run, tag = simulate, ""
    else:
        mesh = make_mesh(args.mesh, devices=[dev] * math.prod(args.mesh))
        tag = "_mesh" + "x".join(map(str, args.mesh))

        def run(eps, mu, cfg, state=None):
            return simulate_sharded(eps, mu, cfg, mesh, state=state)

    eps = torch.full((N, N), constants.EPSILON_0, dtype=torch.float32, device=dev)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    mu = torch.full((N, N), constants.MU_0, dtype=torch.float32, device=dev)
    args.out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for backend in args.backends:
        cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=args.steps, source_xy=(N // 2, N // 2),
                         source_fc=30e9, nframes=args.frames, backend=backend,
                         device="cuda")
        state, _ = run(eps, mu, cfg)
        with torch.profiler.profile(activities=activities) as prof:
            with Timer(dev) as timer:
                run(eps, mu, cfg, state=state)
        with Timer(dev) as plain_timer:  # the same call with no profiler attached
            run(eps, mu, cfg, state=state)
        trace = args.out / f"trace_{backend}_{N}_{args.frames}{tag}.json"
        prof.export_chrome_trace(str(trace))
        summary = summarize(trace, args.steps, timer.seconds)
        print(json.dumps({"backend": backend, "size": N, "steps": args.steps,
                          "frames": args.frames, "mesh": args.mesh,
                          "wall_unprofiled_ms": plain_timer.seconds * 1e3,
                          "trace": str(trace.relative_to(ROOT)) if trace.is_relative_to(ROOT)
                          else str(trace), **summary}))
    print(device_info()["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
