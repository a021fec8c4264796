"""The JAX repo's six example workflows at the JAX scripts' own sizes on the
card, each a process of the port (``python -m fdtd2d_tpu_torch.apps.NAME``):

    python tools/examples_run.py [--only NAME[,NAME]] [--deadline SECONDS]
        [--out assets/torch_examples] [--export DIR]

In order (``--only`` picks some):

- ``ring_resonator``: 512^2, ``run_fdfd(rhs_scale=omega, tol=1e-5, maxiter=600)``;
- ``tiled_vs_direct``: 512^2, ``run_fdfd`` beside ``run_fdfd_tiled`` (patch 100,
  padding 30, krylov, solver_maxiter 240, refine_target 1e-8);
- ``fdtd_video``: 200^2, 1000 steps, 200 frames (``auto`` -> K1 resident);
- ``rank_study``: 1024^2, complex128;
- ``direct_large``: three processes, checkpointed (stride 64) and
  compressed at 2048^2, HPS at 1024^2, each to a true
  residual of 1e-8 with the 8-source sweep;
- ``inverse_design_decade``: 848^2, 10 frequencies, 100 Adam steps.

Each process writes its npz, JSON and log under ``--out`` (the log
``NAME[_ARGS].log``). With
``--deadline`` every process still running that many seconds after the
script began gets SIGTERM (the decade driver then stops after the step in
flight and still evaluates and saves the design it reached), and the
processes not yet started are skipped. The summary, the card's name and
power limit, each process's exit code, seconds and last JSON line, goes to
``OUT/examples_run.json`` and is printed as the last line; ``--export DIR``
copies everything in ``--out`` to DIR.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from surrogate_run import _last_json, _stream  # noqa: E402

# (workflow, positional arguments of each of its processes): the JAX scripts' sizes
RUNS = {
    "ring_resonator": [[]],
    "tiled_vs_direct": [[]],
    "fdtd_video": [[]],
    "rank_study": [[]],
    "direct_large": [["2048", "64", "checkpointed"], ["2048", "64", "compressed"],
                     ["1024", "64", "hps"]],
    "inverse_design_decade": [["100"]],
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", default=",".join(RUNS),
                   help=f"comma-separated workflows, of {', '.join(RUNS)}")
    p.add_argument("--deadline", type=float, default=None,
                   help="SIGTERM what still runs this many seconds after the script began")
    p.add_argument("--out", type=Path, default=Path("assets/torch_examples"))
    p.add_argument("--export", type=Path, default=None)
    args = p.parse_args(argv)
    names = [n for n in args.only.split(",") if n]
    unknown = sorted(set(names) - set(RUNS))
    if unknown:
        raise SystemExit(f"unknown workflows {unknown}; expected some of {list(RUNS)}")
    out = args.out if args.out.is_absolute() else ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    summary = {"runs": []}
    failed = False
    for name in names:
        for extra in RUNS[name]:
            tag = "_".join([name, *extra])
            entry = {"workflow": name, "args": extra}
            if args.deadline is not None and time.perf_counter() - t0 >= args.deadline:
                entry["skipped_at_deadline"] = True
                summary["runs"].append(entry)
                print(f"{tag}: skipped, past the deadline", flush=True)
                continue
            start = time.perf_counter() - t0
            cmd = [sys.executable, "-m", f"fdtd2d_tpu_torch.apps.{name}", *extra,
                   "--device", "cuda", "--out", str(out)]
            rc, lines, stopped = _stream(cmd, out / f"{tag}.log", t0, deadline=args.deadline)
            entry.update(rc=rc, seconds=(lines[-1][0] if lines else start) - start,
                         terminated_at_deadline=stopped)
            try:
                entry["numbers"] = _last_json(lines)
            except StopIteration:
                entry["numbers"] = None
            failed |= rc != 0 and not stopped or entry["numbers"] is None
            summary["runs"].append(entry)

    from fdtd2d_tpu_torch.utils.metrics import device_info

    summary["card"] = device_info()["nvidia_smi"]
    summary["wall_s"] = time.perf_counter() - t0
    (out / "examples_run.json").write_text(json.dumps(summary, indent=1))
    if args.export is not None:
        dest = args.export if args.export.is_absolute() else ROOT / args.export
        dest.mkdir(parents=True, exist_ok=True)
        for f in out.iterdir():
            if f.is_file():
                shutil.copy2(f, dest / f.name)
    print(json.dumps(summary), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
