"""Readings that set the check's limits: the compared numbers of the
program, or of its control, on many seeds in one process.

    python3 -m portbench.control --workload <name> --seeds 11,12,13 --seconds 8
        [--entry program|control] [--out readings.jsonl]

Each seed is one run of the cell as ``portbench.run`` makes it (set-up, a
window of ``--seconds``, the check), with ``--entry control`` putting the
driver's control in the program's place: for FDTD the float64 reference's
own leapfrog computed in bfloat16, for FDFD the refinement with its
residuals in complex64 in place of complex128. A limit lies above every sound
reading of the program and below every reading of the control. One JSON
line a seed goes to standard output and to ``--out``. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, type=lambda s: [int(v) for v in s.split(",")])
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--entry", choices=("program", "control"), default="control")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    import torch

    from portbench.cells import find_cell
    from portbench.harness import run_cell

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run_cell(cell, seed, args.seconds, False, "cuda:0", entry=args.entry)
        line = {"workload": args.workload, "entry": args.entry, "seed": seed,
                "seconds": time.perf_counter() - t0, "attempted": r["attempted"],
                "failed": r["failed"], "correct": r["correct"], "checks": r["checks"],
                "check_info": r["check_info"], "metrics": r["metrics"],
                "card": r["device"]["kind"]}
        print(json.dumps(line), flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
