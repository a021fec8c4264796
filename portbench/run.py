"""The benchmark of the PyTorch and CUDA port (``fdtd2d_tpu_torch``): one
run of one cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its files are found by name (cells.py). The run needs a CUDA
device and fails without one, and fails when the cell asks for more cards
than there are. It makes its inputs from ``--seed``, warms the cell's own
shapes, measures ``--seconds`` seconds of a closed loop (harness.py), checks
the answers against the plain reference, and prints one JSON line: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a traced window. Each compared number and its limit
are the last lines of standard error and the last key of the line.

The run fails, and prints no result, if any module whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``fdtd2d_tpu`` (the JAX package) is loaded
once the window has closed; names are compared whole, so the port itself,
``fdtd2d_tpu_torch``, passes.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here: imports, build, scene, warm-up

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fdtd2d_tpu")


def forbidden_modules(names) -> list:
    """The names of FORBIDDEN among the top-level parts of ``names``."""
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def finish(result: dict, log=sys.stderr, out=sys.stdout) -> int:
    """Print the compared numbers (last on ``log``) and the result line (last
    on ``out``); or, if a forbidden module is loaded, say which and print
    no result."""
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: loaded in the measured process: {', '.join(found)}", file=log)
        return 3
    for name, value in result.get("check_info", {}).items():
        print(f"info {name} {value!r}", file=log)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    log.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from portbench.cells import find_cell
    from portbench.harness import run_cell

    cell = find_cell(args.workload)
    chips = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t0=T0)
    checks = result.pop("checks")
    result["power_limit"] = power_limit()
    result["checks"] = checks
    return finish(result)


if __name__ == "__main__":
    sys.exit(main())
