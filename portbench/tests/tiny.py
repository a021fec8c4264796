"""A benchmark root of tiny cells in a temporary folder: a copy of the
benchmark's configurations, request loops, scenes and metric readers, with
a tiny traffic file for each traffic file of the benchmark, at sizes a CPU
test holds. Every traffic file gets a cell, so that each request loop and
each check stays tested. A tiny cell is named as its full-size cell,
with ``tiny-`` before the traffic's name."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent
CONFIG_OF_DRIVER = {"fdtd_rollout": "fdtd-block", "fdfd_direct": "fdfd-hard"}

# traffic -> (its changes, check changes, limits): the limits from CPU
# readings at these sizes (test_portbench_controls.py shows both sides)
TINY = {
    "4096-long": ({"grid": 48, "steps": 64, "trace_requests": 3}, {"pool": 4},
                  {"fdtd_field_err": 1e-4}),
    "1024-batch16": ({"grid": 128, "trace_requests": 2}, {"pool": 4}, {"fdfd_field_err": 4e-8}),
}


def _traffic(name: str) -> dict:
    return json.loads((PB / "traffic" / f"{name}.json").read_text())


CELLS = sorted(f"{CONFIG_OF_DRIVER[_traffic(t)['driver']]}.{t}" for t in TINY)


def tiny_name(workload: str) -> str:
    config, traffic = workload.split(".", 1)
    return f"{config}.tiny-{traffic}"


def make_root(tmp: Path) -> Path:
    """tmp/BENCHMARK.json and tmp/portbench/: the tiny cells. Returns the
    benchmark file's path."""
    root = tmp / "portbench"
    for folder in ("configs", "drivers", "metrics", "scenes"):
        shutil.copytree(PB / folder, root / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic").mkdir(parents=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for cell in CELLS:
        config, name = cell.split(".", 1)
        changes, check, limits = TINY[name]
        traffic = _traffic(name)
        traffic.update(changes)
        traffic["check"].update(check, limits=limits)
        if traffic["sources"]["per_request"] > 1:
            traffic["sources"]["per_request"] = 4
        (root / "traffic" / f"tiny-{name}.json").write_text(json.dumps(traffic))
        bench["workloads"].append({"name": tiny_name(cell), "config": config,
                                   "traffic": f"tiny-{name}", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_name(w) for w in m["workloads"]]
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
