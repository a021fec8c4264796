"""Each cell on the card: a short run of ``python3 -m portbench.run`` exits 0
with ``correct`` true. Marked ``cuda``; it skips where there is no card.

    python -m pytest portbench/tests -m cuda
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from tiny import REPO

WORKLOADS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_runs_correct_on_the_card(workload, trace, card):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                        "--seed", str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert p.stderr.splitlines()[-1].startswith("check ")
