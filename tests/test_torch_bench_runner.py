"""The runner of the port's bench (fdtd2d_tpu_torch/bench.py) and its CLI
entry, on the CPU.

The first three tests are tests/test_bench_runner.py's, against ``python -m
fdtd2d_tpu_torch.bench``: they drive the real parent/child subprocess
machinery through the hidden ``_hang`` row, which sleeps without importing
torch, so they are fast and device-free. The rest hold the module free of
JAX, the CLI's ``bench --device cpu`` to bench.py's off-TPU metric name, and
``--device cuda`` without a card to an error.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BENCH = [sys.executable, "-m", "fdtd2d_tpu_torch.bench"]
CLI = [sys.executable, "-m", "fdtd2d_tpu_torch.cli"]


def _run(cmd, env=None, timeout=120):
    # one intra-op thread a process: test workers share the cores
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_hung_child_is_killed_and_retried():
    proc = _run(BENCH + ["--only", "_hang"], {"FDTD2D_BENCH_TIMEOUT": "2"})
    # three timed-out attempts, then give up; the missing headline is
    # reported loudly (rc 1)
    assert proc.stderr.count("timed out") == 3, proc.stderr
    assert "giving up" in proc.stderr, proc.stderr
    assert "headline" in proc.stderr, proc.stderr
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout.strip() == "", proc.stdout


def test_unknown_bench_rejected():
    proc = _run(BENCH + ["--only", "nosuchbench"], timeout=60)
    assert proc.returncode == 2
    assert "unknown bench" in proc.stderr


def test_suite_deadline_skips_remaining():
    proc = _run(BENCH + ["--only", "_hang"],
                {"FDTD2D_BENCH_TIMEOUT": "30", "FDTD2D_BENCH_SUITE_TIMEOUT": "2"})
    # attempt 1 is capped by the 2 s suite deadline, later attempts skipped
    assert "deadline exceeded" in proc.stderr, proc.stderr
    assert proc.stderr.count("timed out") == 1, proc.stderr
    assert proc.returncode == 1, proc.stderr


def test_module_imports_neither_torch_nor_jax_at_top_level():
    """The runner's parent and its ``_hang`` row import no torch; nothing
    imports JAX or the JAX package."""
    code = ("import sys; import fdtd2d_tpu_torch.bench, fdtd2d_tpu_torch.cli; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'fdtd2d_tpu')))")
    proc = _run([sys.executable, "-c", code], timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_module_imports_and_runs_with_jax_blocked():
    """A fresh interpreter with ``jax`` and ``fdtd2d_tpu`` blocked in
    sys.modules imports the bench and the CLI and runs the headline row
    (tests/test_torch_bench_rows.py runs every other row with both
    blocked)."""
    code = ("import json, sys; sys.modules.update(jax=None, fdtd2d_tpu=None); "
            "from fdtd2d_tpu_torch import bench, cli; "
            "print(json.dumps(bench.run_row('fdtd2048', 'cpu')))")
    proc = _run([sys.executable, "-c", code], timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    assert row["metric"] == "fdtd_yee_updates_512x512"


def test_cli_bench_cpu_prints_the_off_tpu_headline():
    """``cli bench --device cpu --only fdtd2048``: one line, bench.py's
    off-TPU metric (bench.py:103-109: 512^2, 50 steps, the plain step)."""
    proc = _run(CLI + ["bench", "--device", "cpu", "--only", "fdtd2048"], timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    row = json.loads(lines[0])
    assert row["metric"] == "fdtd_yee_updates_512x512"
    assert row["unit"] == "GCells/s" and row["value"] >= 0
    assert row["backend"] == "torch" and row["float64_rel_err"] <= 1e-5
    assert row["card"] == "cpu" and row["power_limit"] is None


def test_cuda_without_a_card_raises(monkeypatch):
    """No CPU fallback: a row asked for cuda raises where there is no card,
    and so does the runner before it starts a child."""
    from fdtd2d_tpu_torch import bench, cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_row("fdtd2048", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--only", "fdfd512,fdtd2048"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
