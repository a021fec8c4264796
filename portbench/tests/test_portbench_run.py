"""A run end to end on the CPU at tiny sizes (the harness past its look
for a card), the result line's shape, the import check, and the refusal
without a CUDA device."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import types

import pytest
import torch

from tiny import CELLS, REPO, tiny_name

BENCH_CELL = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"][0]["name"]
from portbench import cells, run
from portbench.harness import run_cell



@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_cell_runs_correct_on_the_cpu(workload, trace, tiny_root, cpu_threads):
    cell = cells.find_cell(tiny_name(workload), tiny_root, tiny_root.parent / "portbench")
    r = run_cell(cell, 2**31 + 11, 0.3, bool(trace), "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert list(r)[-1] == "checks" and r["checks"]
    for c in r["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(r["metrics"]) <= wanted
    if trace:
        assert r["attempted"] == cell.traffic["trace_requests"]
        assert set(r["device"]) >= {"busy_s", "window_s"} and "breakdown" in r
        # the CPU has no device operations: the device readers report nothing
        assert not {"fdtd_idle_share", "fdfd_idle_share", "fdtd_kernel_roofline"} & set(r["metrics"])
    else:
        assert "setup_s" in r["metrics"]


def test_the_same_seed_gives_the_same_inputs(tiny_root, cpu_threads):
    cell = cells.find_cell(tiny_name("fdfd-hard.1024-batch16"), tiny_root,
                           tiny_root.parent / "portbench")
    drivers = [cell.module("drivers", "fdfd_direct").Driver(cell, s, "cpu") for s in (5, 5, 6)]
    assert [d.sources(3) for d in drivers[:2]] == [drivers[0].sources(3)] * 2
    assert drivers[0].sources(3) != drivers[2].sources(3)
    # every seed draws from the same set of positions
    assert sorted(map(tuple, drivers[0].sources.table)) == sorted(map(tuple, drivers[2].sources.table))


def test_the_import_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["fdtd2d_tpu_torch", "fdtd2d_tpu_torch.fdtd.simulate",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "fdtd2d_tpu.core"]) == [
        "fdtd2d_tpu", "flax", "jax", "jaxlib"]


def _result():
    return {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "check_info": {"fdtd_band_cover": 0.5},
            "checks": {"fdtd_field_err": {"value": 1e-6, "limit": 1e-4}}}


def test_a_loaded_jax_module_fails_the_run_and_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    log, out = io.StringIO(), io.StringIO()
    assert run.finish(_result(), log, out) != 0
    assert out.getvalue() == "" and "jax" in log.getvalue()


def test_the_port_itself_passes_and_the_checks_come_last():
    import fdtd2d_tpu_torch  # noqa: F401

    log, out = io.StringIO(), io.StringIO()
    assert run.finish(_result(), log, out) == 0
    assert log.getvalue().splitlines()[-1] == "check fdtd_field_err 1e-06 limit 0.0001"
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line)[-1] == "checks"


def test_a_run_without_a_cuda_device_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", BENCH_CELL,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout == "" and "CUDA" in p.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # past the look for a card, on the CPU: the request loop needs the program
    code = ("import sys; sys.argv[1:] = ['--workload', %r, '--seed', '1', '--seconds', '1'];"
            "import torch; torch.cuda.is_available = lambda: True;"
            "torch.cuda.device_count = lambda: 1;"
            "from portbench import harness, run; real = harness.run_cell;"
            "harness.run_cell = lambda c, s, t, tr, d, **k: real(c, s, t, tr, 'cpu', **k);"
            "sys.exit(run.main())") % BENCH_CELL
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "fdtd2d_tpu_torch" in p.stderr
