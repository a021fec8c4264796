"""Each cell's files are found by name, and a configuration, a traffic mix
and a metric added as files are picked up with no edit."""

from __future__ import annotations

import json
import shutil

import pytest

from tiny import PB, REPO
from portbench import cells
from portbench.harness import run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cells_files_are_found_by_name(workload):
    cell = cells.find_cell(workload)
    assert cell.chips == 1
    assert cell.config["name"] == workload.split(".")[0]
    driver = cell.module("drivers", cell.traffic["driver"])
    assert hasattr(driver, "Driver")
    cell.module("scenes", cell.config["scene"]["kind"])
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert "setup_s" in names and len(cell.per_layer) >= 1
    for name in names:
        assert callable(cell.module("metrics", name).read)


def test_every_config_file_lies_under_paths_and_names_its_source():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path, cpu_threads):
    """A new configuration (another scene size key), a new traffic mix and a
    new end-to-end metric, each a file of its own in a copy of the folder."""
    root = tmp_path / "portbench"
    for folder in ("configs", "drivers", "metrics", "scenes", "traffic"):
        shutil.copytree(PB / folder, root / folder, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((root / "configs" / "fdtd-block.json").read_text())
    config["name"] = "fdtd-block-f64"
    config["dtype"] = "float64"
    (root / "configs" / "fdtd-block-f64.json").write_text(json.dumps(config))
    traffic = json.loads((root / "traffic" / "4096-long.json").read_text())
    traffic.update(grid=32, steps=40, trace_requests=2)
    traffic["check"].update(pool=4, limits={"fdtd_field_err": 1e-9})
    (root / "traffic" / "32-long.json").write_text(json.dumps(traffic))
    (root / "metrics" / "requests_done.py").write_text(
        "def read(record):\n    return len(record.requests)\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [
        {"name": "fdtd-block-f64", "source": "a test", "reduced": [],
         "file": "portbench/configs/fdtd-block-f64.json", "why": "a test"}]
    bench["workloads"] = [{"name": "fdtd-block-f64.32-long", "config": "fdtd-block-f64",
                           "traffic": "32-long", "chips": 1, "why": "a test"}]
    bench["end_to_end"] = BENCH["end_to_end"] + [
        {"name": "requests_done", "unit": "requests", "better": "higher", "bound": 0.01,
         "source": "host_clock"}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))

    cell = cells.find_cell("fdtd-block-f64.32-long", path, root)
    result = run_cell(cell, 7, 0.2, False, "cpu")
    assert result["correct"], result
    assert result["metrics"]["requests_done"]["value"] == result["attempted"]
    assert set(result["metrics"]) == {"requests_done", "setup_s"}


def test_an_unknown_name_says_what_is_missing(tiny_root):
    with pytest.raises(KeyError, match="no workload"):
        cells.find_cell("fdtd-block.nope", tiny_root, tiny_root.parent / "portbench")
    with pytest.raises(FileNotFoundError, match="no metrics named"):
        cells.load_module(PB, "metrics", "nope")
