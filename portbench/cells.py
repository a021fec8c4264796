"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's entry gives its file; the traffic mix is
``traffic/<traffic>.json``; the traffic file names its request loop,
``drivers/<driver>.py``; a configuration names its scene,
``scenes/<kind>.py``; each metric is read by ``metrics/<name>.py``. So a
later change adds a configuration, a traffic mix, a request loop, a scene
or a metric by adding files, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path            # the folder holding configs/, traffic/, drivers/, ...

    def module(self, folder: str, name: str):
        return load_module(self.root, folder, name)


def load_module(root: Path, folder: str, name: str):
    path = Path(root) / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str, reported=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def find_cell(workload: str, benchmark: Path = BENCHMARK, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in the ``benchmark`` file, with its
    configuration and traffic read from their files under ``root``."""
    benchmark = Path(benchmark)
    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}; it has {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((benchmark.parent / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((Path(root) / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(workload, entry["chips"], config, traffic, e2e, layer, Path(root))
