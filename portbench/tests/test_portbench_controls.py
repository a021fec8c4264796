"""The check fails what it must: each cell's control, in the program's
place, and the faults a cell can have, planted underneath the timed path,
each run past the harness's look for a card at tiny sizes on the CPU.

- FDTD: the control is the float64 reference's own leapfrog in bfloat16; the
  faults are a call that returns its state unchanged and an answer altered
  where it is made (one Ez cell of the output moved by 1% of max |Ez|).
- FDFD: the control is the program's refinement with its residuals in
  complex64; the faults are a solve that returns its starting iterate
  (zero), half of a batch left out, and an answer altered (a field scaled
  by 1 + 1e-3).
- No cell spans chips, so no exchange between chips can be left out.
"""

from __future__ import annotations

import importlib

import pytest
import torch

from tiny import CELLS, tiny_name
from portbench import cells
from portbench.harness import run_cell

FDTD = [w for w in CELLS if w.startswith("fdtd")]
FDFD = [w for w in CELLS if w.startswith("fdfd")]


def _run(workload, tiny_root, entry="program"):
    cell = cells.find_cell(tiny_name(workload), tiny_root, tiny_root.parent / "portbench")
    return run_cell(cell, 2**31 + 3, 0.2, False, "cpu", entry=entry)


def _failed_check(r):
    return (not r["correct"]) and any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(workload, tiny_root, cpu_threads):
    r = _run(workload, tiny_root, entry="control")
    assert _failed_check(r), r["checks"]


def _patch_simulate(monkeypatch, change):
    sim = importlib.import_module("fdtd2d_tpu_torch.fdtd.simulate")
    real = sim.simulate

    def broken(eps, mu, cfg, state=None):
        return change(real, eps, mu, cfg, state)

    monkeypatch.setattr(sim, "simulate", broken)


def _unchanged(real, eps, mu, cfg, state):
    fields, frames = real(eps, mu, cfg, state=state)
    if state is None:
        state = tuple(torch.zeros_like(f) for f in fields)
    return tuple(f.clone() for f in state), frames


def _altered(real, eps, mu, cfg, state):
    (Ez, Hx, Hy), frames = real(eps, mu, cfg, state=state)
    Ez = Ez.clone()
    Ez[Ez.shape[0] // 2, 7] += 0.01 * Ez.abs().max()
    return (Ez, Hx, Hy), frames


@pytest.mark.parametrize("fault", [_unchanged, _altered], ids=["unchanged", "altered"])
@pytest.mark.parametrize("workload", FDTD)
def test_an_fdtd_fault_is_not_correct(workload, fault, tiny_root, monkeypatch, cpu_threads):
    _patch_simulate(monkeypatch, fault)
    assert _failed_check(_run(workload, tiny_root))


def _patch_solver(monkeypatch, change):
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    real = DirectSolver.solve_batched

    def solve_batched(self, sources, **kw):
        fields, res, trace = real(self, sources, **kw)
        return change(fields), res, trace

    monkeypatch.setattr(DirectSolver, "solve_batched", solve_batched)


def _start_iterate(fields):
    return torch.zeros_like(fields)


def _half_left_out(fields):
    out = fields.clone()
    out[out.shape[0] // 2 :] = 0
    return out


def _scaled(fields):
    return fields * (1 + 1e-3)


@pytest.mark.parametrize("fault", [_start_iterate, _half_left_out, _scaled],
                         ids=["start-iterate", "half-left-out", "altered"])
@pytest.mark.parametrize("workload", FDFD)
def test_an_fdfd_fault_is_not_correct(workload, fault, tiny_root, monkeypatch, cpu_threads):
    _patch_solver(monkeypatch, fault)
    assert _failed_check(_run(workload, tiny_root))


def test_a_failing_request_is_counted_and_not_correct(tiny_root, monkeypatch, cpu_threads):
    cell = cells.find_cell(tiny_name(FDTD[0]), tiny_root, tiny_root.parent / "portbench")
    warm = cell.module("drivers", cell.traffic["driver"]).Driver(cell, 5, "cpu").fill_requests()
    calls = []

    def broken(real, eps, mu, cfg, state):
        calls.append(1)
        if len(calls) > max(warm, cell.traffic["warm_requests"]):   # set-up's calls pass
            raise RuntimeError("a planted failure")
        return real(eps, mu, cfg, state=state)

    _patch_simulate(monkeypatch, broken)
    r = run_cell(cell, 5, 0.05, False, "cpu")
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1
