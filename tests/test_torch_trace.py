"""utils/trace.py: the port's spans appear in a torch.profiler trace, nested
as the layers nest, and count without one; the FDFD backsolve spans count
the refinement's inner solves."""

import json

import numpy as np
import pytest
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd import direct
from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate
from fdtd2d_tpu_torch.utils import trace, trace_profile


def _spans(log_dir) -> list:
    """(name, start, end) of every host annotation in the written trace."""
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_simulate_spans_nest_and_count_the_frames(tmp_path):
    """64^2 with 3 frames of 3 steps and a remainder of 1: one fdtd.simulate
    holding one fdtd.setup and four fdtd.advance, the setup before them."""
    N = 64
    eps = np.full((N, N), constants.EPSILON_0)
    mu = np.full((N, N), constants.MU_0)
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=10, source_xy=(20, 30), source_fc=30e9,
                     nframes=3, backend="torch", device="cpu")
    before = trace.counters()
    with trace_profile(str(tmp_path)):
        simulate(eps, mu, cfg)
    spans = _spans(tmp_path)
    (outer,) = [s for s in spans if s[0] == "fdtd.simulate"]
    (setup,) = [s for s in spans if s[0] == "fdtd.setup"]
    advances = [s for s in spans if s[0] == "fdtd.advance"]
    assert len(advances) == 4
    assert all(_inside(s, outer) for s in [setup] + advances)
    assert setup[2] <= min(a[1] for a in advances)
    assert [trace.delta(before, f"fdtd.{k}") for k in ("simulate", "setup", "advance")] == [
        1, 1, 4]


def test_batched_backsolve_spans_count_the_refinement_rounds(tmp_path, monkeypatch):
    """A solve_batched call exports one fdfd.backsolve a refinement round,
    inside fdfd.solve_batched: as many as BatchRefineResult.rounds and as the
    counter's delta; each round and the last check read the norms once."""
    N = 48
    eps, mu, _ = hard_binary_scene(N, seed=3, sigma=4.0)
    solver = direct.DirectSolver(eps, mu, 1e-3, 1e-3, 24e9, pml_thickness=10, device="cpu")
    srcs = np.zeros((2, N, N))
    srcs[0, 20, 24] = srcs[1, 30, 17] = 1.0
    results = []
    real = direct.refine_batched

    def recorded(*args, **kwargs):
        results.append(real(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(direct, "refine_batched", recorded)
    before = trace.counters()
    with trace_profile(str(tmp_path)):
        _, _, residuals = solver.solve_batched(srcs, refine_target=1e-8)
    (out,) = results
    spans = _spans(tmp_path)
    (outer,) = [s for s in spans if s[0] == "fdfd.solve_batched"]
    backsolves = [s for s in spans if s[0] == "fdfd.backsolve"]
    assert out.rounds >= 1 and len(residuals) - 1 == out.rounds
    assert len(backsolves) == out.rounds == trace.delta(before, "fdfd.backsolve")
    assert trace.delta(before, "fdfd.refine.residual") == out.rounds + 1
    assert trace.delta(before, "fdfd.refine.read") == out.rounds + 2
    assert all(_inside(s, outer) for s in spans
               if s[0].startswith("fdfd.") and s[0] != "fdfd.solve_batched")


def test_without_the_profiler_a_span_only_counts(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    before = trace.counters()
    with trace.span("test.layer"):
        with trace.span("test.layer"):
            trace.count("test.work", 5)
    snapshot = trace.counters()
    snapshot["test.layer"] = -1          # a snapshot, not the counters themselves
    assert trace.delta(before, "test.layer") == 2
    assert trace.delta(before, "test.work") == 5
    assert trace.delta(before, "test.never") == 0
    with pytest.raises(ValueError):      # a span passes its block's exception on
        with trace.span("test.layer"):
            raise ValueError
    assert trace.delta(before, "test.layer") == 3
