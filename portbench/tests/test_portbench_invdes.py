"""The ``invdes-decade`` configuration at test sizes on the CPU: its request
loop, reference and control at 64^2 over 4 omegas (the harness past its look
for a card), the faults its check must catch, the count of its factor's
roofline, and its readers on synthetic Chrome events.

A tiny cell here is the 1024^2 cell's traffic at 64^2 with the upstream's
scene, 4 omegas over 2-7 GHz (dx = 3.9 mm resolves 7.7 GHz) and an 8-cell
UPML, the program's own UPML at that size. LAPACK runs on one thread.
"""

from __future__ import annotations

import json
import shutil
import warnings

import numpy as np
import pytest
import torch

from tiny import PB, REPO
from portbench import cells, invdes_readers
from portbench.harness import Record, run_cell
from portbench.profile import REQUEST_SPAN, read_chrome_trace
from portbench.reference import invdes as ref_invdes

CELL = "invdes-decade.1024-step"
TINY = "invdes-decade.tiny-1024-decade-step"
H100 = "NVIDIA H100 80GB HBM3"
LIMITS = {"invdes_loss_err": 1e-9, "invdes_grad_err": 3e-8, "invdes_update_err": 3e-8}


@pytest.fixture(scope="module")
def invdes_root(tmp_path_factory):
    """tmp/BENCHMARK.json and tmp/portbench/ holding the tiny cell."""
    tmp = tmp_path_factory.mktemp("invdes")
    root = tmp / "portbench"
    for folder in ("configs", "drivers", "metrics", "scenes"):
        shutil.copytree(PB / folder, root / folder, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((root / "configs" / "invdes-decade.json").read_text())
    config["omegas"].update(start=2e9, stop=7e9, count=4)
    config["ideal_response"] = [1.0, 1.0, 0.0, 0.0]
    config["pml"]["cells"] = 8
    (root / "configs" / "invdes-decade.json").write_text(json.dumps(config))
    (root / "traffic").mkdir()
    traffic = json.loads((PB / "traffic" / "1024-decade-step.json").read_text())
    traffic.update(grid=64, trace_requests=2)
    traffic["check"].update(pool=3, limits=LIMITS)
    (root / "traffic" / "tiny-1024-decade-step.json").write_text(json.dumps(traffic))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": TINY, "config": "invdes-decade",
                           "traffic": "tiny-1024-decade-step", "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY if w == CELL else w for w in m["workloads"]]
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(root, entry="program", trace=False, seed=2**31 + 5):
    cell = cells.find_cell(TINY, root, root.parent / "portbench")
    return run_cell(cell, seed, 0.5, trace, "cpu", entry=entry)


def _failed_check(r):
    return (not r["correct"]) and any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_new_cell_is_found_by_name():
    cell = cells.find_cell(CELL)
    assert cell.traffic["driver"] == "invdes_step" and cell.traffic["grid"] == 1024
    assert cell.config["solver"] == "hps" and cell.config["omegas"]["count"] == 10
    assert {m["name"] for m in cell.per_layer} == {
        "invdes_factor_roofline", "invdes_factor_share", "invdes_adjoint_idle_share",
        "invdes_rounds_per_solve"}
    assert {m["name"] for m in cell.end_to_end} == {
        "fdfd_sources_s", "fdfd_solve_p95_ms", "peak_mem_gb", "setup_s"}


def test_the_scene_is_the_upstreams_scaled_to_1024():
    scene = cells.load_module(PB, "scenes", "lowpass").make(1024)
    assert scene["design"] == ((307, 717), (307, 717))
    assert scene["probe"] == ((451, 573), (860, 861))
    assert scene["eps"][451, 0] == 3.0 and scene["eps"][300, 100] == 1.0 and scene["eps"][451, 307] == 1.0
    assert scene["source"][451:573, 164].tolist() == [3.0] * 122


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_cell_runs_correct_and_holds_the_stated_residual(invdes_root, trace,
                                                                  one_thread):
    r = _run(invdes_root, trace=bool(trace))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert set(r["checks"]) == {"fdfd_residual", *LIMITS}
    assert r["checks"]["fdfd_residual"]["limit"] == 1e-6
    assert r["check_info"]["fdfd_exact_residual"] < 1e-12
    if trace:
        assert r["metrics"]["invdes_rounds_per_solve"]["value"] >= 1
        # the CPU has no device operations: the device readers report nothing
        assert set(r["metrics"]) == {"invdes_rounds_per_solve"}
    else:
        assert r["metrics"]["fdfd_sources_s"]["value"] > 0


def test_the_control_in_the_programs_place_is_not_correct(invdes_root, one_thread):
    r = _run(invdes_root, entry="control")
    assert _failed_check(r), r["checks"]


def _no_adjoint(monkeypatch):
    """The adjoint left out: the gradient reads zero."""
    from fdtd2d_tpu_torch.fdfd import autodiff

    real = autodiff._input_grads
    monkeypatch.setattr(autodiff, "_input_grads",
                        lambda needs, op, x, y: real(needs, op, x, torch.zeros_like(y)))


def _one_omega_dropped(monkeypatch):
    """The problem's last omega left out: its field, response and gradient."""
    import dataclasses

    from fdtd2d_tpu_torch.apps import inverse_design

    real = inverse_design.lowpass_problem

    def problem(*a, **kw):
        p = real(*a, **kw)
        return dataclasses.replace(p, omegas=p.omegas[:-1], ideal_response=p.ideal_response[:-1])

    monkeypatch.setattr(inverse_design, "lowpass_problem", problem)


def _one_round_fewer(monkeypatch):
    from fdtd2d_tpu_torch.fdfd import autodiff

    real = autodiff._refined

    def refined(op, factors, b, target, direction):
        rounds = real(op, factors, b, target, direction).rounds
        with monkeypatch.context() as m:
            m.setattr(autodiff, "HPS_ROUNDS", max(rounds - 1, 0))
            return real(op, factors, b, target, direction)

    monkeypatch.setattr(autodiff, "_refined", refined)


def _no_update(monkeypatch):
    from fdtd2d_tpu_torch.apps import inverse_design

    real = inverse_design.design_step

    def step(state):
        design = state.design.detach().clone()
        out = real(state)
        with torch.no_grad():
            state.design.copy_(design)
        return out

    monkeypatch.setattr(inverse_design, "design_step", step)


@pytest.mark.parametrize("fault", [_no_adjoint, _one_omega_dropped, _one_round_fewer,
                                   _no_update],
                         ids=["adjoint-left-out", "one-omega-dropped", "one-round-fewer",
                              "update-not-applied"])
def test_a_fault_is_not_correct(invdes_root, fault, monkeypatch, one_thread):
    fault(monkeypatch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the stopped refinement says so
        r = _run(invdes_root)
    assert _failed_check(r), r["checks"]


def test_the_reference_asserts_a_symmetric_operator():
    scene = cells.load_module(PB, "scenes", "lowpass").make(32)
    ref = ref_invdes.Reference(scene, [3e9], [1.0], 0.25 / 32,
                               {"cells": 8, "sigma_max": 2.0, "order": 3}, "cpu")
    (r0, r1), (c0, c1) = scene["design"]
    design = np.full((r1 - r0, c1 - c0), 2.0)
    A = ref.operator(design, 3e9)
    assert abs(A - A.T).max() <= ref_invdes.SYMMETRY * abs(A).max()


@pytest.mark.parametrize("N, m", [(1024, 8), (2048, 8), (64, 4)])
def test_the_factor_count_walks_the_programs_plan(N, m):
    from fdtd2d_tpu_torch.fdfd.hps import build_plan, predicted_factor_bytes

    levels, rho = invdes_readers.hps_nodes(N, m)
    plan = build_plan(N // 2, N // 2, m)
    assert [(P, j, r) for P, j, r in levels[1:]] == [
        (mp.n_parents, len(mp.idx_J), len(mp.idx_R)) for mp in plan.merges]
    assert rho == len(plan.root_coords)
    stored = 4 * 8 * (sum(P * (j * j + j * r) for P, j, r in levels) + rho * rho)
    assert stored == predicted_factor_bytes(N, m)


def test_the_1024_factor_is_compute_bound():
    flops, nbytes = invdes_readers.hps_factor_work(1024, 8, 1)
    assert flops == pytest.approx(0.959126e12, rel=1e-6)
    seconds, bound = invdes_readers.least_seconds(flops, nbytes, H100)
    assert bound == "compute" and seconds * 1e3 == pytest.approx(14.3153, rel=1e-4)
    assert invdes_readers.hps_factor_work(1024, 8, 10)[0] == 10 * flops


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(name, start, end):
    return _event("user_annotation", name, start, end - start)


# one step of 100 us: the factor (two launches, their ops), the forward
# refinement's inner solve, the adjoint, the update; every op has its launch
STEP_EVENTS = [
    _span(REQUEST_SPAN, 0, 100),
    _span("invdes.step", 1, 99),
    _span("fdfd.adjoint.forward", 2, 50),
    _span("fdfd.hps.factor", 3, 20),
    _event("cuda_runtime", "cudaLaunchKernel", 4, 1),
    _event("cuda_runtime", "cudaLaunchKernel", 6, 1),
    _span("fdfd.backsolve", 30, 40),
    _event("cuda_runtime", "cudaLaunchKernel", 31, 1),
    _span("fdfd.adjoint.backward", 55, 90),
    _event("cuda_runtime", "cudaLaunchKernel", 56, 1),
    _event("kernel", "getrf", 5, 5),
    _event("kernel", "gemm", 12, 6),
    _event("kernel", "sweep", 32, 8),
    _event("kernel", "gradient", 60, 10),
]


def _record(events, requests):
    return Record(H100, 1.0, {}, 1.0, requests, 0, read_chrome_trace(events))


REQUEST = {"seconds": 1e-4, "sources": 8, "members": 4, "grid": 1024, "hps_leaf": 8,
           "inner_solves": 5, "adjoint_solves": 8}


def test_the_factor_readers_read_the_ops_that_start_inside_the_factor():
    r = _record(STEP_EVENTS, [REQUEST])
    value, extra = invdes_readers.invdes_factor_roofline(r)
    least = invdes_readers.least_seconds(*invdes_readers.hps_factor_work(1024, 8, 4), H100)[0]
    assert extra["factor_device_ms"] == pytest.approx(11e-3) and extra["bound"] == "compute"
    assert value == pytest.approx(100 * least / 11e-6)
    assert invdes_readers.invdes_factor_share(r) == pytest.approx(100 * 11 / 29)
    # a launch the trace lost changes nothing: the operations are read by time
    lost = [e for e in STEP_EVENTS if e["ts"] != 6]
    assert invdes_readers.invdes_factor_roofline(_record(lost, [REQUEST]))[0] == value
    # an operation that starts after the factor's span is not the factor's
    late = STEP_EVENTS + [_event("kernel", "cast", 21, 4)]
    assert invdes_readers.invdes_factor_share(_record(late, [REQUEST])) == pytest.approx(
        100 * 11 / 33)
    assert invdes_readers.invdes_factor_roofline(_record(STEP_EVENTS, [{"seconds": 1}])) is None
    plain = [e for e in STEP_EVENTS if e["name"] != "fdfd.hps.factor"]
    assert invdes_readers.invdes_factor_roofline(_record(plain, [REQUEST])) is None


def test_the_step_idle_share_sums_the_steps_own_spans():
    """Idle [0,5], [10,12], [18,32], [40,60], [70,100] of a 100 us window:
    [1,2], [50,55] and [90,99] under invdes.step; [3,5], [10,12] and [18,20]
    under the factor; [2,3], [20,30] and [40,50] under fdfd.adjoint.forward;
    [30,32] under the inner solve; [55,60] and [70,90] under
    fdfd.adjoint.backward."""
    r = _record(STEP_EVENTS, [REQUEST])
    value, split = invdes_readers.invdes_adjoint_idle_share(r)
    assert split["under.invdes.step"] == pytest.approx(1 + 5 + 9)
    assert split["under.fdfd.adjoint.forward"] == pytest.approx(1 + 10 + 10)
    assert split["under.fdfd.adjoint.backward"] == pytest.approx(5 + 20)
    assert split["under.fdfd.hps.factor"] == pytest.approx(2 + 2 + 2)
    assert split["under.fdfd.backsolve"] == pytest.approx(2)
    assert value == pytest.approx(15 + 21 + 25)
    assert sum(split.values()) == pytest.approx(100 * (1 - r.trace.busy_s / r.trace.window_s))
    plain = [e for e in STEP_EVENTS if e["name"] not in invdes_readers.STEP_SPANS]
    assert invdes_readers.invdes_adjoint_idle_share(_record(plain, [REQUEST])) is None


def test_the_rounds_a_solve_count_every_member():
    r = _record(STEP_EVENTS, [REQUEST, dict(REQUEST, inner_solves=7)])
    assert invdes_readers.invdes_rounds_per_solve(r) == pytest.approx((5 + 7) * 4 / 16)
    assert invdes_readers.invdes_rounds_per_solve(_record(STEP_EVENTS, [{"seconds": 1}])) is None
