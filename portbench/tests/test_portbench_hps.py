"""The ``fdfd-hps`` configuration at test sizes on the CPU: its request loop,
reference and control at 128^2 (the harness past its look for a card), the
faults its check must catch, the count of its roofline against the
program's own, and its readers on synthetic Chrome events.

A tiny cell here is the 2048^2 cell's traffic at 128^2 with 4 sources a
request (program 1.5e-10 against the exact field on the CPU, the control
1.0e-7: the limit 1e-8). LAPACK runs on one thread: several stall on the
eliminations' inverses on some CPUs.
"""

from __future__ import annotations

import json
import shutil
import warnings

import pytest
import torch

from tiny import PB, REPO
from portbench import cells, hps_readers, roofline
from portbench.harness import Record, run_cell
from portbench.profile import REQUEST_SPAN, read_chrome_trace

CELL = "fdfd-hps.2048-batch16"
TINY = "fdfd-hps.tiny-2048-hps-batch16"
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def hps_root(tmp_path_factory):
    """tmp/BENCHMARK.json and tmp/portbench/ holding the tiny HPS cell."""
    tmp = tmp_path_factory.mktemp("hps")
    root = tmp / "portbench"
    for folder in ("configs", "drivers", "metrics", "scenes"):
        shutil.copytree(PB / folder, root / folder, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "traffic").mkdir()
    traffic = json.loads((PB / "traffic" / "2048-hps-batch16.json").read_text())
    traffic.update(grid=128, trace_requests=2)
    traffic["sources"]["per_request"] = 4
    traffic["check"].update(pool=4, limits={"fdfd_field_err": 1e-8})
    (root / "traffic" / "tiny-2048-hps-batch16.json").write_text(json.dumps(traffic))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": TINY, "config": "fdfd-hps",
                           "traffic": "tiny-2048-hps-batch16", "chips": 1, "why": "a test"}]
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


def _run(hps_root, entry="program", trace=False, seed=2**31 + 3):
    cell = cells.find_cell(TINY, hps_root, hps_root.parent / "portbench")
    return run_cell(cell, seed, 0.2, trace, "cpu", entry=entry)


def _failed_check(r):
    return (not r["correct"]) and any(c["value"] > c["limit"] for c in r["checks"].values())


def test_both_new_cells_are_found_by_name():
    hps = cells.find_cell(CELL)
    assert hps.traffic["driver"] == "fdfd_hps" and hps.traffic["grid"] == 2048
    assert hps.config["solver"] == "hps" and hps.config["hps_leaf"] == 8
    assert {"fdfd_hps_roofline", "fdfd_hps_sweep_idle_share"} <= {m["name"] for m in hps.per_layer}
    assert {"fdfd_sources_s", "fdfd_solve_p95_ms", "setup_s"} <= {m["name"] for m in hps.end_to_end}
    fdtd = cells.find_cell("fdtd-block.8192-long")
    assert fdtd.traffic["driver"] == "fdtd_rollout" and fdtd.traffic["grid"] == 8192
    assert "fdtd_gcells_s" in {m["name"] for m in fdtd.end_to_end}
    assert len(fdtd.per_layer) == 5


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_cell_runs_correct_and_holds_the_stated_residual(hps_root, trace, one_thread):
    r = _run(hps_root, trace=bool(trace))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert set(r["checks"]) == {"fdfd_residual", "fdfd_field_err"}
    assert r["checks"]["fdfd_residual"]["limit"] == 1e-6
    assert r["check_info"]["fdfd_exact_residual"] < 1e-13
    if trace:
        assert r["metrics"]["fdfd_rounds_per_source"]["value"] >= 1
        # the CPU has no device operations: the device readers report nothing
        assert not {"fdfd_hps_roofline", "fdfd_hps_sweep_idle_share"} & set(r["metrics"])


def test_the_control_in_the_programs_place_is_not_correct(hps_root, one_thread):
    r = _run(hps_root, entry="control")
    assert _failed_check(r), r["checks"]


def _patch_solver(monkeypatch, change):
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    real = DirectSolver.solve_batched

    def solve_batched(self, sources, **kw):
        return change(real, self, sources, **kw)

    monkeypatch.setattr(DirectSolver, "solve_batched", solve_batched)


def _half_left_out(real, self, sources, **kw):
    fields, res, trace = real(self, sources, **kw)
    fields = fields.clone()
    fields[fields.shape[0] // 2 :] = 0
    return fields, res, trace


def _one_round_fewer(real, self, sources, **kw):
    _, _, trace = real(self, sources, **kw)
    return real(self, sources, **kw, max_refine_rounds=len(trace) - 2)


@pytest.mark.parametrize("fault", [_half_left_out, _one_round_fewer],
                         ids=["half-left-out", "one-round-fewer"])
def test_a_fault_is_not_correct(hps_root, fault, monkeypatch, one_thread):
    _patch_solver(monkeypatch, fault)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the stopped refinement says so
        r = _run(hps_root)
    assert _failed_check(r), r["checks"]


@pytest.mark.parametrize("N, m", [(128, 8), (2048, 8), (256, 16), (64, 4)])
def test_the_roofline_counts_the_programs_stored_factor(N, m):
    from fdtd2d_tpu_torch.fdfd.hps import predicted_factor_bytes

    y, e = hps_readers.hps_store_entries(N, m)
    assert 8 * (y + e) == predicted_factor_bytes(N, m)
    flops, nbytes = hps_readers.hps_solve_work(N, m, 16)
    assert nbytes == 8 * (y + e) + 2 * 8 * 16 * N * N
    assert flops == 8 * 16 * (y + 2 * e)


def test_the_2048_solve_is_compute_bound_at_16_sources():
    seconds, bound = roofline.least_seconds(*hps_readers.hps_solve_work(2048, 8, 16), H100)
    assert bound == "compute" and seconds * 1e3 == pytest.approx(2.3126, rel=1e-4)
    seconds, bound = roofline.least_seconds(*hps_readers.hps_solve_work(2048, 8, 1), H100)
    assert bound == "memory" and seconds == pytest.approx((6_091_963_904 + 16 * 2048**2) / 3.35e12)


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(name, start, end):
    return _event("user_annotation", name, start, end - start)


# one request of 100 us: a residual op, then one inner solve whose two ops
# run after its span has closed, then the update; every op has its launch
HPS_EVENTS = [
    _span(REQUEST_SPAN, 0, 100),
    _span("fdfd.solve_batched", 2, 98),
    _span("fdfd.refine.residual", 3, 10),
    _event("cuda_runtime", "cudaLaunchKernel", 4, 1),
    _span("fdfd.backsolve", 12, 30),
    _span("fdfd.hps.split", 12, 15),
    _event("cuda_runtime", "cudaMemcpyAsync", 13, 1),
    _span("fdfd.hps.up", 16, 22),
    _event("cuda_driver", "cuLaunchKernel", 17, 1),
    _span("fdfd.hps.root", 23, 25),
    _span("fdfd.hps.down", 26, 29),
    _event("cuda_runtime", "cudaStreamIsCapturing", 27, 1),     # no launch
    _event("cuda_runtime", "cudaLaunchKernel", 40, 1),
    _event("cuda_runtime", "cudaDeviceSynchronize", 45, 55),
    _event("kernel", "residual", 5, 7),
    _event("gpu_memcpy", "split copy", 31, 9),
    _event("kernel", "gemm", 50, 20),
    _event("kernel", "update", 80, 10),
]


def _record(events, requests):
    return Record(H100, 1.0, {}, 1.0, requests, 0, read_chrome_trace(events))


def test_the_roofline_reads_the_ops_launched_inside_the_backsolve():
    r = _record(HPS_EVENTS, [{"seconds": 1e-4, "sources": 16, "grid": 2048, "hps_leaf": 8}])
    value, extra = hps_readers.fdfd_hps_roofline(r)
    least = roofline.least_seconds(*hps_readers.hps_solve_work(2048, 8, 16), H100)[0]
    assert extra["backsolve_device_ms"] == pytest.approx((9 + 20) * 1e-3)
    assert value == pytest.approx(100 * least / 29e-6) and extra["bound"] == "compute"
    # a launch the trace lost: the pairing fails and nothing is read
    lost = [e for e in HPS_EVENTS if e["name"] != "cuLaunchKernel"]
    assert hps_readers.fdfd_hps_roofline(_record(lost, r.requests)) is None
    # requests without the HPS driver's work: nothing is read
    assert hps_readers.fdfd_hps_roofline(_record(HPS_EVENTS, [{"seconds": 1e-4}])) is None


def test_the_sweep_idle_share_sums_the_hps_spans():
    """Idle gaps [0,5], [12,31], [40,50], [70,80], [90,100] of a 100 us
    window: [12,15] to the split, [16,22] to up, [23,25] to root, [26,29]
    to down, the rest of [12,30] to the backsolve."""
    r = _record(HPS_EVENTS, [{"seconds": 1e-4}])
    value, split = hps_readers.fdfd_hps_sweep_idle_share(r)
    assert value == pytest.approx(3 + 6 + 2 + 3)
    assert split["under.fdfd.backsolve"] == pytest.approx(4)
    assert split["under.fdfd.hps.up"] == pytest.approx(6)
    assert sum(split.values()) == pytest.approx(100 * (1 - r.trace.busy_s / r.trace.window_s))
    plain = [e for e in HPS_EVENTS if not e["name"].startswith("fdfd.hps.")]
    assert hps_readers.fdfd_hps_sweep_idle_share(_record(plain, [{"seconds": 1e-4}])) is None
