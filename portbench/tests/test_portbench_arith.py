"""The benchmark's arithmetic: interval union and gaps, the percentile over
all requests, the roofline from N and the steps, and the reduction of a
Chrome trace to request spans."""

from __future__ import annotations

import pytest

from portbench import profile, roofline, stats
from portbench.harness import Record


def test_union_counts_overlaps_once():
    assert profile.union([]) == 0.0
    assert profile.union([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert profile.union([(5, 6), (0, 10)]) == 10.0


def test_gaps_cover_what_no_interval_does():
    assert profile.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert profile.gaps([(0, 6)], 0, 6) == []
    assert profile.gaps([], 0, 3) == [(0, 3)]


@pytest.mark.parametrize("values, q, want", [
    (list(range(1, 101)), 95, 95), (list(range(1, 21)), 95, 19), ([5.0], 95, 5.0),
    (list(range(100, 0, -1)), 50, 50), (list(range(1, 201)), 95, 190)])
def test_percentile_is_the_nearest_rank_over_all_values(values, q, want):
    assert stats.percentile(values, q) == want


def test_fdtd_roofline_from_the_grid_and_the_steps():
    flops, nbytes = roofline.fdtd_call_work(4096, 4096, 2048)
    assert flops == 11 * 4096 * 4096 * 2048
    assert nbytes == 4 * 4096 * 4096 * 8
    seconds, bound = roofline.least_seconds(flops, nbytes, "NVIDIA H100 80GB HBM3")
    assert bound == "compute"
    assert seconds / 2048 * 1e3 == pytest.approx(0.002754, rel=1e-3)   # ms a step
    # a call of a few steps reads and writes more than it computes
    seconds, bound = roofline.least_seconds(*roofline.fdtd_call_work(200, 200, 8),
                                            "NVIDIA H100 80GB HBM3")
    assert bound == "memory" and seconds == pytest.approx(4 * 200 * 200 * 8 / 3.35e12)
    assert roofline.least_seconds(1.0, 1.0, "some other card") is None


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_a_chrome_trace_reduces_to_request_spans():
    events = [
        _event("user_annotation", profile.REQUEST_SPAN, 0, 100),
        _event("cpu_op", "aten::mul", 0, 10),
        _event("kernel", "k_a", 10, 30),
        _event("cpu_op", "aten::linalg_inv", 40, 30),
        _event("kernel", "k_a", 70, 20),
        _event("gpu_memcpy", "Memcpy DtoH", 92, 4),
        _event("user_annotation", profile.REQUEST_SPAN, 200, 50),
        _event("kernel", "k_b", 210, 40),
        _event("kernel", "outside", 120, 50),          # between requests: left out
        _event("gpu_user_annotation", "x", 0, 300),    # not a device operation
    ]
    t = profile.read_chrome_trace(events)
    assert t.window_s == pytest.approx(150e-6)
    assert t.launches == 4
    assert t.busy_s == pytest.approx((30 + 20 + 4 + 40) * 1e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(50e-6)]
    idle = dict(b["idle_gaps"])
    assert idle["aten::linalg_inv"] == pytest.approx(30e-6)
    assert idle["aten::mul"] == pytest.approx(10e-6)
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)


def test_readers_report_nothing_where_there_is_nothing_to_read(tmp_path):
    from tiny import PB
    from portbench.cells import load_module

    empty = Record("cpu", 1.0, {}, 1.0, [{"seconds": 0.1}], 0, None)
    for path in sorted((PB / "metrics").glob("*.py")):
        value = load_module(PB, "metrics", path.stem).read(empty)
        assert value is None or path.stem == "setup_s", path.stem
