"""The readers of the program's spans (spans.py) on synthetic Chrome events:
each idle gap cut exactly at span boundaries and given to the innermost
open span, the labels summing to the window's idle time, nothing read from
a trace without program spans; and, on a tiny traced run on the CPU, the
inner solves a call counted from the spans as the rounds the program
reports."""

from __future__ import annotations

import pytest

from tiny import tiny_name
from portbench import cells, spans
from portbench.harness import Record, run_cell
from portbench.profile import REQUEST_SPAN, read_chrome_trace


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(name, start, end):
    return _event("user_annotation", name, start, end - start)


def _kernel(start, end, cat="kernel"):
    return _event(cat, "k", start, end - start)


def _record(events):
    return Record("cpu", 1.0, {}, 1.0, [{"seconds": 0.1}], 0, read_chrome_trace(events))


# one request of 100 us holding one batched solve, and one of 50 us with no
# program span; a backsolve between the requests is out of the window
FDFD_EVENTS = [
    _span(REQUEST_SPAN, 0, 100),
    _span("fdfd.solve_batched", 5, 95),
    _span("fdfd.refine.residual", 10, 30),
    _span("fdfd.backsolve", 40, 80),
    _span("fdfd.refine.read", 82, 90),
    _event("cpu_op", "aten::bmm", 41, 30),          # a host op: no label of its own
    _kernel(15, 20), _kernel(50, 60), _kernel(85, 88, "gpu_memcpy"),
    _span(REQUEST_SPAN, 200, 250),
    _kernel(210, 220),
    _span("fdfd.backsolve", 150, 160),
]


def test_idle_gaps_are_cut_exactly_at_span_boundaries():
    """Gaps [0,15], [20,50], [60,85], [88,100] and [200,210], [220,250]: each
    piece to the innermost span open over it."""
    t = read_chrome_trace(FDFD_EVENTS)
    idle = {k: v * 1e6 for k, v in spans.idle_by_span(t).items()}
    assert idle == pytest.approx({"outside": 5 + 5 + 10 + 30, "fdfd.solve_batched": 5 + 10 + 2 + 5,
                                  "fdfd.refine.residual": 5 + 10, "fdfd.backsolve": 10 + 20,
                                  "fdfd.refine.read": 3 + 2})
    r = _record(FDFD_EVENTS)
    value, split = spans.fdfd_backsolve_idle_share(r)
    assert value == pytest.approx(100 * 30 / 150)
    assert spans.fdfd_refine_idle_share(r)[0] == pytest.approx(100 * 20 / 150)
    assert split["under.outside"] == pytest.approx(100 * 50 / 150)
    assert spans.fdfd_inner_solves_per_call(r) == 0.5


def test_an_inner_span_that_starts_with_its_outer_span_takes_the_gap():
    events = [_span(REQUEST_SPAN, 0, 100), _span("fdtd.simulate", 0, 90),
              _span("fdtd.setup", 0, 10), _span("fdtd.advance", 20, 85), _kernel(10, 20),
              _kernel(30, 80)]
    r = _record(events)
    assert spans.fdtd_setup_idle_share(r)[0] == pytest.approx(10.0)
    value, split = spans.fdtd_advance_idle_share(r)
    assert value == pytest.approx(10 + 5)
    assert split == pytest.approx({"under.fdtd.setup": 10.0, "under.fdtd.advance": 15.0,
                                   "under.fdtd.simulate": 5.0, "under.outside": 10.0})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_labels_sum_to_the_windows_idle_share(seed):
    """Random requests, kernels and nested spans: every label's share,
    outside included, sums to 1 - busy / window."""
    import random

    rng = random.Random(seed)
    events, t0 = [], 0.0
    for _ in range(5):
        length = rng.uniform(50, 500)
        events.append(_span(REQUEST_SPAN, t0, t0 + length))
        a = t0 + rng.uniform(0, length / 4)
        b = t0 + length - rng.uniform(0, length / 4)
        events.append(_span("fdfd.solve_batched", a, b))
        for _ in range(4):
            s = rng.uniform(a, b)
            events.append(_span(rng.choice(spans.PROGRAM_SPANS[5:]), s, rng.uniform(s, b)))
        for _ in range(20):
            s = rng.uniform(t0 - 10, t0 + length)
            events.append(_kernel(s, s + rng.uniform(0.1, 20)))
        t0 += length + rng.uniform(1, 50)
    t = read_chrome_trace(events)
    value, split = spans.fdfd_backsolve_idle_share(_record(events))
    assert sum(split.values()) == pytest.approx(100 * (1 - t.busy_s / t.window_s), abs=1e-9)


def test_a_trace_without_program_spans_gives_nothing():
    events = [_span(REQUEST_SPAN, 0, 100), _kernel(10, 20),
              _event("cpu_op", "aten::mm", 30, 10)]
    r = _record(events)
    readers = ("fdtd_setup_idle_share", "fdtd_advance_idle_share", "fdfd_backsolve_idle_share",
               "fdfd_refine_idle_share", "fdfd_inner_solves_per_call")
    assert all(getattr(spans, name)(r) is None for name in readers)
    # the FDFD spans say nothing of FDTD's
    assert spans.fdtd_setup_idle_share(_record(FDFD_EVENTS)) is None


def test_a_traced_batch_run_counts_an_inner_solve_a_round(tiny_root, cpu_threads):
    cell = cells.find_cell(tiny_name("fdfd-hard.1024-batch16"), tiny_root,
                           tiny_root.parent / "portbench")
    r = run_cell(cell, 2**31 + 29, 0.1, True, "cpu")
    m = r["metrics"]
    assert r["correct"] and m["fdfd_rounds_per_source"]["value"] >= 1
    assert m["fdfd_inner_solves_per_call"]["value"] == m["fdfd_rounds_per_source"]["value"]
