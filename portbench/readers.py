"""What the metric readers compute. Each ``metrics/<name>.py`` names one of
these as its ``read``, so that a later metric of the same quantity in other
cells (its own name, its own bound) is one more small file. A reader that
finds nothing to read returns None."""

from __future__ import annotations

from portbench import roofline
from portbench.stats import percentile


def _calls(record, key):
    return [r for r in record.requests if key in r]


def gcells_s(record):
    """Cell updates (N x M x steps) of every call completed in the window, in
    billions, over the window's seconds."""
    calls = _calls(record, "cell_steps")
    return sum(r["cell_steps"] for r in calls) / record.window_s / 1e9 if calls else None


def sources_s(record):
    """Sources solved in the window over its seconds."""
    calls = _calls(record, "sources")
    return sum(r["sources"] for r in calls) / record.window_s if calls else None


def solve_p95_ms(record):
    """The nearest-rank 95th percentile of the times of all the window's
    solve requests, each from the call until its fields are on the device
    and the device is synchronized."""
    times = [r["seconds"] for r in _calls(record, "sources")]
    return percentile(times, 95) * 1e3 if times else None


def peak_mem_gb(record):
    """torch.cuda.max_memory_allocated over set-up and the window, 1e9 bytes."""
    return record.peak_bytes / 1e9 if record.peak_bytes else None


def setup_s(record):
    """Seconds from the process's start to the window's: imports, the
    kernels' build or load, the scene, the program's set-up, the warm-up."""
    return record.setup_s


def _per(record, key):
    total = sum(r.get(key, 0) for r in record.requests)
    if record.trace is None or not total or not record.trace.launches:
        return None
    return record.trace.launches / total


def launches_per_step(record):
    """Device operations (kernels, copies, memsets) in the traced requests
    over the FDTD steps they advanced."""
    return _per(record, "steps")


def launches_per_source(record):
    """Device operations in the traced requests over the sources solved."""
    return _per(record, "sources")


def fdtd_roofline(record):
    """The least time the traced calls' FDTD work can take on the card
    (roofline.py, each call on its own), as a share of the summed time of
    every device operation in the traced requests; ``bound`` says which of
    compute and memory bounds it."""
    calls = _calls(record, "steps")
    if record.trace is None or not calls or record.trace.device_s <= 0:
        return None
    least, bounds = 0.0, set()
    for r in calls:
        work = roofline.fdtd_call_work(r["rows"], r["cols"], r["steps"], r["itemsize"])
        bound = roofline.least_seconds(*work, record.card)
        if bound is None:
            return None
        least += bound[0]
        bounds.add(bound[1])
    return 100.0 * least / record.trace.device_s, {"bound": "/".join(sorted(bounds))}


def _idle(record, key):
    t = record.trace
    if t is None or not _calls(record, key) or not t.launches:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def fdtd_idle_share(record):
    """The share of the traced FDTD requests' time in which no operation ran
    on the device."""
    return _idle(record, "steps")


def fdfd_idle_share(record):
    """The share of the traced FDFD requests' time in which no operation ran
    on the device."""
    return _idle(record, "sources")


def rounds_per_source(record):
    """Complex64 inner solves a source went through, from the residual trace
    each call returns (a batched call's rounds serve each of its sources)."""
    calls = _calls(record, "rounds")
    n = sum(r["sources"] for r in calls)
    return sum(r["rounds"] * r["sources"] for r in calls) / n if n else None


def factor_s(record):
    """Host seconds of the direct solver's construction in set-up (operator,
    factor, float64 operator), the device synchronized at both ends."""
    return record.spans.get("factor_s")
