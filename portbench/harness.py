"""One run of one cell: set-up, the measured window, the check, the result.

The window is a closed loop with one caller: each request starts when the
last one has returned and the device is synchronized, for ``seconds``
seconds; the request in flight when the time is up is finished and
counted, and the window ends when it returns. With ``trace`` the loop runs
the traffic's ``trace_requests`` requests instead, under torch.profiler,
and the run reports the per-layer metrics in place of the end-to-end ones.

Of the window's requests the check keeps ``check.sample`` drawn from the
seed among the first ``check.pool``, and the last; each kept answer is
copied to the host when it returns, between two requests, and the seconds
of that copy are taken out of the window (the traced window leaves them
out too). Once the window has closed and the peak memory is read, the
program's state is freed and the request loop compares the kept answers
with its plain reference.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
import traceback
from dataclasses import dataclass

import torch

from portbench import generator, profile, stats


@dataclass
class Record:
    """What the metric readers read (metrics/<name>.py, ``read(record)``)."""
    card: str
    setup_s: float
    spans: dict                  # set-up spans, seconds by name
    window_s: float
    requests: list               # one dict a request: "seconds" and its work counters
    peak_bytes: int
    trace: profile.TraceWindow | None = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(traffic: dict, seed: int, limit: int) -> set:
    check = traffic["check"]
    pool = min(check["pool"], limit)
    k = min(check["sample"], pool)
    return set(generator.rng(seed, 1).choice(pool, size=k, replace=False).tolist())


def read_metrics(cell, record: Record, entries) -> dict:
    out = {}
    for entry in entries:
        value = cell.module("metrics", entry["name"]).read(record)
        if value is None:
            continue
        extra = {}
        if isinstance(value, tuple):
            value, extra = value
        out[entry["name"]] = {"value": float(value), "unit": entry["unit"], **extra}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *, t0: float | None = None,
             entry: str = "program", log=sys.stderr) -> dict:
    """Run ``cell`` once and return the result line's object, with the
    compared numbers under ``checks`` (last). ``t0``: the host clock at the
    process's start, from which ``setup_s`` counts."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.empty(0, device=device)   # the context first: the peak's counters live in it
        torch.cuda.reset_peak_memory_stats(device)
    driver = cell.module("drivers", cell.traffic["driver"]).Driver(cell, seed, device, entry)
    spans = driver.setup()
    driver.warm()
    _sync(device)

    n_traced = cell.traffic["trace_requests"] if trace else None
    sample = _sample(cell.traffic, seed, n_traced or cell.traffic["check"]["pool"])
    span = profile.request_span if trace else contextlib.nullcontext
    requests, kept, failed, last, keep_s = [], [], 0, None, 0.0
    with profile.traced(trace) as traced:
        setup_s = time.perf_counter() - t0
        start = time.perf_counter()
        i = 0
        while True:
            begin = time.perf_counter()
            try:
                with span():
                    answer, work = driver.request(i)
                    _sync(device)
            except Exception:  # a failed request is counted, and the run goes on
                failed += 1
                if failed == 1:
                    traceback.print_exc(file=log)
                answer, work = None, {}
            end = time.perf_counter()
            requests.append({"seconds": end - begin, **work})
            last = (i, answer)
            if i in sample and answer is not None:
                kept.append(driver.keep(i, answer))
                keep_s += time.perf_counter() - end
            i += 1
            if (i >= n_traced) if trace else (end - start - keep_s >= seconds):
                break
        window_s = end - start - keep_s
    if last[1] is not None and last[0] not in sample:
        kept.append(driver.keep(*last))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    answer = last = None
    driver.close()
    if cuda:
        torch.cuda.empty_cache()

    check_start = time.perf_counter()
    checks = driver.check(kept) if kept else {}
    compared = {k: v for k, v in checks.items() if v[1] is not None}
    info = {k: v for k, (v, limit) in checks.items() if limit is None}
    info["check_s"] = time.perf_counter() - check_start
    correct = (failed == 0 and bool(compared)
               and all(math.isfinite(v) and v <= limit for v, limit in compared.values()))
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    record = Record(card, setup_s, spans, window_s, requests, peak, traced[0])
    metrics = read_metrics(cell, record, cell.per_layer if trace else cell.end_to_end)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card, "count": 1,
           "memory_peak_bytes": int(peak)}
    times = [r["seconds"] * 1e3 for r in requests]
    result = {"correct": correct, "attempted": len(requests), "failed": failed,
              "metrics": metrics, "device": dev,
              "request_ms": {"p5": stats.percentile(times, 5), "median": stats.percentile(times, 50),
                             "p95": stats.percentile(times, 95), "max": max(times)}}
    if traced[0] is not None:
        dev["busy_s"] = traced[0].busy_s
        dev["window_s"] = traced[0].window_s
        result["breakdown"] = traced[0].breakdown()
    result["check_info"] = info
    result["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in compared.items()}
    return result
