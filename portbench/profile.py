"""The traced window: torch.profiler around the requests of a ``--trace 1``
run, reduced to device intervals, host intervals and request spans.

Each request runs inside a ``portbench.request`` annotation that ends after
the device is synchronized, so its device work lies inside its span. The
traced window is the union of those spans: what the harness does between
requests (keeping samples for the check) is left out. The interval
arithmetic (``union``, the gaps) is that of the repository's
``tools/profile_fdtd.py``, copied here so that the yardstick stays fixed.
The Chrome trace goes to a file under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
REQUEST_SPAN = "portbench.request"


def union(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + (cur_end - cur_start if cur_end is not None else 0.0)


def gaps(intervals, lo: float, hi: float):
    """The ``(start, end)`` stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for start, end in sorted(intervals):
        if start > cur:
            out.append((cur, min(start, hi)))
        cur = max(cur, end)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [g for g in out if g[1] > g[0]]


@dataclass
class TraceWindow:
    """Intervals in microseconds on the profiler's clock."""
    spans: list                                   # (start, end) of each request
    device: list = field(default_factory=list)    # (name, start, end), inside the spans
    host: list = field(default_factory=list)      # (name, start, end)

    @property
    def window_s(self) -> float:
        return sum(end - start for start, end in self.spans) / 1e6

    @property
    def busy_s(self) -> float:
        return union([(s, e) for _, s, e in self.device]) / 1e6

    @property
    def device_s(self) -> float:
        """Summed duration of every device operation (overlaps count twice)."""
        return sum(e - s for _, s, e in self.device) / 1e6

    @property
    def launches(self) -> int:
        return len(self.device)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations by total seconds, and the idle gaps inside
        the request spans by what the host was doing (the innermost host
        event open at the gap's middle, else the request span)."""
        ops = defaultdict(float)
        for name, s, e in self.device:
            ops[name] += (e - s) / 1e6
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        idle = defaultdict(float)
        busy = sorted((s, e) for _, s, e in self.device)
        busy_starts = [s for s, _ in busy]
        for lo, hi in self.spans:
            inside = busy[bisect.bisect_left(busy_starts, lo) : bisect.bisect_right(busy_starts, hi)]
            for g0, g1 in gaps(inside, lo, hi):
                mid = (g0 + g1) / 2
                label = REQUEST_SPAN
                # of nested host events, the innermost open at ``mid`` is the
                # one that started last; look back a bounded way for it
                k = bisect.bisect_right(starts, mid) - 1
                for name, s, e in reversed(host[max(k - 255, 0) : k + 1]):
                    if e >= mid:
                        label = name
                        break
                idle[label] += (g1 - g0) / 1e6

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def read_chrome_trace(events) -> TraceWindow:
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name") == REQUEST_SPAN)
    window = TraceWindow(spans=spans)
    span_starts = [s for s, _ in spans]
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATEGORIES:
            k = bisect.bisect_right(span_starts, start) - 1
            if k >= 0 and start < spans[k][1]:
                window.device.append((e["name"], start, min(end, spans[k][1])))
        elif e.get("cat") in HOST_CATEGORIES:
            window.host.append((e["name"], start, end))
    return window


@contextlib.contextmanager
def traced(enabled: bool):
    """``with traced(True) as result: ...``; afterwards ``result[0]`` is the
    TraceWindow of the enclosed requests (None when not enabled)."""
    result = [None]
    if not enabled:
        yield result
        return
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield result
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            result[0] = read_chrome_trace(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def request_span():
    """The annotation around one request."""
    import torch

    return torch.profiler.record_function(REQUEST_SPAN)
