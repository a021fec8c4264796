"""Readers of the HPS backsolve (the ``fdfd-hps`` configuration): its least
work, its roofline share and the device idle under its sweeps.

The work of one HPS inner solve is counted from N, the leaf m and the K
right-hand sides alone, by walking the nested dissection's levels as the
program's plan does (fdtd2d_tpu_torch/fdfd/hps.py ``build_plan``) without
importing it: the four sublattices of side N/2 are tiled by m x m leaves;
a leaf eliminates its (m-2)^2 interior points against its 4m-4 ring points;
each merge of two p x q boxes side by side eliminates the interface points
off the parent's ring and keeps the parent's ring; the root inverts its
ring. Every stored Y (eliminated x eliminated) and E (eliminated x kept),
complex64, is read once, and the K right-hand sides are read and written
once in complex64. A solve multiplies each Y by the K right-hand sides once
and each E twice (up and down): 8 float32 operations a complex multiply-add.
The least time is the longer of the bytes at the card's HBM rate and the
operations at its float32 rate (roofline.py).

The device time it is compared with is that of the device operations
launched inside the program's ``fdfd.backsolve`` spans. The trace holds no
link from a launch to its operation, so each request's launch calls (host
events named ``cu(da)Launch*``, ``cu(da)Memcpy*``, ``cu(da)Memset*``) are
paired in order with its device operations, one stream running them in
order; a request whose counts differ gives no reading.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

from portbench import roofline, spans
from portbench.profile import gaps

COMPLEX64 = 8
FLOPS_PER_CMAC = 8
HPS_SPANS = ("fdfd.hps.split", "fdfd.hps.up", "fdfd.hps.root", "fdfd.hps.down")
BACKSOLVE = "fdfd.backsolve"
LAUNCH = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")


def hps_store_entries(N: int, m: int = 8):
    """(entries of every stored Y, of every stored E), the four sublattices
    of an N x N grid together."""
    s = N // 2
    rows = cols = s // m
    ni, ring = (m - 2) ** 2, 4 * m - 4
    y, e = rows * cols * ni * ni, rows * cols * ni * ring
    p = q = m
    while rows * cols > 1:
        if cols >= rows:                     # side by side in columns
            nj, p, q, cols = 2 * p - 4, p, 2 * q, cols // 2
        else:                                # one above the other
            nj, p, q, rows = 2 * q - 4, 2 * p, q, rows // 2
        nr = 2 * p + 2 * q - 4
        y += rows * cols * nj * nj
        e += rows * cols * nj * nr
    y += (2 * p + 2 * q - 4) ** 2
    return 4 * y, 4 * e


def hps_solve_work(N: int, m: int, K: int):
    """(float32 operations, bytes) of one inner solve of K right-hand sides."""
    y, e = hps_store_entries(N, m)
    return (FLOPS_PER_CMAC * K * (y + 2 * e),
            COMPLEX64 * (y + e) + 2 * COMPLEX64 * K * N * N)


def _inside(items, lo, hi):
    """The (name, start, end) items whose start lies in [lo, hi]."""
    starts = [s for _, s, _ in items]
    return items[bisect.bisect_left(starts, lo) : bisect.bisect_right(starts, hi)]


def backsolve_device_s(window):
    """(seconds of the device operations launched inside ``fdfd.backsolve``
    spans, the spans by request), or None where a request's launch calls
    and device operations do not pair one to one."""
    device = sorted(window.device, key=lambda d: d[1])
    launches = sorted((h for h in window.host if LAUNCH.match(h[0])), key=lambda h: h[1])
    solves = sorted((h for h in window.host if h[0] == BACKSOLVE), key=lambda h: h[1])
    total, per_request = 0.0, []
    for lo, hi in window.spans:
        ops, calls = _inside(device, lo, hi), _inside(launches, lo, hi)
        if len(ops) != len(calls):
            return None
        starts = [s for _, s, _ in calls]
        inner = _inside(solves, lo, hi)
        for _, s, e in inner:
            for _, d0, d1 in ops[bisect.bisect_left(starts, s) : bisect.bisect_right(starts, e)]:
                total += (d1 - d0) / 1e6
        per_request.append(len(inner))
    return total, per_request


def fdfd_hps_roofline(record):
    """The least time of the traced requests' HPS inner solves (one a
    ``fdfd.backsolve`` span, each of its request's grid, leaf and sources)
    as a share of the device time of the operations launched inside those
    spans; ``bound`` says which of compute and memory bounds it."""
    t = record.trace
    if t is None or not t.launches or len(record.requests) != len(t.spans):
        return None
    if any("hps_leaf" not in r for r in record.requests):
        return None
    measured = backsolve_device_s(t)
    if measured is None or measured[0] <= 0:
        return None
    device_s, solves = measured
    least, bounds = 0.0, set()
    for r, n in zip(record.requests, solves):
        bound = roofline.least_seconds(*hps_solve_work(r["grid"], r["hps_leaf"], r["sources"]),
                                       record.card)
        if bound is None:
            return None
        least += n * bound[0]
        bounds.add(bound[1])
    if not least:
        return None
    return 100.0 * least / device_s, {"bound": "/".join(sorted(bounds)),
                                      "backsolve_device_ms": device_s * 1e3}


def idle_by_span(window, names) -> dict:
    """spans.idle_by_span with the program spans ``names``: seconds of
    device idle inside the request spans, by the innermost of them open
    over each piece, or ``outside``."""
    program = sorted((h for h in window.host if h[0] in names), key=lambda h: (h[1], -h[2]))
    segments = spans._segments(program)
    seg_starts = [s for s, _, _ in segments]
    busy = sorted((s, e) for _, s, e in window.device)
    busy_starts = [s for s, _ in busy]
    idle = defaultdict(float)
    for lo, hi in window.spans:
        inside = busy[bisect.bisect_left(busy_starts, lo) : bisect.bisect_right(busy_starts, hi)]
        for g0, g1 in gaps(inside, lo, hi):
            covered = 0.0
            k = max(bisect.bisect_right(seg_starts, g0) - 1, 0)
            while k < len(segments) and segments[k][0] < g1:
                s, e, label = segments[k]
                piece = min(e, g1) - max(s, g0)
                if piece > 0:
                    idle[label] += piece
                    covered += piece
                k += 1
            idle[spans.OUTSIDE] += (g1 - g0) - covered
    return {label: us / 1e6 for label, us in idle.items()}


def fdfd_hps_sweep_idle_share(record):
    """Device idle under ``fdfd.hps.split``, ``.up``, ``.root`` or ``.down``
    (the HPS inner solve's parity split, upward merges, root and downward
    back-substitution) as a share of the traced window, every label's
    share (``under.<label>``) beside it."""
    t = record.trace
    if t is None or not t.launches or not t.window_s:
        return None
    if not any(h[0] in HPS_SPANS for h in t.host):
        return None
    shares = {label: 100.0 * s / t.window_s
              for label, s in idle_by_span(t, set(spans.PROGRAM_SPANS) | set(HPS_SPANS)).items()}
    split = {f"under.{label}": shares[label] for label in sorted(shares)}
    return sum(shares.get(name, 0.0) for name in HPS_SPANS), split
