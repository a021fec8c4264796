"""Idle device time put down to the program's own spans.

The program (``fdtd2d_tpu_torch/utils/trace.py``) records a span at each
layer boundary as a ``torch.profiler.record_function`` annotation, so in a
``--trace 1`` run its spans are host events of the traced window
(``record.trace.host``) on the clock of the device events. Inside each
request span, every stretch in which no device operation runs is cut at
every program-span boundary; each piece goes to the innermost program span
open over it (of nested spans, the one that started last), or to
``outside`` where none is. The pieces of every label sum to the window's
idle time, ``window − busy``.

The names are this file's own, so that a renamed span in the program leaves
the yardstick as it is and its readers report nothing. A reader returns
None where its spans are absent (a program without them) or where the run
has no device operations (the CPU).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.profile import gaps

PROGRAM_SPANS = (
    "fdtd.simulate", "fdtd.setup", "fdtd.advance",                 # fdtd/simulate.py
    "fdfd.solve", "fdfd.solve_batched", "fdfd.backsolve",          # fdfd/direct.py
    "fdfd.refine.residual", "fdfd.refine.read",                    # fdfd/refine.py
)
OUTSIDE = "outside"


def program_spans(window) -> list:
    """``(name, start, end)`` of the program's spans in the window, by start
    (of two that start together, the outer first)."""
    return sorted((h for h in window.host if h[0] in PROGRAM_SPANS),
                  key=lambda h: (h[1], -h[2]))


def _segments(spans) -> list:
    """The timeline from the first span boundary to the last, cut at every
    boundary: ``(start, end, label)``, the label the innermost span open
    over the piece, or OUTSIDE."""
    points = sorted({p for _, s, e in spans for p in (s, e)})
    out = []
    for a, b in zip(points, points[1:]):
        label = OUTSIDE
        for name, s, e in spans:          # by start: the last open one is innermost
            if s > a:
                break
            if e >= b:
                label = name
        out.append((a, b, label))
    return out


def idle_by_span(window) -> dict:
    """Seconds of device idle inside the request spans, by label."""
    segments = _segments(program_spans(window))
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
            idle[OUTSIDE] += (g1 - g0) - covered
    return {label: us / 1e6 for label, us in idle.items()}


def _idle_share(record, *names):
    """100 × the idle under any of ``names`` ÷ the traced window, with the
    share of every label (``under.<label>``) beside it."""
    t = record.trace
    if t is None or not t.launches or not t.window_s:
        return None
    if not {name for name, _, _ in program_spans(t)} & set(names):
        return None
    shares = {label: 100.0 * s / t.window_s for label, s in idle_by_span(t).items()}
    split = {f"under.{label}": shares[label] for label in sorted(shares)}
    return sum(shares.get(name, 0.0) for name in names), split


def fdtd_setup_idle_share(record):
    """Device idle under ``fdtd.setup`` (a call's tensors, state copy,
    coefficients, backend) as a share of the traced window."""
    return _idle_share(record, "fdtd.setup")


def fdtd_advance_idle_share(record):
    """Device idle under ``fdtd.advance`` (the kernel wrapper's layout copies
    and its launches) as a share of the traced window."""
    return _idle_share(record, "fdtd.advance")


def fdfd_backsolve_idle_share(record):
    """Device idle under ``fdfd.backsolve`` (the complex64 inner solve's row
    loops) as a share of the traced window."""
    return _idle_share(record, "fdfd.backsolve")


def fdfd_refine_idle_share(record):
    """Device idle under ``fdfd.refine.residual`` or ``fdfd.refine.read``
    (the complex128 residual passes and the host's reads of their norms) as
    a share of the traced window."""
    return _idle_share(record, "fdfd.refine.residual", "fdfd.refine.read")


def fdfd_inner_solves_per_call(record):
    """``fdfd.backsolve`` spans that start inside a traced request, over the
    traced requests: the complex64 inner solves a call."""
    t = record.trace
    if t is None or not t.spans:
        return None
    starts = [s for s, _ in t.spans]
    n = 0
    for name, start, _ in program_spans(t):
        k = bisect.bisect_right(starts, start) - 1
        if name == "fdfd.backsolve" and k >= 0 and start < t.spans[k][1]:
            n += 1
    return n / len(t.spans) if n else None
