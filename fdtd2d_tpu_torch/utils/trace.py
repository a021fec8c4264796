"""Spans and counters at the port's layer boundaries.

- :func:`span` — ``with span("fdfd.backsolve"): ...`` adds 1 to the counter
  of that name and, only while a ``torch.profiler`` profile is running,
  records the block as ``torch.profiler.record_function(name)``. The spans
  are then host events of the profiler's own trace, on the clock of its
  device events, nested as the calls nest. With no profiler running a span
  is one dict increment and one flag read: no ``record_function`` is built.
  Nothing switches spans on but the profiler: ``utils.trace_profile``,
  ``tools/profile_*.py`` and the benchmark's traced runs all see them.
- :func:`count` — adds to a counter without a span (kernel launches).
- :func:`counters` — a snapshot of every counter; a caller reads the work of
  a block as the difference of two snapshots (:func:`delta`).

Names are dotted by layer: ``fdtd.simulate``, ``fdtd.setup``,
``fdtd.advance`` (fdtd/simulate.py); ``fdtd.kernels.launches``, the launches
of whichever FDTD kernel ran, and per kernel ``fdtd.kernels.k1``,
``.k1_resident``, ``.k2_sweeps``, ``.k2_block_sweeps``, ``.k3`` (ops/);
``fdfd.solve``, ``fdfd.solve_batched``, ``fdfd.backsolve`` (fdfd/direct.py);
``fdfd.refine.residual``, ``fdfd.refine.read`` (fdfd/refine.py).
"""

from __future__ import annotations

from collections import defaultdict

import torch

_counts = defaultdict(int)
_profiling = torch._C._autograd._profiler_enabled


class span:
    """Context manager: counts ``name`` and, under the profiler, records it."""

    __slots__ = ("name", "_record")

    def __init__(self, name: str):
        self.name = name
        self._record = None

    def __enter__(self):
        _counts[self.name] += 1
        if _profiling():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counters() -> dict:
    """A snapshot of every counter: ``{name: total since the process began}``."""
    return dict(_counts)


def delta(before: dict, name: str) -> int:
    """What counter ``name`` gained since the snapshot ``before``."""
    return _counts.get(name, 0) - before.get(name, 0)
