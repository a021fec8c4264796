"""Order statistics of a run's requests."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``: the smallest
    value with at least q% of them at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    return ordered[max(math.ceil(q / 100.0 * len(ordered)), 1) - 1]
