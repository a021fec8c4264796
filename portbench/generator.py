"""The one traffic generator: where each request's point sources lie.

A traffic file's ``sources`` entry fixes the set of positions for every
seed: ``distinct`` positions drawn uniformly, from the fixed ``table_seed``,
in the square ``region`` (shares of the grid's side, the middle half by
default). The run's ``--seed`` only chooses the order in which the requests
take them, so every seed asks for the same work. Request i takes the
``per_request`` positions that follow request i-1's in that order, cycling
through the table.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each ``stream`` of one run's seed (any
    integer; negative ones are taken modulo 2**64)."""
    return np.random.default_rng([seed & (2**64 - 1), stream])


class Sources:
    def __init__(self, N: int, spec: dict, seed: int):
        lo, hi = (int(round(s * N)) for s in spec.get("region", (0.25, 0.75)))
        table_rng = np.random.default_rng(spec.get("table_seed", 0))
        self.table = table_rng.integers(lo, hi, size=(spec["distinct"], 2)).tolist()
        self.order = rng(seed, 0).permutation(len(self.table))
        self.per_request = spec.get("per_request", 1)

    def __call__(self, i: int):
        """The (row, col) positions of request i (negative i: warm-up)."""
        n = len(self.table)
        return [tuple(self.table[self.order[(i * self.per_request + k) % n]])
                for k in range(self.per_request)]
