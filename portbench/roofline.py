"""Peaks of the cards the benchmark knows, and the least time the FDTD
work of a call can take on them.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3. A card not
in the table has no roofline, and a reader then reports nothing.

The work of one ``simulate`` call is counted from its shapes alone, so it
reads the same whatever kernel does it:

- operations: 11 float32 operations a cell a step (the H update: two
  differences, two products and two updates; the Ez update: three
  differences of the curl, one product, one update);
- bytes: Ez, Hx, Hy and the two coefficient arrays read once, Ez, Hx, Hy
  written once.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}
FDTD_FLOPS_PER_CELL_STEP = 11
FDTD_ARRAYS_READ = 5       # Ez, Hx, Hy, ce, ch
FDTD_ARRAYS_WRITTEN = 3    # Ez, Hx, Hy


def fdtd_call_work(rows: int, cols: int, steps: int, itemsize: int = 4):
    """(operations, bytes) of one call on a rows x cols grid."""
    cells = rows * cols
    flops = FDTD_FLOPS_PER_CELL_STEP * cells * steps
    nbytes = itemsize * cells * (FDTD_ARRAYS_READ + FDTD_ARRAYS_WRITTEN)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, card: str):
    """(seconds, "compute" or "memory") of work at the card's peaks, or None
    for a card not in the table."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    compute = flops / peak["float32_flops"]
    memory = nbytes / peak["hbm_bytes_s"]
    return (compute, "compute") if compute >= memory else (memory, "memory")
