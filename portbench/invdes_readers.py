"""Readers of the adjoint inverse-design step (the ``invdes-decade``
configuration): the HPS factor's roofline share and share of the device's
busy time, the device idle under the step's own spans, and the refinement
rounds a solve.

The least work of a step's factor is counted from N, the leaf m and the F
members alone, walking the nested dissection's levels as
hps_readers.hps_store_entries does (the program's fdtd2d_tpu_torch/fdfd/hps.py
``build_plan``, not imported): every node eliminates nJ points against nR
kept ones in complex128, an inverse of its nJ x nJ block (nJ^3 complex
multiply-adds), E = Y A_JR (nJ^2 nR) and the Schur complement A_JR^T E
(nJ nR^2); the root inverts its ring (rho^3). Each complex multiply-add is 8
float64 operations. Bytes: every node's (nJ + nR)^2 block read once and its
nR^2 Schur complement written once in complex128, its Y and E written once
in complex64, the store's dtype. The least time is the longer of the
operations at the card's float64 rate and the bytes at its HBM rate. The
four sublattices and the F members multiply both.

Peaks: NVIDIA's H100 SXM data sheet at its 700 W limit, 67 TFLOP/s float64
on the tensor cores (which complex128 products use) and 3.35 TB/s of HBM3.
A card not in the table gives no roofline.

The device time is that of the device operations that start inside the
program's ``fdfd.hps.factor`` spans. The factor waits for the card at every
level (each batched inverse's error check reads its result on the host), so
the operations it launches run inside its span; hps_readers.py's pairing of
launch calls with operations does not serve here, as cuSOLVER's launches and
operations do not pair one to one in the trace.
"""

from __future__ import annotations

from portbench import spans
from portbench.hps_readers import HPS_SPANS, _inside, idle_by_span

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float64_flops": 67e12, "hbm_bytes_s": 3.35e12},
}
FLOPS_PER_CMAC = 8
COMPLEX128, COMPLEX64 = 16, 8
FACTOR = "fdfd.hps.factor"
STEP_SPANS = ("invdes.step", "fdfd.adjoint.forward", "fdfd.adjoint.backward")


def hps_nodes(N: int, m: int = 8):
    """([(nodes, nJ, nR) a level, the leaf first], rho of the root) of one
    sublattice of an N x N grid."""
    s = N // 2
    rows = cols = s // m
    levels = [(rows * cols, (m - 2) ** 2, 4 * m - 4)]
    p = q = m
    while rows * cols > 1:
        if cols >= rows:                     # side by side in columns
            nj, p, q, cols = 2 * p - 4, p, 2 * q, cols // 2
        else:                                # one above the other
            nj, p, q, rows = 2 * q - 4, 2 * p, q, rows // 2
        levels.append((rows * cols, nj, 2 * p + 2 * q - 4))
    return levels, 2 * p + 2 * q - 4


def hps_factor_work(N: int, m: int, members: int):
    """(float64 operations, bytes) of factoring ``members`` operators."""
    levels, rho = hps_nodes(N, m)
    cmacs = sum(P * (j**3 + j * j * r + j * r * r) for P, j, r in levels) + rho**3
    nbytes = (sum(P * (COMPLEX128 * ((j + r) ** 2 + r * r) + COMPLEX64 * (j * j + j * r))
                  for P, j, r in levels)
              + COMPLEX128 * rho**2 + COMPLEX64 * rho**2)
    return 4 * members * FLOPS_PER_CMAC * cmacs, 4 * members * nbytes


def least_seconds(flops: float, nbytes: float, card: str):
    """(seconds, "compute" or "memory") at the card's float64 peaks, or None."""
    peak = PEAKS.get(card)
    if peak is None:
        return None
    compute, memory = flops / peak["float64_flops"], nbytes / peak["hbm_bytes_s"]
    return (compute, "compute") if compute >= memory else (memory, "memory")


def device_s_inside(window, name: str) -> float:
    """Seconds of the device operations that start inside spans ``name``."""
    device = sorted(window.device, key=lambda d: d[1])
    return sum((d1 - d0) / 1e6 for h, s, e in window.host if h == name
               for _, d0, d1 in _inside(device, s, e))


def _factor_device_s(record):
    t = record.trace
    if t is None or not t.launches or len(record.requests) != len(t.spans):
        return None
    if any("members" not in r for r in record.requests):
        return None
    if not any(h[0] == FACTOR for h in t.host):
        return None
    seconds = device_s_inside(t, FACTOR)
    return seconds if seconds else None


def invdes_factor_roofline(record):
    """The least time of the traced steps' HPS factors (each of its
    request's grid, leaf and members) as a share of the device time of the
    operations that start inside ``fdfd.hps.factor``; ``bound`` says which of
    compute and memory bounds it."""
    device_s = _factor_device_s(record)
    if device_s is None:
        return None
    least, bounds = 0.0, set()
    for r in record.requests:
        bound = least_seconds(*hps_factor_work(r["grid"], r["hps_leaf"], r["members"]),
                              record.card)
        if bound is None:
            return None
        least += bound[0]
        bounds.add(bound[1])
    return 100.0 * least / device_s, {"bound": "/".join(sorted(bounds)),
                                      "factor_device_ms": device_s * 1e3}


def invdes_factor_share(record):
    """Device time of the operations that start inside ``fdfd.hps.factor``
    as a share of the traced window's busy time."""
    device_s = _factor_device_s(record)
    if device_s is None or not record.trace.busy_s:
        return None
    return 100.0 * device_s / record.trace.busy_s


def invdes_adjoint_idle_share(record):
    """Device idle whose innermost open span is ``invdes.step``,
    ``fdfd.adjoint.forward`` or ``fdfd.adjoint.backward`` (the step's own
    work outside the factor, the sweeps and the refinement: operators, loss,
    gradient, update) as a share of the traced window, every label's share
    (``under.<label>``) beside it."""
    t = record.trace
    if t is None or not t.launches or not t.window_s:
        return None
    if not any(h[0] in STEP_SPANS for h in t.host):
        return None
    names = set(spans.PROGRAM_SPANS) | set(HPS_SPANS) | set(STEP_SPANS) | {FACTOR}
    shares = {label: 100.0 * s / t.window_s for label, s in idle_by_span(t, names).items()}
    split = {f"under.{label}": shares[label] for label in sorted(shares)}
    return sum(shares.get(name, 0.0) for name in STEP_SPANS), split


def invdes_rounds_per_solve(record):
    """Complex64 inner solves a forward or adjoint solve went through: the
    program's ``fdfd.hps.solves`` (one a round, every member at once) times
    the members, over its ``fdfd.adjoint.solves`` (one a member a
    direction)."""
    calls = [r for r in record.requests if r.get("adjoint_solves")]
    n = sum(r["adjoint_solves"] for r in calls)
    return sum(r["inner_solves"] * r["members"] for r in calls) / n if n else None
