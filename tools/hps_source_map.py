"""The HPS cell's map of every source: how far a seed's check can read.

``fdfd-hps.2048-batch16`` (BENCHMARK.json) solves 16 of a fixed table of 256
point sources a request, refines each batch until its worst residual first
reaches 1e-6, and holds the kept fields to ``fdfd_field_err``'s limit. A
source's residual and error after round k do not depend on the batch it
rides in, so the most any seed can read is the largest error after round 2
among the sources whose round-2 residual is at most the target, or, where a
batch needs a third round, the largest after round 3. This script solves all
256 sources, in batches of 16, with 2 and with 3 rounds, on the cell's own
program set-up (``drivers/fdfd_hps.py``), and holds every field to the exact
complex128 solution of the cell's check (``reference/fdfd_sublattice.py``),
with the reference's own operator for the residuals.

Run on the card from the root of a checkout (about 3 minutes at 2048^2):

    python tools/hps_source_map.py [--out chiprun_out/hps_source_map.json]

It prints, and writes as JSON, each source's residual and error after each
round count, and the two readings above.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.cells import find_cell  # noqa: E402
from portbench.reference import fdfd as ref  # noqa: E402
from portbench.reference.fdfd_sublattice import OneAtATime  # noqa: E402

CELL = "fdfd-hps.2048-batch16"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="chiprun_out/hps_source_map.json")
    parser.add_argument("--exact-batch", type=int, default=64,
                        help="sources the reference solves at once")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    cell = find_cell(CELL)
    driver = cell.module("drivers", "fdfd_hps").Driver(cell, 0, dev)
    driver.setup()
    c, N = driver.cfg, driver.N
    target = c["refine_target"]
    table = [tuple(p) for p in driver.sources.table]
    t0 = time.perf_counter()
    A = ref.operator(driver.eps, driver.mu, c["dx"], c["dx"], c["omega"], c["pml"]["cells"],
                     c["pml"]["sigma_max"], c["pml"]["order"])
    exact = OneAtATime(A, (N, N), dev)
    del A
    want, want_res = [], []
    for s in range(0, len(table), args.exact_batch):
        b = torch.as_tensor(ref.point_sources((N, N), table[s : s + args.exact_batch], c["omega"])
                            .reshape(-1, N, N), device=dev)
        w, wr = exact.solve(b)
        want.append(w)
        want_res.append(wr)
    want, want_res = torch.cat(want), torch.cat(want_res)
    exact_s = time.perf_counter() - t0
    per_source = {r: {"residual": [], "error": []} for r in (2, 3)}
    per = cell.traffic["sources"]["per_request"]
    for s in range(0, len(table), per):
        pos = table[s : s + per]
        src = driver._point_sources(pos)
        b = torch.as_tensor(ref.point_sources((N, N), pos, c["omega"]).reshape(-1, N, N),
                            device=dev)
        wk = want[s : s + per]
        for rounds in (2, 3):
            x, _, _ = driver.solver.solve_batched(src, refine_target=0.0,
                                                  max_refine_rounds=rounds, return_split=True)
            e = (torch.linalg.vector_norm(x - wk, dim=(1, 2))
                 / torch.linalg.vector_norm(wk, dim=(1, 2)))
            r = (torch.linalg.vector_norm(b - exact.apply(x), dim=(1, 2))
                 / torch.linalg.vector_norm(b, dim=(1, 2)))
            per_source[rounds]["error"] += e.cpu().tolist()
            per_source[rounds]["residual"] += r.cpu().tolist()
            del x
    r2, e2 = (np.array(per_source[2][k]) for k in ("residual", "error"))
    met = r2 <= target
    out = {"cell": CELL, "card": torch.cuda.get_device_name(dev), "sources": len(table),
           "exact_residual_max": float(want_res.max()), "exact_s": exact_s,
           "round2_met": int(met.sum()),
           "round2_worst_error_where_met": float(e2[met].max()) if met.any() else None,
           "round2_worst_residual": float(r2.max()),
           "round3_worst_error": float(max(per_source[3]["error"])),
           "round3_worst_residual": float(max(per_source[3]["residual"])),
           "per_source": {str(k): v for k, v in per_source.items()},
           "positions": table}
    print(json.dumps({k: v for k, v in out.items() if k not in ("per_source", "positions")}))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
