"""Unique-scene scaling table of the diffusion surrogate (counterpart of
``examples/surrogate_scaling_table.py``).

Collates holdout reports (``holdout_report.npz`` of
``fdtd2d_tpu_torch.apps.surrogate_report`` or ``examples/surrogate_report.py``)
into one markdown table: each run's ensemble-readout Pearson correlation
(mean, median, best), its amplitude-fitted relative L2 and its one-call
correlation. Reads numpy files only.

Run: python -m fdtd2d_tpu_torch.apps.surrogate_scaling_table LABEL=REPORT.npz ...
     (no arguments: the JAX package's two banked reports in assets/, and the
     port's, assets/surrogate_torch_x0/, where it exists)
"""

from __future__ import annotations

import os
import sys

import numpy as np

DEFAULT = [
    ("10k scenes, 100 ep (JAX, r3 banked; x0, no EMA, no augment)",
     "assets/surrogate_x0/holdout_report.npz"),
    ("16k scenes, 23 ep, seed 0 (JAX, r4; x0, EMA 0.999, D4 augment)",
     "assets/surrogate_16k_s0/holdout_report.npz"),
]
PORT = ("10k scenes, x0, no EMA, no augment (PyTorch port, H100)",
        "assets/surrogate_torch_x0/holdout_report.npz")
HEADER = ("| run | ens. corr mean | median | best | rel-L2 (fit) | one-call corr |\n"
          "|---|---|---|---|---|---|")


def row(label: str, path: str) -> str:
    try:
        d = np.load(path)
    except OSError:
        return f"| {label} | — | — | — | — | (missing: {path}) |"
    ce = d["corr_e"] if "corr_e" in d.files else d["corr"]
    rf = d["rel_fit_e"] if "rel_fit_e" in d.files else d["rel_fit"]
    one_call = f"{np.mean(d['corr_r']):.3f}" if "corr_r" in d.files else "—"
    return (f"| {label} | {np.mean(ce):.3f} | {np.median(ce):.3f} | "
            f"{np.max(ce):.3f} | {np.mean(rf):.3f} | {one_call} |")


def default_pairs() -> list:
    return DEFAULT + ([PORT] if os.path.exists(PORT[1]) else [])


def table(pairs) -> str:
    return "\n".join([HEADER] + [row(label, path) for label, path in pairs])


def main(argv=None) -> int:
    args = [a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv)]
    print(table([(a[0], a[1]) for a in args] if args else default_pairs()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
