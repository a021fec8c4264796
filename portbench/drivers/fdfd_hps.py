"""Request loop of FDFD direct solves by nested dissection: set-up builds the
port's ``fdtd2d_tpu_torch.fdfd.direct.DirectSolver(..., hps=True,
hps_leaf=<configuration's hps_leaf>)`` on the configuration's scene (its
factor: ``factor_s``); a request is one ``solve_batched(sources,
refine_target=<configuration's refine_target>, return_split=True)`` call of
``sources.per_request`` unit point sources against that one factor, and
returns the complex128 iterate itself, so that the check holds the stated
guarantee and not a downcast of it.

Traffic keys as drivers/fdfd_direct.py's, whose scene, sources and gate
this loop takes over. A request's work names the grid, the leaf and the
sources, from which a reader counts the least work of its inner solves.

The check assembles the operator itself (reference/fdfd.py, scipy,
complex128) and solves every kept source exactly with it on the device,
all in one batch, one sublattice at a time (reference/fdfd_sublattice.py).
Over every field that the kept requests returned, as the program returned
it, it reads ``fdfd_residual``, the worst true relative residual with the
reference's own operator, against the configuration's ``refine_target``,
and ``fdfd_field_err``, the worst ||x - x_exact|| / ||x_exact||, against
the traffic's limit.

The control is drivers/fdfd_direct.py's: the same refinement with its
residuals in complex64, the step a later change to the refinement that
both FDFD configurations share would take. It runs the program's own
complex64 operator and HPS factor, ``r = b - A x`` and
``x += |r| A^-1 (r/|r|)`` all in complex64, under the program's stopping
rule.
"""

from __future__ import annotations

import importlib
import math
import time
from pathlib import Path

import numpy as np
import torch

from portbench.cells import load_module
from portbench.reference import fdfd as ref
from portbench.reference.fdfd_sublattice import OneAtATime

_direct = load_module(Path(__file__).resolve().parents[1], "drivers", "fdfd_direct")
EXACT = _direct.EXACT


class Driver(_direct.Driver):
    def __init__(self, cell, seed: int, device, entry: str = "program"):
        super().__init__(cell, seed, device, entry)
        self.leaf = self.cfg["hps_leaf"]

    def setup(self) -> dict:
        self.direct = importlib.import_module("fdtd2d_tpu_torch.fdfd.direct")
        self.hps = importlib.import_module("fdtd2d_tpu_torch.fdfd.hps")
        c = self.cfg
        self._sync()
        start = time.perf_counter()
        self.solver = self.direct.DirectSolver(
            self.eps, self.mu, c["dx"], c["dx"], c["omega"], pml_thickness=c["pml"]["cells"],
            sigma_max=c["pml"]["sigma_max"], m=c["pml"]["order"], hps=True,
            hps_leaf=self.leaf, device=self.device)
        self._sync()
        return {"factor_s": time.perf_counter() - start}

    def _refined_in_complex64(self, src):
        """The control: (fields, rounds)."""
        op, target = self.solver.op, self.cfg["refine_target"]
        b = src.to(torch.complex64) * (-1j * self.cfg["omega"])
        x = torch.zeros_like(b)
        bn = torch.linalg.vector_norm(b, dim=(1, 2))
        prev, rounds = math.inf, 0
        for _ in range(8):
            r = op.residual(b, x)
            rn = torch.linalg.vector_norm(r, dim=(1, 2))
            worst = float((rn / bn).max())
            if worst <= target or worst >= 0.9 * prev:
                break
            prev, rounds = worst, rounds + 1
            d = self.hps.hps_solve(self.solver.factors, r / rn[:, None, None])
            x = x + rn[:, None, None] * d
        return x, rounds

    def request(self, i: int):
        positions = self.sources(i)
        src = self._point_sources(positions)
        if self.entry == "control":
            fields, rounds = self._refined_in_complex64(src)
        else:
            fields, _, trace = self.solver.solve_batched(
                src, refine_target=self.cfg["refine_target"], return_split=True)
            rounds = len(trace) - 1
        return fields, {"sources": len(positions), "rounds": rounds, "grid": self.N,
                        "hps_leaf": self.leaf}

    def check(self, kept: list) -> dict:
        """{"fdfd_residual": (worst true residual, refine_target),
        "fdfd_field_err": (worst error against the exact field, limit),
        "fdfd_exact_residual": (the exact fields' own worst residual, None)}
        over every field of the kept requests; the error reads inf where an
        exact field's own residual passes ``EXACT``."""
        c, N = self.cfg, self.N
        target = c["refine_target"]
        for k in kept:
            if tuple(k["fields"].shape) != (len(k["positions"]), N, N):
                return {"fdfd_residual": (math.inf, target),
                        "fdfd_field_err": (math.inf, self.limit)}
        A = ref.operator(self.eps, self.mu, c["dx"], c["dx"], c["omega"], c["pml"]["cells"],
                         c["pml"]["sigma_max"], c["pml"]["order"])
        exact = OneAtATime(A, (N, N), self.device)
        del A
        b = np.concatenate([ref.point_sources((N, N), k["positions"], c["omega"])
                            for k in kept]).reshape(-1, N, N)
        b = torch.as_tensor(b, device=self.device)
        want, want_res = exact.solve(b)
        err = res = 0.0
        start = 0
        for k in kept:
            n = len(k["positions"])
            bk, wk = b[start : start + n], want[start : start + n]
            start += n
            got = k["fields"].to(self.device, torch.complex128)
            e = (torch.linalg.vector_norm(got - wk, dim=(1, 2))
                 / torch.linalg.vector_norm(wk, dim=(1, 2)))
            r = (torch.linalg.vector_norm(bk - exact.apply(got), dim=(1, 2))
                 / torch.linalg.vector_norm(bk, dim=(1, 2)))
            e, r = e.cpu().numpy(), r.cpu().numpy()
            err = max(err, float(np.max(e)) if np.all(np.isfinite(e)) else math.inf)
            res = max(res, float(np.max(r)) if np.all(np.isfinite(r)) else math.inf)
        exact_res = float(want_res.max())
        if not exact_res <= EXACT:   # the judge itself is not exact: no verdict
            err = math.inf
        return {"fdfd_residual": (res, target), "fdfd_field_err": (err, self.limit),
                "fdfd_exact_residual": (exact_res, None)}
