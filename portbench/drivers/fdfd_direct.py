"""Request loop of FDFD direct solves: set-up builds the port's
``fdtd2d_tpu_torch.fdfd.direct.DirectSolver`` on the configuration's scene
(its factor: ``factor_s``); a request is one ``solve_batched`` call of
``sources.per_request`` unit point sources against that one factor, each
refined in complex128 to the configuration's target; the call returns the
complex64 downcast of each refined field.

Traffic keys: ``grid`` (N of an N x N grid), ``sources`` (the generator's
entry), ``warm_requests``, ``check``. The sources are made on the device,
as a caller holding its sources there would pass them. Set-up refuses a
configuration outside the upstream's resolution window.

The check assembles the operator itself (reference/fdfd.py, scipy,
complex128), solves every kept source exactly with it on the device, and
reads ``fdfd_field_err``: the worst ||x - x_exact|| / ||x_exact|| over the
fields that the kept requests returned, as the program returned them. It
also prints each field's true relative residual (``fdfd_residual``, no
limit): that of a complex64 field is floored by the downcast near 1e-5, so
it cannot tell refinement in complex128 from refinement in complex64, while
the error against the exact field can.

The control is the step that would tempt a later change: the same
refinement with its residuals in complex64. It runs the program's own
complex64 operator and factor, ``r = b - A x`` and ``x += |r| A^-1 (r/|r|)``
all in complex64, under the program's stopping rule.
"""

from __future__ import annotations

import importlib
import math
import time

import numpy as np
import torch

from portbench import generator
from portbench.reference import fdfd as ref

EXACT = 1e-10   # the most residual an exact field may keep (2.2e-14 at 1024^2 on the card)


class Driver:
    def __init__(self, cell, seed: int, device, entry: str = "program"):
        cfg, tr = cell.config, cell.traffic
        self.entry = entry
        self.device = torch.device(device)
        self.N = tr["grid"]
        self.warm_requests = tr.get("warm_requests", 1)
        self.cfg = cfg
        scene = dict(cfg["scene"])
        self.eps, self.mu = cell.module("scenes", scene.pop("kind")).make(self.N, **scene)
        ref.check_resolution(self.eps, self.mu, cfg["omega"], cfg["dx"])
        self.sources = generator.Sources(self.N, tr["sources"], seed)
        self.limit = tr["check"]["limits"]["fdfd_field_err"]
        self.solver = None

    def setup(self) -> dict:
        self.direct = importlib.import_module("fdtd2d_tpu_torch.fdfd.direct")
        c = self.cfg
        self._sync()
        start = time.perf_counter()
        self.solver = self.direct.DirectSolver(
            self.eps, self.mu, c["dx"], c["dx"], c["omega"], pml_thickness=c["pml"]["cells"],
            sigma_max=c["pml"]["sigma_max"], m=c["pml"]["order"], device=self.device)
        self._sync()
        return {"factor_s": time.perf_counter() - start}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        for k in range(self.warm_requests):
            self.request(-1 - k)

    def _point_sources(self, positions):
        src = torch.zeros((len(positions), self.N, self.N), dtype=torch.float64,
                          device=self.device)
        idx = torch.as_tensor(positions, device=self.device)
        src[torch.arange(len(positions), device=self.device), idx[:, 0], idx[:, 1]] = 1.0
        return src

    def _refined_in_complex64(self, src):
        """The control: (fields, inner solves)."""
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
            d = self.direct.solve_factored(self.solver.factors, r / rn[:, None, None])
            x = x + rn[:, None, None] * d
        return x, rounds

    def request(self, i: int):
        positions = self.sources(i)
        src = self._point_sources(positions)
        if self.entry == "control":
            fields, rounds = self._refined_in_complex64(src)
        else:
            fields, _, trace = self.solver.solve_batched(
                src, refine_target=self.cfg["refine_target"])
            rounds = len(trace) - 1
        return fields, {"sources": len(positions), "rounds": rounds}

    def keep(self, i: int, answer) -> dict:
        return {"positions": self.sources(i), "fields": answer.detach().to("cpu", copy=True)}

    def close(self):
        self.solver = None

    def check(self, kept: list) -> dict:
        """{"fdfd_field_err": (worst error against the exact field, limit),
        "fdfd_residual": (worst true residual, None), "fdfd_exact_residual":
        (the exact fields' own worst residual, None)} over every field of
        the kept requests; the error reads inf where an exact field's own
        residual passes ``EXACT``."""
        c, N = self.cfg, self.N
        A = ref.operator(self.eps, self.mu, c["dx"], c["dx"], c["omega"], c["pml"]["cells"],
                         c["pml"]["sigma_max"], c["pml"]["order"])
        exact = ref.Sublattices(A, (N, N), self.device).factor()
        del A
        err = res = exact_res = 0.0
        for k in kept:
            got = k["fields"]
            if tuple(got.shape) != (len(k["positions"]), N, N):
                return {"fdfd_field_err": (math.inf, self.limit)}
            b = ref.point_sources((N, N), k["positions"], c["omega"]).reshape(-1, N, N)
            b = torch.as_tensor(b, device=self.device)
            want, want_res = exact.solve(b)
            got = got.to(self.device, torch.complex128)
            e = (torch.linalg.vector_norm(got - want, dim=(1, 2))
                 / torch.linalg.vector_norm(want, dim=(1, 2)))
            r = (torch.linalg.vector_norm(b - exact.apply(got), dim=(1, 2))
                 / torch.linalg.vector_norm(b, dim=(1, 2)))
            e, r = e.cpu().numpy(), r.cpu().numpy()
            err = max(err, float(np.max(e)) if np.all(np.isfinite(e)) else math.inf)
            res = max(res, float(np.max(r)) if np.all(np.isfinite(r)) else math.inf)
            exact_res = max(exact_res, float(want_res.max()))
        if not exact_res <= EXACT:   # the judge itself is not exact: no verdict
            err = math.inf
        return {"fdfd_field_err": (err, self.limit), "fdfd_residual": (res, None),
                "fdfd_exact_residual": (exact_res, None)}
