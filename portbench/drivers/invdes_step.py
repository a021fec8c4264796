"""Request loop of adjoint inverse design: set-up builds the port's
``fdtd2d_tpu_torch.apps.inverse_design`` design loop on the configuration's
low-pass filter (``lowpass_problem`` over its band at dx = domain / N,
``design_state(solver=<configuration's solver>)``, plain gradient descent,
its learning rate and clip) from a design drawn uniformly in the clip's
range from the seed; a request is one ``design_step``: the F operators of
the current design factored by HPS, the F forward and the F adjoint fields
refined in complex128 to the configuration's target, the loss, the
gradient, the update and the clip. The design carries over from request to
request. Set-up looks the solver up in ``SOLVERS`` first, so a program
without it fails at once.

Traffic keys: ``grid`` (N of the N x N grid), ``warm_requests``,
``trace_requests``, ``check``. A request's work counts its 2 F solves as
``sources`` and names the grid, the leaf, the members and the inner HPS
solves and adjoint solves that the program's counters
(``fdfd.hps.solves``, ``fdfd.adjoint.solves``) gained, from which readers
count the least work of its factor and the rounds a solve.

The check holds every kept step to reference/invdes.py, from the step's
input design: ``fdfd_residual``, the worst true residual of its 2 F fields
with the reference's own operator (the adjoint fields against the adjoint
right-hand side of the program's own forward fields), against the
configuration's ``refine_target``; ``invdes_loss_err``, |L - L_ref| / L_ref;
``invdes_grad_err``, ||g - g_ref|| / ||g_ref|| over the design region; and
``invdes_update_err``, the distance of the step's update from
clip(design - lr g_ref) - design over that step's own norm; each against
the traffic's limit.

The control is the step with every refinement's residuals in complex64 (r,
x and the correction all complex64, the program's stopping rule), on the
program's own HPS factors of complex64 operators, as the ``fdfd-hps``
control: the step a later change to the refinement would take.
"""

from __future__ import annotations

import importlib
import math
from types import SimpleNamespace

import numpy as np
import torch

from portbench import generator
from portbench.reference.invdes import EXACT, MU_0, Reference
from portbench.reference.fdfd import EPSILON_0


class Driver:
    def __init__(self, cell, seed: int, device, entry: str = "program"):
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.entry = cfg, entry
        self.device = torch.device(device)
        self.N = tr["grid"]
        self.warm_requests = tr.get("warm_requests", 1)
        scene = dict(cfg["scene"])
        self.scene = cell.module("scenes", scene.pop("kind")).make(self.N, **scene)
        w = cfg["omegas"]
        self.omegas = np.linspace(w["start"], w["stop"], w["count"])
        self.ideal = np.asarray(cfg["ideal_response"], np.float64)
        self.dx = cfg["domain_m"] / self.N
        lam = 1.0 / math.sqrt(EPSILON_0 * MU_0) / self.omegas.max()
        if not self.dx <= lam / 10.0:
            raise ValueError(f"dx = {self.dx:g} is coarser than lambda/10 = {lam / 10:g} "
                             f"at the top omega: the grid {self.N} does not resolve the band")
        (r0, r1), (c0, c1) = self.scene["design"]
        lo, hi = cfg["optimizer"]["clip"]
        self.design0 = generator.rng(seed, 2).uniform(lo, hi, size=(r1 - r0, c1 - c0))
        self.limits = tr["check"]["limits"]
        self.state = None

    def setup(self) -> dict:
        self.inv = importlib.import_module("fdtd2d_tpu_torch.apps.inverse_design")
        self.trace = importlib.import_module("fdtd2d_tpu_torch.utils.trace")
        c, opt = self.cfg, self.cfg["optimizer"]
        self.inv.SOLVERS[c["solver"]]   # a program without the solver fails here
        w = c["omegas"]
        self.problem = self.inv.lowpass_problem(
            N=self.N, n_freqs=w["count"], band=(w["start"], w["stop"]), dx=self.dx,
            tol=c["refine_target"], device=self.device)
        if self.problem.pml_thickness != c["pml"]["cells"]:
            raise ValueError(f"the program's UPML is {self.problem.pml_thickness} cells, "
                             f"the configuration's {c['pml']['cells']}")
        self.state = self.inv.design_state(
            self.problem, solver=c["solver"], lr=opt["lr"], clip=tuple(opt["clip"]),
            optimizer=opt["kind"], design0=torch.as_tensor(self.design0, device=self.device))
        return {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        for k in range(self.warm_requests):
            self.request(-1 - k)

    def request(self, i: int):
        before = self.trace.counters()
        step = self._control_step() if self.entry == "control" else self.inv.design_step(self.state)
        F = len(self.omegas)
        work = {"sources": 2 * F, "members": F, "grid": self.N, "hps_leaf": self.cfg["hps_leaf"],
                "inner_solves": self.trace.delta(before, "fdfd.hps.solves"),
                "adjoint_solves": self.trace.delta(before, "fdfd.adjoint.solves")}
        return SimpleNamespace(step=step, design_out=self.state.design.detach()), work

    def _control_step(self):
        """design_step with complex64 residuals: a StepResult's fields."""
        hps = importlib.import_module("fdtd2d_tpu_torch.fdfd.hps")
        helm = importlib.import_module("fdtd2d_tpu_torch.ops.helmholtz")
        p, s = self.problem, self.state
        rs, cs = p.design_region
        pr, pc = p.probe_region
        design_in = s.design.detach().clone()
        eps = p.eps_base.clone()
        eps[rs, cs] = design_in * EPSILON_0
        op = helm.stack_operators([
            helm.make_operator(eps, p.mu, p.dx, p.dy, float(w), pml_thickness=p.pml_thickness,
                               dtype=torch.complex64, device=self.device) for w in p.omegas])
        factors = hps.hps_factor(op, m=self.cfg["hps_leaf"])
        b = (1j * op.omega)[:, None, None] * p.source.to(torch.complex64)
        x = self._refined_in_complex64(op, factors, b).to(torch.complex128).requires_grad_(True)
        with torch.enable_grad():
            r = x.abs()[:, pr, pc].mean(dim=(-2, -1))
            r = r / r.amax()
            loss = ((r - p.ideal_response.to(torch.float64)) ** 2).mean()
            (g,) = torch.autograd.grad(loss, x)
        y = self._refined_in_complex64(op, factors, torch.conj_physical(g).to(torch.complex64))
        del factors
        w2 = torch.as_tensor(p.omegas, dtype=torch.float64, device=self.device)[:, None, None] ** 2
        x = x.detach()
        y = y.to(torch.complex128)
        grad = EPSILON_0 * (w2 * (x * y).real).sum(0)[rs, cs]
        with torch.no_grad():
            s.design -= self.cfg["optimizer"]["lr"] * grad.to(s.design.dtype)
            s.design.clamp_(*s.clip)
        return SimpleNamespace(design=design_in, loss=loss.detach(), grad=grad, fields=x,
                               adjoint_fields=y)

    def _refined_in_complex64(self, op, factors, b):
        """The control's refinement: (F, N, N) complex64 fields."""
        hps = importlib.import_module("fdtd2d_tpu_torch.fdfd.hps")
        target = self.cfg["refine_target"]
        x = torch.zeros_like(b)
        bn = torch.linalg.vector_norm(b, dim=(1, 2))
        bn = torch.where(bn == 0, torch.ones_like(bn), bn)
        prev = math.inf
        for _ in range(40):
            r = op.residual(b, x)
            rn = torch.linalg.vector_norm(r, dim=(1, 2))
            worst = float((rn / bn).max())
            if worst <= target or worst >= 0.9 * prev:
                break
            prev = worst
            safe = torch.where(rn == 0, torch.ones_like(rn), rn)
            x = x + rn[:, None, None] * hps.hps_solve(factors, r / safe[:, None, None])
        return x

    def keep(self, i: int, answer) -> dict:
        s = answer.step

        def host(t):
            return t.detach().to("cpu", copy=True)

        return {"design": host(s.design), "loss": float(s.loss), "grad": host(s.grad),
                "fields": host(s.fields), "adjoint_fields": host(s.adjoint_fields),
                "design_out": host(answer.design_out)}

    def close(self):
        self.state = self.problem = None

    def check(self, kept: list) -> dict:
        """{"fdfd_residual": (worst true residual of every kept field,
        refine_target), "invdes_loss_err", "invdes_grad_err",
        "invdes_update_err": (worst over the kept steps, limit),
        "invdes_field_err": (worst forward field's error, None),
        "fdfd_exact_residual": (the reference's own worst residual, None)};
        the compared errors read inf where the reference's own residual
        passes ``EXACT`` or a kept step has the wrong shapes."""
        c, N, F = self.cfg, self.N, len(self.omegas)
        target, lim = c["refine_target"], self.limits
        names = ("invdes_loss_err", "invdes_grad_err", "invdes_update_err")
        out = {"fdfd_residual": 0.0, "invdes_field_err": 0.0, "fdfd_exact_residual": 0.0,
               **{n: 0.0 for n in names}}
        ref = Reference(self.scene, self.omegas, self.ideal, self.dx, c["pml"], self.device)
        lr, (lo, hi) = c["optimizer"]["lr"], c["optimizer"]["clip"]
        for k in kept:
            shape = tuple(np.shape(self.design0))
            if (tuple(k["fields"].shape) != (F, N, N) or k["adjoint_fields"] is None
                    or tuple(k["adjoint_fields"].shape) != (F, N, N)
                    or tuple(k["grad"].shape) != shape or tuple(k["design_out"].shape) != shape):
                return {"fdfd_residual": (math.inf, target),
                        **{n: (math.inf, lim[n]) for n in names}}
            design = k["design"].numpy().astype(np.float64)
            r = ref.step(design, k["fields"], k["adjoint_fields"])
            g, g_ref = k["grad"].numpy().astype(np.float64), r["grad"]
            want = np.clip(design - lr * g_ref, lo, hi) - design
            got = k["design_out"].numpy().astype(np.float64) - design
            errs = {"invdes_loss_err": abs(k["loss"] - r["loss"]) / abs(r["loss"]),
                    "invdes_grad_err": np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref),
                    "invdes_update_err": np.linalg.norm(got - want) / np.linalg.norm(want)}
            for n, v in errs.items():
                out[n] = max(out[n], float(v) if np.isfinite(v) else math.inf)
            out["fdfd_residual"] = max(out["fdfd_residual"], r["residual"])
            out["invdes_field_err"] = max(out["invdes_field_err"], r["field_err"])
            out["fdfd_exact_residual"] = max(out["fdfd_exact_residual"], r["exact_residual"])
        if not out["fdfd_exact_residual"] <= EXACT:   # the judge itself is not exact: no verdict
            for n in names:
                out[n] = math.inf
        return {"fdfd_residual": (out["fdfd_residual"], target),
                **{n: (out[n], lim[n]) for n in names},
                "invdes_field_err": (out["invdes_field_err"], None),
                "fdfd_exact_residual": (out["fdfd_exact_residual"], None)}
