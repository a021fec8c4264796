"""Request loop of FDTD rollouts: a request is one call of the port's
``fdtd2d_tpu_torch.fdtd.simulate.simulate`` on the configuration's scene,
already on the device, with a point source at the request's position.

Each call starts from the last one's fields, as one long simulation cut
into calls. Traffic keys: ``grid`` (N of an N x N grid), ``steps`` a call,
``sources`` (the generator's entry), ``check`` (see the harness).

Set-up warms the call's shapes with ``warm_requests`` calls, and runs at
least as many calls as the first pulse needs to reach the grid's farthest
corner from any source, so that every timed call works on a field that
fills the grid and its Mur bands and corners.

The check runs the float64 reference (reference/fdtd.py) from the input of
each kept request, on the device, once the program's state is freed, and
reads the returned Ez, Hx, Hy by ``local_error``: the worst error of a
32 x 32 tile against the field in that tile.
The control puts that reference, in bfloat16, in the program's place.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import torch

from portbench import generator
from portbench.reference import fdtd as ref

C0 = 299792458.0


def _host(t):
    return t.detach().to("cpu", copy=True)


class Driver:
    def __init__(self, cell, seed: int, device, entry: str = "program"):
        cfg, tr = cell.config, cell.traffic
        self.entry = entry
        self.device = torch.device(device)
        self.N = tr["grid"]
        self.steps = tr["steps"]
        self.warm_requests = tr.get("warm_requests", 1)
        self.dt, self.dx, self.fc = cfg["dt"], cfg["dx"], cfg["excitation"]["fc"]
        self.dtype = getattr(torch, cfg["dtype"])
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        self.backend = cfg["backend"]
        scene = dict(cfg["scene"])
        eps, mu = cell.module("scenes", scene.pop("kind")).make(self.N, **scene)
        self.eps = torch.as_tensor(eps, device=self.device)
        self.mu = torch.as_tensor(mu, device=self.device)
        self.sources = generator.Sources(self.N, tr["sources"], seed)
        self.limit = tr["check"]["limits"]["fdtd_field_err"]
        self.state = self.prev = None

    def setup(self) -> dict:
        self.sim = importlib.import_module("fdtd2d_tpu_torch.fdtd.simulate")
        self.cfg = self.sim.FDTDConfig(
            dt=self.dt, dx=self.dx, nsteps=self.steps, source_xy=(0, 0), source_fc=self.fc,
            backend=self.backend, dtype=self.dtype, device=str(self.device))
        return {}

    def fill_requests(self) -> int:
        """Calls until the first pulse (its peak at t = 1/fc) has crossed from
        the farthest source of the table to the farthest corner."""
        courant = C0 * self.dt / self.dx
        far = max(math.hypot(max(r, self.N - 1 - r), max(c, self.N - 1 - c))
                  for r, c in self.sources.table)
        return math.ceil((1.0 / (self.fc * self.dt) + far / courant) / self.steps)

    def warm(self):
        for k in range(max(self.warm_requests, self.fill_requests())):
            self.request(-1 - k)

    def _call(self, source, state):
        if self.entry == "control":
            if state is None:
                N = self.N
                state = (torch.zeros((N, N), device=self.device),
                         torch.zeros((N, N - 1), device=self.device),
                         torch.zeros((N - 1, N), device=self.device))
            fields = ref.rollout(self.eps, self.mu, self.dt, self.dx, [f[None] for f in state],
                                 self.steps, [source], self.fc, dtype=torch.bfloat16)
            return tuple(f[0] for f in fields)
        cfg = dataclasses.replace(self.cfg, source_xy=source)
        fields, _ = self.sim.simulate(self.eps, self.mu, cfg, state=state)
        return fields

    def request(self, i: int):
        (source,) = self.sources(i)
        self.prev, self.state = self.state, tuple(self._call(source, self.state))
        work = {"rows": self.N, "cols": self.N, "steps": self.steps,
                "cell_steps": self.N * self.N * self.steps, "itemsize": self.itemsize}
        return self.state, work

    def keep(self, i: int, answer) -> dict:
        return {"source": self.sources(i)[0],
                "input": None if self.prev is None else tuple(_host(f) for f in self.prev),
                "output": tuple(_host(f) for f in answer)}

    def close(self):
        self.state = self.prev = None
        self.sim = None

    def check(self, kept: list) -> dict:
        """{"fdtd_field_err": (worst relative error, limit)} over the kept
        requests, and the least share of the field in a Mur band or corner
        of the reference (``fdtd_band_cover``, for the record; no limit)."""
        dev, N = self.device, self.N
        zero = (torch.zeros((N, N)), torch.zeros((N, N - 1)), torch.zeros((N - 1, N)))
        inputs = [k["input"] or zero for k in kept]
        start = [torch.stack([inp[f] for inp in inputs]).to(dev) for f in range(3)]
        want = ref.rollout(self.eps, self.mu, self.dt, self.dx, start, self.steps,
                           [k["source"] for k in kept], self.fc)
        worst = 0.0
        for b, k in enumerate(kept):
            for got, w in zip(k["output"], (w[b] for w in want)):
                if tuple(got.shape) != tuple(w.shape):
                    return {"fdtd_field_err": (math.inf, self.limit)}
                worst = max(worst, ref.local_error(got.to(dev), w))
        return {"fdtd_field_err": (worst, self.limit),
                "fdtd_band_cover": (ref.band_cover(want[0]), None)}
