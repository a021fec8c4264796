"""How far the plain float32 FDTD step drifts from float64 over a short
window, from the states of a rollout of the bench's FDTD scene: the
yardstick behind the length of the bench's second parity window
(``fdtd2d_tpu_torch/bench.py``, ``FDTD_EDGE_STEPS``).

    python tools/fdtd_drift.py [--size 256] [--starts 1000,1200,1500,1800]
                               [--windows 20,50,200] [--device cpu]

For each start step, the state of one float32 rollout of that many steps
from zero is advanced ``window`` steps by the float32 and the float64 plain
step (``fdtd/step.py``, through ``simulate(backend="torch")``); one line a
start and window: the worst
relative error of Ez, Hx and Hy, and the least max |Ez| over the Mur bands
and corners relative to max |Ez| (as the bench's check computes them).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fdtd2d_tpu_torch import bench  # noqa: E402
from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate  # noqa: E402
from fdtd2d_tpu_torch.fdtd.step import MUR_BAND as b  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--starts", default="1000,1200,1500,1800")
    ap.add_argument("--windows", default="20,50,200")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    N, dev = args.size, args.device
    eps, mu = (torch.as_tensor(a, device=dev) for a in bench._fdtd_scene(N))
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=0, source_xy=(N // 2, N // 2),
                     source_fc=30e9, backend="torch", device=dev)
    for start in (int(s) for s in args.starts.split(",")):
        # one call from zero, as the bench reaches its state (a call starts
        # its source anew)
        state, _ = simulate(eps, mu, dataclasses.replace(cfg, nsteps=start))
        for window in (int(w) for w in args.windows.split(",")):
            short = dataclasses.replace(cfg, nsteps=window)
            got, _ = simulate(eps, mu, short, state=state)
            want, _ = simulate(eps.double(), mu.double(),
                               dataclasses.replace(short, dtype=torch.float64), state=state)
            err = max(float((g.double() - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            Ez = want[0].abs()
            parts = (Ez[b:-b, :b], Ez[b:-b, -b:], Ez[:b, b:-b], Ez[-b:, b:-b],
                     Ez[:b, :b], Ez[:b, -b:], Ez[-b:, :b], Ez[-b:, -b:])
            cover = float(min(p.max() for p in parts) / Ez.max())
            print(f"{N}^2 start {start} window {window}: float32 vs float64 {err:.3e}, "
                  f"least band/corner {cover:.3e} of max |Ez|", flush=True)


if __name__ == "__main__":
    main()
