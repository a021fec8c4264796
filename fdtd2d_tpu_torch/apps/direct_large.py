"""The exact solve past the memory wall (counterpart of
``examples/direct_large.py``): the sublattice block-Thomas factorization at
2048^2 (or a given N) on the hard 50%-duty binary 5x-contrast scene (seed 7,
the source at N/3).

Storing every inverse W takes 4 (N/2)^3 8 B (34 GB at 2048^2). The modes
past that wall:

- checkpointed (default): W every ``stride`` rows (0.57 GB at 2048^2,
  stride 64); each solve re-runs the inversion recursion twice, trading
  compute for the store.
- compressed: every W in fixed-rank HODLR form (fdfd/compressed.py, rank 20,
  leaf 128: ~8.3 GB at 2048^2); a solve is two scans of batched matmuls.
- hps: nested-dissection factors (fdfd/hps.py) and log-depth solves; its
  complex64 interfaces cap it at 1024^2 on hard scenes (DirectSolver warns
  past that).

Each mode builds its factors, solves the source twice (first and warm) to a
true float64 residual of 1e-8 by complex128 refinement, then sweeps 8
sources (the first the scene's, seven more points drawn from
``np.random.default_rng(11)``) through ``solve_batched`` twice, timing the
warm sweep. Writes ``OUT/direct_large_<mode>_<N>.npz`` (the warm solve's real
field on at most 512^2 points, over its max, float16) and its PNG.

Run: python -m fdtd2d_tpu_torch.apps.direct_large [N] [stride]
        [checkpointed|compressed|hps] [--device cuda|cpu] [--out DIR] [--draw DIR]
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.apps._common import cli, half, timed
from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

MODES = ("checkpointed", "compressed", "hps")
SWEEP = 8
SWEEP_SEED = 11
FIGURE_SIDE = 512


def hard_scene(N: int, seed: int = 7):
    return hard_binary_scene(N, seed=seed, source_xy=(N // 3, N // 3))


def sweep_sources(src, N: int, B: int = SWEEP) -> np.ndarray:
    """The script's (B, N, N) complex64 sweep: the scene's source, then B - 1
    points of 10 drawn from ``default_rng(11)`` in the middle half."""
    rng = np.random.default_rng(SWEEP_SEED)
    srcs = np.zeros((B, N, N), np.complex64)
    srcs[0] = src
    for i in range(1, B):
        r, c = rng.integers(N // 4, 3 * N // 4, 2)
        srcs[i, r, c] = 10.0
    return srcs


def store_bytes(solver: DirectSolver, mode: str) -> int:
    if mode == "compressed":
        return int(solver.compressed_bytes)
    if mode == "hps":
        return int(solver.hps_bytes)
    f = solver.factors
    Wc = [f.stacked.Wc] if hasattr(f, "stacked") else [s.Wc for s in f.subs]
    return sum(w.numel() * w.element_size() for w in Wc)


def run(N: int = 2048, stride: int = 64, mode: str = "checkpointed", *, device="cuda",
        out=None) -> dict:
    """The script's build, solves and sweep in ``mode``; returns its numbers
    (the warm field and the sweep's sources under ``arrays``)."""
    omega, dx = 17e9, 1e-3
    eps, mu, src = hard_scene(N)
    store_all = 4 * (N // 2) ** 3 * 8 / 1e9
    if mode == "checkpointed":
        print(f"N={N} stride={stride}: checkpoint memory "
              f"~{4 * (N // 2 // stride + 1) * (N // 2) ** 2 * 8 / 1e9:.2f} "
              f"GB (store-all would be {store_all:.1f} GB)")
        kwargs = dict(checkpointed=True, stride=stride)
    elif mode == "compressed":
        print(f"N={N}: HODLR-compressed W store (store-all would be {store_all:.1f} GB)")
        kwargs = dict(compressed=True)
    elif mode == "hps":
        print(f"N={N}: HPS nested-dissection factors (store-all would be {store_all:.1f} GB)")
        kwargs = dict(hps=True)
    else:
        raise SystemExit(f"unknown mode {mode!r}")

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    solver, t_build = timed(lambda: DirectSolver(eps, mu, dx, dx, omega, device=device,
                                                 **kwargs), device)
    store = store_bytes(solver, mode)
    if mode == "compressed":
        print(f"compressed store: {store / 1e9:.2f} GB ({store_all / (store / 1e9):.1f}x smaller)")
    elif mode == "hps":
        print(f"HPS factor store: {store / 1e9:.2f} GB ({store_all / (store / 1e9):.1f}x smaller)")

    (_, trace_first), t_first = timed(
        lambda: solver.solve(src, refine_target=1e-8, verbose=True), device)
    (x, trace), t_warm = timed(lambda: solver.solve(src, refine_target=1e-8, verbose=True),
                               device)
    print(f"build(+factor dispatch) {t_build:.1f} s; first solve {t_first:.1f} s; warm solve "
          f"{t_warm:.1f} s; final TRUE residual {trace[-1]:.3e}")

    # amortized sweep cost: one factorization, B sources, joint refinement
    srcs = sweep_sources(src, N)
    _, _, btrace_first = solver.solve_batched(srcs, refine_target=1e-8)
    (_, per_sample, btrace), t_batch = timed(
        lambda: solver.solve_batched(srcs, refine_target=1e-8), device)
    worst = float(np.max(np.asarray(per_sample)))
    print(f"warm batched sweep: {SWEEP} sources in {t_batch:.1f} s ({t_batch / SWEEP:.2f} "
          f"s/source, {t_warm / (t_batch / SWEEP):.1f}x over per-source warm solves); worst "
          f"TRUE residual {worst:.3e}")
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    xr = x.real.cpu().numpy()
    if out is not None:
        # the stencil couples a cell to its second neighbours only: the field
        # lives on the source's sublattice, so a figure keeps its points
        step = max(1, N // FIGURE_SIDE)
        off = N // 3 % 2 if step % 2 == 0 else 0
        pick = np.s_[off::step, off::step]
        field, m = half(xr[pick])
        np.savez_compressed(os.path.join(out, f"direct_large_{mode}_{N}.npz"), Ez=field,
                            max_abs=m, eps_r=(eps[pick] / constants.EPSILON_0).astype(np.float16))
    numbers = {
        "N": N, "mode": mode, "stride": stride if mode == "checkpointed" else None,
        "store_all_gb": store_all, "build_s": t_build, "store_bytes": store,
        "first_s": t_first, "warm_s": t_warm,
        "rounds_first": len(trace_first) - 2, "rounds": len(trace) - 2,
        "trace": [float(t) for t in trace], "iterate_residual": float(trace[-2]),
        "returned_residual": float(trace[-1]),
        "sweep_sources": SWEEP, "sweep_s": t_batch, "s_per_source": t_batch / SWEEP,
        "sweep_speedup": t_warm / (t_batch / SWEEP), "sweep_worst_residual": worst,
        "sweep_rounds": len(btrace) - 1, "sweep_rounds_first": len(btrace_first) - 1,
        "sweep_trace": [float(t) for t in btrace], "factor_growth": solver.factor_growth,
        "peak_gb": peak,
        "arrays": {"x": x.cpu().numpy(), "sources": srcs, "per_sample": np.asarray(per_sample)}}
    return numbers


def draw(out_dir: str) -> list:
    from fdtd2d_tpu_torch.viz import plot_Ez

    paths = []
    for f in sorted(glob.glob(os.path.join(out_dir, "direct_large_*.npz"))):
        d = np.load(f)
        paths.append(f[:-4] + "_Ez.png")
        plot_Ez(d["Ez"].astype(np.float64), d["eps_r"].astype(np.float64) * constants.EPSILON_0,
                paths[-1], vmax=1.0, vmin=-1.0)
    return paths


def _positionals(p):
    p.add_argument("N", nargs="?", type=int, default=2048)
    p.add_argument("stride", nargs="?", type=int, default=64)
    p.add_argument("mode", nargs="?", default="checkpointed", choices=MODES)


def main(argv=None) -> int:
    return cli("direct_large", __doc__, run, draw, argv, positionals=_positionals,
               kwargs=lambda a: dict(N=a.N, stride=a.stride, mode=a.mode),
               stem=lambda n: f"direct_large_{n['mode']}_{n['N']}")


if __name__ == "__main__":
    sys.exit(main())
