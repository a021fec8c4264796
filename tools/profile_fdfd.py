"""Device-time profile of the FDFD solves on the GPU, with torch.profiler.

    python tools/profile_fdfd.py [--size 512] [--paths factor,direct,fgmres] [--out DIR]
    python tools/profile_fdfd.py --paths invdes [--size 250] [--freqs 10] [--decade]
    python tools/profile_fdfd.py --paths tiled,tiledapprox [--size 1024]
    python tools/profile_fdfd.py --paths timedomain [--size 4096]
    python tools/profile_fdfd.py --paths compressed,hps [--size N]

On the scene of ``bench.py``'s fdfd512 rows (512^2 by default: a 2.5x
dielectric block, a point source at the centre carrying -1j*omega, dx 1e-3 m,
omega 17e9, PML 40), for each path of ``--paths``:

- ``factor``: one ``DirectSolver`` construction (complex64 stacked
  block-Thomas factors) to warm up, then a second one under torch.profiler;
- ``direct``: a ``DirectSolver``, one warm-up solve, then one warm solve
  with ``rhs_scale=1.0, refine_target=1e-6`` under torch.profiler;
- ``fgmres``: FDM-preconditioned FGMRES in complex64 (restart 20, tol 1e-6,
  maxiter 3000, the fdfd512iter row), one warm-up solve, then one under
  torch.profiler;
- ``invdes`` (not in the default list): inverse design on
  ``lowpass_problem(N=--size, n_freqs=--freqs)`` (``--size`` 250 unless
  given; ``--decade``: ``decade_lowpass_problem``, N >= 848), complex64:
  a cold optimization step, a warm one, then a warm one under
  torch.profiler, each as ``optimize`` takes it (``invdes_steps``). Its line
  adds the steps' seconds, losses, forward and adjoint FGMRES iterations and
  residuals per member, peak device memory, and ``launches_per_iteration``: the profiled
  step's launches over its batched FGMRES iterations (the most any member
  took, forward plus adjoint), which says whether the batched solve is
  host bound.

- ``tiled``, ``tiledapprox`` and ``timedomain`` (not in the default list):
  the rows of ``bench.py:307-380`` on its block scene (``block_scene``: a
  1.5x block at ``[N/3:2N/3, N/4:N/2]``, a unit point source at the centre,
  17 GHz, dx 1 mm; ``--size`` 1024 unless given, 4096 for ``timedomain``).
  ``tiled``: ``TiledSolver`` with its defaults (patches of 100 with padding
  30), refined to a true 1e-6; ``tiledapprox``: outer restart 10, tol 1e-2,
  maxiter 60, no refinement (``tiled_cell``). Each: a cold solve, a timed
  warm solve, and a warm solve under torch.profiler; its line adds the
  probe's contractions and decision, the outer FGMRES iterations a round,
  the returned field's true residual recomputed in complex128, peak device
  memory and ``launches_per_outer_iteration``. ``timedomain``:
  ``TimeDomainSolver`` at 2.5 transits, refined to a true 1e-6
  (``timedomain_cell``): ms a wave step by CUDA events over 200 steps
  beside its bound (``WAVE_STEP_BYTES`` a cell at 3.35 TB/s), a window of 20
  steps under torch.profiler (launches a step, busy share), then a cold and
  a warm solve (a whole solve is hundreds of thousands of launches: its
  trace is not taken).

- ``compressed`` and ``hps`` (not in the default list): ``DirectSolver`` in its
  HODLR-compressed mode (bench.py's ``direct2048``: rank 20, leaf 128,
  ``power_iters=1``; ``--size`` 2048 unless given) or its HPS mode
  (``hps_leaf=8``; 1024 unless given) on ``hard_binary_scene(N, seed=3,
  source_amp=10.0)``, 17 GHz, dx 1 mm, PML 40 (``direct_mode_cell``): the
  factor (seconds, store bytes, peak memory), a cold and a timed warm solve
  to a true 1e-6, and a warm solve under torch.profiler; its line adds the
  rounds and ``launches_per_inner_solve``. A 2048^2 compressed solve is
  ~10^5 launches: give ``--out`` a directory outside ``chiprun_out/``.

It writes each window's Chrome trace to ``--out`` (by default ``profile/`` in
the repo's git-ignored output directory) and prints one JSON line per path,
then the card's name and power limit as nvidia-smi gives them. Besides the
fields of tools/profile_fdtd.py's summary (wall, device busy and busy
share, idle gaps, per-kernel calls and microseconds), a line holds
``launches`` (device kernels in the window), ``launches_per_ms`` of wall
time, and the solve's own result (residual trace or iterations).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from profile_fdtd import summarize  # noqa: E402

PATHS = ("factor", "direct", "fgmres", "invdes", "tiled", "tiledapprox", "timedomain",
         "compressed", "hps")
DEFAULT_PATHS = ["factor", "direct", "fgmres"]
TOP = 12
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def path_list(text: str):
    """``--paths``: a comma-separated list of names in PATHS."""
    names = [name for name in text.split(",") if name]
    bad = [name for name in names if name not in PATHS]
    if bad or not names:
        raise argparse.ArgumentTypeError(f"paths must be among {PATHS}, got {text!r}")
    return names


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=None,
                        help="grid side (default 512; 250 for invdes)")
    parser.add_argument("--paths", type=path_list, default=list(DEFAULT_PATHS))
    parser.add_argument("--freqs", type=int, default=10, help="invdes: frequencies")
    parser.add_argument("--decade", action="store_true",
                        help="invdes: the 10-100 GHz decade sweep (N >= 848)")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "profile")
    return parser.parse_args(argv)


def window_summary(trace: Path, wall_s: float) -> dict:
    """The profile_fdtd summary of one solve (a "step" is the whole solve),
    with the launch count and the top kernels only."""
    s = summarize(trace, steps=1, wall_s=wall_s)
    launches = sum(k["calls"] for k in s["kernels"].values())
    top = dict(list(s["kernels"].items())[:TOP])
    for k in top.values():
        del k["us_per_step"]
    return {**s, "launches": launches, "launches_per_ms": launches / s["wall_ms"],
            "kernel_names": len(s["kernels"]), "kernels": top}


def invdes_steps(problem, steps: int, *, dtype=torch.complex64, lr: float = 0.05,
                 opt_tol: float = 1e-4, trace: Path | None = None) -> list:
    """``steps`` optimization steps of ``problem`` as ``optimize`` takes them
    (Adam with optax's defaults from the box midpoint 2.0, the loop at
    ``opt_tol``, each step's fields warm-starting the next); with ``trace``,
    the last step runs under torch.profiler and its Chrome trace goes there.
    One dict a step: host seconds (device synchronized), loss, forward and
    adjoint FGMRES iterations and relative residuals per member, peak device
    memory; the profiled step adds its window summary and
    ``launches_per_iteration``."""
    from fdtd2d_tpu_torch.apps.inverse_design import make_response_fn
    from fdtd2d_tpu_torch.utils.metrics import Timer

    dev = problem.device
    _, loss = make_response_fn(dataclasses.replace(problem, tol=max(problem.tol, opt_tol)),
                               dtype)
    rs, cs = problem.design_region
    design = torch.full((rs.stop - rs.start, cs.stop - cs.start), 2.0, device=dev,
                        requires_grad=True)
    opt = torch.optim.Adam([design], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    x0s, out = None, []
    for step in range(steps):
        profiled = trace is not None and step == steps - 1
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        prof = (torch.profiler.profile(activities=ACTIVITIES) if profiled
                else contextlib.nullcontext())
        with prof, Timer(dev) as timer:
            value, design.grad, x0s = loss.value_and_grad(design, x0s)
            opt.step()
            with torch.no_grad():
                design.clamp_(1.0, 3.0)
            value = float(value)
        rec = {"step": step, "seconds": timer.seconds, "loss": value,
               **{k: list(v) for k, v in loss.info.items()},
               "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None)}
        if profiled:
            prof.export_chrome_trace(str(trace))
            summary = window_summary(trace, timer.seconds)
            iterations = max(rec["forward_iterations"]) + max(rec["adjoint_iterations"])
            rec["profile"] = {**summary,
                              "launches_per_iteration": summary["launches"] / iterations}
        out.append(rec)
    return out


# the least HBM traffic of a wave step, a cell: u, u_prev and b read and u_new
# written in complex64, 1/(eps dt^2) read in float32 (the strips and the
# per-axis coefficients are O(N) and not counted)
WAVE_STEP_BYTES = 4 * 8 + 4
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet (700 W)


def block_scene(N: int, contrast: float = 1.5):
    """bench.py's ``_block_scene``: eps, mu and a unit point source at the
    centre, float64 numpy."""
    from fdtd2d_tpu_torch import constants

    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= contrast
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    src[N // 2, N // 2] = 1.0
    return eps, mu, src


def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9


def tiled_cell(N: int, *, approx: bool, dev, trace: Path) -> dict:
    """bench.py's ``tiled1024`` (``approx=False``: ``TiledSolver`` defaults,
    solver tol 1e-4, maxiter 300, refined to 1e-6) or ``tiled1024approx``
    (outer restart 10, tol 1e-2, maxiter 60, no refinement) at N: a cold
    solve, a timed warm solve, a profiled warm solve."""
    from fdtd2d_tpu_torch.fdfd.refine import true_relative_residual
    from fdtd2d_tpu_torch.fdfd.tiled import TiledSolver
    from fdtd2d_tpu_torch.utils.metrics import Timer

    omega, dx = 17e9, 1e-3
    eps, mu, src = block_scene(N)
    torch.cuda.reset_peak_memory_stats(dev)
    with Timer(dev) as build:
        solver = TiledSolver(eps, mu, dx, dx, omega, device=dev,
                             **({"outer_restart": 10} if approx else {}))
    kw = (dict(solver_tol=1e-2, solver_maxiter=60, refine_target=None) if approx
          else dict(solver_tol=1e-4, solver_maxiter=300, refine_target=1e-6))
    with Timer(dev) as cold:
        solver.solve(src, **kw)
    with Timer(dev) as warm:
        x, res = solver.solve(src, **kw)
    iterations = list(solver.outer_iterations)
    b64 = torch.as_tensor(src, device=dev).to(torch.complex128) * (-1j * omega)
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        with Timer(dev) as profiled:
            solver.solve(src, **kw)
    prof.export_chrome_trace(str(trace))
    summary = window_summary(trace, profiled.seconds)
    cc, ct = solver._patch_probe
    return {"size": N, "patches": len(solver.origins), "window": solver.W,
            "outer_restart": solver.outer_restart, **kw,
            "probe": {"coarse": cc, "two_level": ct,
                      "decision": "two-level" if solver._patch_decision else "coarse-only"},
            "build_s": build.seconds, "cold_solve_s": cold.seconds, "warm_solve_s": warm.seconds,
            "trace": res, "rounds": max(len(res) - 2, 0), "outer_iterations": iterations,
            "c128_residual": true_relative_residual(solver.op64, b64, x),
            "peak_gb": _peak_gb(dev),
            "launches_per_outer_iteration": summary["launches"] / sum(iterations),
            "busy_share_unprofiled": summary["device_busy_ms"] / (warm.seconds * 1e3),
            "profiled": summary}


# DirectSolver's keywords of the compressed and HPS cells, and their default sizes
DIRECT_MODES = {"compressed": (dict(compressed=True, rank=20, leaf=128, power_iters=1), 2048),
                "hps": (dict(hps=True, hps_leaf=8), 1024)}


def direct_mode_cell(mode: str, N: int, *, dev, trace: Path) -> dict:
    """A ``DirectSolver`` of ``DIRECT_MODES[mode]`` on the hard binary scene
    at N (17 GHz, dx 1 mm, PML 40): the factor, a cold and a timed warm
    solve to a true 1e-6, and a profiled warm solve."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver
    from fdtd2d_tpu_torch.utils.metrics import Timer

    kw = DIRECT_MODES[mode][0]
    eps, mu, src = hard_binary_scene(N, seed=3, source_amp=10.0)
    torch.cuda.reset_peak_memory_stats(dev)
    with Timer(dev) as build:
        solver = DirectSolver(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=40, device=dev, **kw)
    out = {"size": N, **kw, "factor_s": build.seconds, "factor_peak_gb": _peak_gb(dev),
           "store_bytes": getattr(solver, "compressed_bytes", getattr(solver, "hps_bytes", None)),
           "factor_growth": solver.factor_growth}
    for name in ("cold", "warm"):
        with Timer(dev) as timer:
            _, res = solver.solve(src, refine_target=1e-6)
        out[f"{name}_solve_s"], out[f"{name}_trace"] = timer.seconds, res
    out["rounds"] = len(res) - 2
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        with Timer(dev) as profiled:
            solver.solve(src, refine_target=1e-6)
    prof.export_chrome_trace(str(trace))
    summary = window_summary(trace, profiled.seconds)
    out.update(peak_gb=_peak_gb(dev), launches_per_inner_solve=summary["launches"] / out["rounds"],
               busy_share_unprofiled=summary["device_busy_ms"] / (out["warm_solve_s"] * 1e3),
               profiled=summary)
    return out


def _wave_state(bundle, seed: int = 0):
    """A seeded random complex64 state, right-hand side and zero filter
    state on the bundle's device."""
    from fdtd2d_tpu_torch.fdfd.timedomain import _psi0

    g = torch.Generator(device=bundle.theta.device).manual_seed(seed)
    shape = tuple(bundle.inv_eps_dt2.shape)

    def rand():
        return torch.randn(shape, dtype=torch.complex64, device=bundle.theta.device,
                           generator=g)

    u, uprev, b = rand(), rand(), rand()
    return b, u, uprev, _psi0(b, bundle.t)


def wave_step_ms(bundle, steps: int = 200, warmup: int = 20) -> float:
    """ms a wave step (``timedomain._step``) on the bundle's card, CUDA events
    over ``steps`` steps after ``warmup``, from a seeded random state."""
    from fdtd2d_tpu_torch.fdfd.timedomain import _step

    b, u, uprev, psi = _wave_state(bundle)
    su = torch.empty_like(b)
    for k in range(warmup):
        u, uprev, psi = _step(bundle, b, u, uprev, psi, k, su)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(warmup, warmup + steps):
        u, uprev, psi = _step(bundle, b, u, uprev, psi, k, su)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def wave_step_profile(bundle, trace: Path, steps: int = 20) -> dict:
    """``steps`` wave steps under torch.profiler: the window summary with
    ``launches_per_step``."""
    from fdtd2d_tpu_torch.fdfd.timedomain import _step
    from fdtd2d_tpu_torch.utils.metrics import Timer

    b, u, uprev, psi = _wave_state(bundle, seed=1)
    su = torch.empty_like(b)
    u, uprev, psi = _step(bundle, b, u, uprev, psi, 0, su)
    dev = b.device
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        with Timer(dev) as timer:
            for k in range(1, steps + 1):
                u, uprev, psi = _step(bundle, b, u, uprev, psi, k, su)
    prof.export_chrome_trace(str(trace))
    summary = window_summary(trace, timer.seconds)
    return {**summary, "launches_per_step": summary["launches"] / steps}


def timedomain_cell(N: int, *, dev, trace: Path, transits: float = 2.5) -> dict:
    """bench.py's ``timedomain4096`` at N: ms a wave step and its profile,
    then a cold and a warm ``TimeDomainSolver.solve`` refined to 1e-6."""
    from fdtd2d_tpu_torch.fdfd.timedomain import TimeDomainSolver
    from fdtd2d_tpu_torch.utils.metrics import Timer

    omega, dx = 17e9, 1e-3
    eps, mu, src = block_scene(N)
    torch.cuda.reset_peak_memory_stats(dev)
    with Timer(dev) as build:
        solver = TimeDomainSolver(eps, mu, dx, dx, omega, transits=transits, device=dev)
    out = {"size": N, "transits": transits, "build_s": build.seconds,
           "n_main": solver.bundle.n_main, "n_avg": solver.bundle.n_avg,
           "steps_per_apply": solver.steps_per_apply,
           "ms_per_step": wave_step_ms(solver.bundle),
           "bound_ms": WAVE_STEP_BYTES * N * N / HBM_BYTES_S * 1e3}
    out["step_profile"] = wave_step_profile(solver.bundle, trace)
    for name in ("cold", "warm"):
        with Timer(dev) as timer:
            _, res = solver.solve(src, refine_target=1e-6)
        out[f"{name}_solve_s"], out[f"{name}_trace"] = timer.seconds, res
    out["rounds"] = len(res) - 2
    out["peak_gb"] = _peak_gb(dev)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fdfd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver
    from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator
    from fdtd2d_tpu_torch.utils.metrics import Timer, device_info

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)  # the memory-stat calls need an initialized device
    args.out.mkdir(parents=True, exist_ok=True)
    if "invdes" in args.paths:
        from fdtd2d_tpu_torch.apps.inverse_design import decade_lowpass_problem, lowpass_problem

        if args.decade:
            problem = decade_lowpass_problem(N=max(args.size or 848, 848), n_freqs=args.freqs,
                                             device=dev)
        else:
            problem = lowpass_problem(N=args.size or 250, n_freqs=args.freqs, device=dev)
        n_i = problem.eps_base.shape[0]
        trace = args.out / f"trace_invdes_{n_i}_{args.freqs}.json"
        steps = invdes_steps(problem, 3, trace=trace)
        print(json.dumps({"path": "invdes", "size": n_i, "freqs": args.freqs,
                          "decade": args.decade, "steps": steps,
                          "trace_file": str(trace.relative_to(ROOT))
                          if trace.is_relative_to(ROOT) else str(trace)}))
    for path in ("compressed", "hps"):
        if path not in args.paths:
            continue
        n_p = args.size or DIRECT_MODES[path][1]
        trace = args.out / f"trace_fdfd_{path}_{n_p}.json"
        cell = direct_mode_cell(path, n_p, dev=dev, trace=trace)
        print(json.dumps({"path": path, **cell, "trace_file": str(trace.relative_to(ROOT))
                          if trace.is_relative_to(ROOT) else str(trace)}), flush=True)
        torch.cuda.empty_cache()
    for path in ("tiled", "tiledapprox", "timedomain"):
        if path not in args.paths:
            continue
        n_p = args.size or (4096 if path == "timedomain" else 1024)
        trace = args.out / f"trace_fdfd_{path}_{n_p}.json"
        if path == "timedomain":
            cell = timedomain_cell(n_p, dev=dev, trace=trace)
        else:
            cell = tiled_cell(n_p, approx=path == "tiledapprox", dev=dev, trace=trace)
        print(json.dumps({"path": path, **cell, "trace_file": str(trace.relative_to(ROOT))
                          if trace.is_relative_to(ROOT) else str(trace)}))
    N, dx, omega = args.size or 512, 1e-3, 17e9
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex128)
    src[N // 2, N // 2] = -1j * omega

    for path in args.paths:
        if path in ("invdes", "tiled", "tiledapprox", "timedomain", "compressed", "hps"):
            continue
        if path == "factor":
            def run():
                return {"factor_growth": DirectSolver(eps, mu, dx, dx, omega,
                                                      device=dev).factor_growth}
        elif path == "direct":
            solver = DirectSolver(eps, mu, dx, dx, omega, device=dev)

            def run():
                return {"residual_trace": solver.solve(src, rhs_scale=1.0,
                                                          refine_target=1e-6)[1]}
        else:
            op = make_operator(eps, mu, dx, dx, omega, device=dev)
            b = torch.tensor(src, dtype=torch.complex64, device=dev)
            M, _ = resolve_preconditioner(op, "fdm")

            def run():
                res = solve_fdfd(op, b, preconditioner=M, tol=1e-6, maxiter=3000, restart=20)
                return {"iterations": res.iterations,
                        "relative_residual": res.relative_residual}
        run()
        with torch.profiler.profile(activities=ACTIVITIES) as prof:
            with Timer(dev) as timer:
                result = run()
        trace = args.out / f"trace_fdfd_{path}_{N}.json"
        prof.export_chrome_trace(str(trace))
        print(json.dumps({"path": path, "size": N, **result,
                          "trace_file": str(trace.relative_to(ROOT))
                          if trace.is_relative_to(ROOT) else str(trace),
                          **window_summary(trace, timer.seconds)}))
    print(device_info()["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
