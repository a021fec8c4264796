"""The port's benchmark suite: the fourteen rows of the repository's
``bench.py`` (the JAX package's suite), one JSON line each, the headline
``fdtd2048`` LAST.

    python -m fdtd2d_tpu_torch.bench [--only name1,name2] [--device cuda|cpu]
    python -m fdtd2d_tpu_torch.cli bench [--only ...] [--device ...]

Rows, names, metric names, baselines and checks are bench.py's; each line
also carries the card's name and power limit (``card``, ``power_limit``, as
``utils/metrics.device_info`` reads them from nvidia-smi). The baselines are
the reference's own CPU numbers (BASELINE.md), copied as they are.

Sizes. ``--device cuda`` (the default) takes bench.py's full sizes;
``--device cpu`` takes the sizes bench.py runs off the TPU (512^2 and 256^2
FDTD, 128^2 to 192^2 solves, 64^2 datagen and UNet), which the tests run. A
CUDA device asked for and missing raises: no row falls back to the CPU.

The FDTD rows' backends. bench.py's ``fdtd2048`` asks for ``"pallas"``, the
TPU kernel that held the whole state on chip. On an H100 the port's K1 holds
the state in the SMs only up to 1034^2 (its resident mode), and a long call
on a 2048^2 grid runs fastest on K2, the temporally tiled kernel: 0.01372 ms
a step against K1 streaming's 0.07534 (PERF.md section 6). So ``fdtd2048``
and ``fdtd4096`` run ``"auto"`` and ``fdtd8192`` runs ``"ttiled"``, and all
three resolve to K2: each row asserts from the kernels' launch counters that
K2 ran and K1 did not, and prints ``"backend": "ttiled"``. On the CPU they
run the plain step (bench.py's ``"jax"`` off the TPU), ``"backend":
"torch"``. Before its timed calls, and untimed, each FDTD row holds its
configuration at its full size to the float64 plain step (``fdtd/step.py``),
<= 1e-5 relative for Ez, Hx and Hy, over two windows: 200 steps from a zero
state (the source and the cells around it: the wave spreads 0.15 cells a
step), and 20 steps (two sweeps of K = 8 and part of a third) from the
state of the row's own rollout at the step when the Ricker pulse's peak
reaches the grid's corners, where each of the four Mur bands and the four
corners must hold at least 1e-3 of max |Ez|: the bands, the corners and
every tile seam with a field on them. The second window is short because
float32 arithmetic itself drifts from float64 faster once the field fills
the grid: the plain float32 step at 256^2, from states 1000 to 1875 steps
in, drifts up to 1.1e-6 in 20 steps and 1.3e-5 in 50
(``tools/fdtd_drift.py``).

Timing: the host clock around work that ends in ``torch.cuda.synchronize``
(``utils/metrics.Timer``), as bench.py times around its reduction fetch.

The runner is bench.py's: each row in a child process of its own (a fresh
interpreter, ``python -m fdtd2d_tpu_torch.bench --child NAME``), killed
after ``FDTD2D_BENCH_TIMEOUT`` seconds (default 1200) and tried up to three
times, within the suite deadline ``FDTD2D_BENCH_SUITE_TIMEOUT`` (default
5400). Each finished row goes to stderr at once; all lines go to stdout at
the end, headline last. Exit code 1 when the headline is missing, 2 for an
unknown row name. The hidden row ``_hang`` sleeps for an hour and imports no
torch: the runner's tests kill it. This module's top level imports the
standard library and numpy only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from fdtd2d_tpu_torch import constants

FDTD_BASELINE = 0.0177          # GCells/s, reference NumPy kernels (BASELINE.md)
FDFD512_BASELINE_S = 7.1        # scipy spsolve at 512^2 (BASELINE.md)
TILED1024_BASELINE_S = 3.0      # reference ~3 s APPROXIMATE tiled solve at 1000^2
# reference exact solve at 1000^2: ~20 s spsolve per SOURCE (README.md:135)
DIRECT1024_BASELINE_S = 20.0
TD4096_TRANSITS = 2.5           # timedomain settle budget (bench.py)
DIRECT2048_RANK = 20            # HODLR rank and range-finder passes of
DIRECT2048_Q = 1                # bench.py's direct2048
DATAGEN_BASELINE_SPS = 1.0 / 0.72  # reference: one 256^2 spsolve per sample
# reference's own torch train step (batch 8 at 256^2) on a CPU (BASELINE.md)
TRAINSTEP_BASELINE_MS = 99708.0
# H100 SXM dense bf16 peak at 700 W (NVIDIA's data sheet): the divisor of
# both train-step rows, as bench.py divides both by one peak
BF16_PEAK_FLOPS = 989e12
FDTD_PARITY_STEPS = 200
FDTD_EDGE_STEPS = 20
FDTD_COVER = 1e-3               # least field in a Mur band or corner, of max |Ez|
FDTD_TOL = 1e-5
PACKAGE_ROOT = Path(__file__).resolve().parents[1]


def _full(device) -> bool:
    """bench.py's ``on_tpu``: full sizes on a CUDA device; a CUDA device
    that is not there raises."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"the bench was asked for {device} and no CUDA device is "
                               f"available; pass --device cpu for the CPU sizes")
        return True
    return False


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _timer(device):
    from fdtd2d_tpu_torch.utils.metrics import Timer

    return Timer(device)


# ---------------------------------------------------------------------------
# Scenes (bench.py's, copied)
# ---------------------------------------------------------------------------


def _fdtd_scene(N: int):
    """The FDTD rows' scene (bench.py's ``_fdtd``): a 4x dielectric block."""
    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    mu = np.full((N, N), constants.MU_0, np.float32)
    return eps, mu


def _fdfd512_scene(N: int, omega: float):
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex128)
    src[N // 2, N // 2] = -1j * omega
    return eps, mu, src


def _contrast_scene(N: int, seed: int = 7):
    """50%-duty binary 5x-contrast scene (core/scenes.py)."""
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene

    return hard_binary_scene(N, seed=seed)


def _block_scene(N: int, contrast: float = 2.5):
    """Moderate-contrast block scene with a unit point source."""
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= contrast
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N))
    src[N // 2, N // 2] = 1.0
    return eps, mu, src


# ---------------------------------------------------------------------------
# FDTD
# ---------------------------------------------------------------------------


def _fdtd_parity(eps, mu, cfg, steps: int, state=None) -> float:
    """Worst relative error of Ez, Hx and Hy after ``steps`` steps of
    ``cfg`` from ``state`` (zero when None) against the float64 plain step
    from the same state; raises above FDTD_TOL. With a state, each Mur band
    and corner of the reference's Ez must hold FDTD_COVER of max |Ez|."""
    import dataclasses

    import torch

    from fdtd2d_tpu_torch.fdtd.simulate import simulate
    from fdtd2d_tpu_torch.fdtd.step import MUR_BAND as b

    short = dataclasses.replace(cfg, nsteps=steps)
    got, _ = simulate(eps, mu, short, state=state)
    want, _ = simulate(eps.double(), mu.double(),
                       dataclasses.replace(short, backend="torch", dtype=torch.float64),
                       state=state)
    if state is not None:
        Ez = want[0].abs()
        parts = (Ez[b:-b, :b], Ez[b:-b, -b:], Ez[:b, b:-b], Ez[-b:, b:-b],
                 Ez[:b, :b], Ez[:b, -b:], Ez[-b:, :b], Ez[-b:, -b:])
        cover = float(min(p.max() for p in parts) / Ez.max())
        _check(cover >= FDTD_COVER, f"a Mur band or corner holds {cover:.2e} of max |Ez|")
    errs = {name: float((g.double() - w).abs().max() / w.abs().max())
            for name, g, w in zip(("Ez", "Hx", "Hy"), got, want)}
    _check(all(e <= FDTD_TOL for e in errs.values()),
           f"{steps} steps against the float64 plain step: {errs} > {FDTD_TOL}")
    return max(errs.values())


def _corner_steps(N: int, cfg) -> int:
    """Steps until the Ricker pulse's peak (at t = 1/fc) has crossed the
    N/sqrt(2) cells from the centre to the corners at c dt/dx cells a step."""
    courant = cfg.dt / (np.sqrt(constants.EPSILON_0 * constants.MU_0) * cfg.dx)
    return int(np.ceil(1.0 / (cfg.source_fc * cfg.dt) + N / np.sqrt(2.0) / courant))


def _fdtd_row(metric: str, N: int, steps: int, backend: str, device, reps: int = 3):
    """The best GCells/s of ``reps`` timed ``steps``-step rollouts on
    bench.py's scene after an untimed one, each continuing the last one's
    state; the parity checks first, then the launch counters of every call
    (K2's sweeps, no K1 launch) and the field."""
    import dataclasses

    import torch

    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, resolve_backend, simulate
    from fdtd2d_tpu_torch.ops import fdtd_fused, fdtd_ttiled

    eps, mu = (torch.as_tensor(a, device=device) for a in _fdtd_scene(N))
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=steps, source_xy=(N // 2, N // 2),
                     source_fc=30e9, backend=backend, device=str(device))
    resolved = resolve_backend(backend, (N, N), device, steps)
    _check(resolved == ("ttiled" if _full(device) else "torch"),
           f"backend {backend!r} resolved to {resolved!r} at {N}^2")
    k1, k2 = fdtd_fused.launches, fdtd_ttiled.launches
    err = _fdtd_parity(eps, mu, cfg, FDTD_PARITY_STEPS)
    late = _corner_steps(N, cfg)
    state, _ = simulate(eps, mu, dataclasses.replace(cfg, nsteps=late))
    edge_err = _fdtd_parity(eps, mu, cfg, FDTD_EDGE_STEPS, state)
    state, _ = simulate(eps, mu, cfg)
    best = 0.0
    for _ in range(reps):
        with _timer(device) as t:
            state, _ = simulate(eps, mu, cfg, state=state)
        best = max(best, N * N * steps / t.seconds / 1e9)
    launches = (fdtd_fused.launches - k1, fdtd_ttiled.launches - k2)
    K = fdtd_ttiled.pick_sweep_depth(N, N)[0]
    calls = (FDTD_PARITY_STEPS, late, FDTD_EDGE_STEPS) + (steps,) * (reps + 1)
    sweeps = sum(-(-n // K) for n in calls) if resolved == "ttiled" else 0
    _check(launches == (0, sweeps),
           f"{N}^2 {resolved}: {launches} K1 and K2 launches")
    _check(bool(torch.isfinite(state[0]).all()) and float(state[0].abs().max()) > 0,
           f"{N}^2: Ez is not finite and non-zero")
    return {"metric": metric, "value": round(best, 3), "unit": "GCells/s",
            "vs_baseline": round(best / FDTD_BASELINE, 1), "backend": resolved,
            "float64_rel_err": err, "edge_float64_rel_err": edge_err,
            "edge_after_steps": late}


def bench_fdtd2048(device):
    N, steps = (2048, 6000) if _full(device) else (512, 50)
    return _fdtd_row(f"fdtd_yee_updates_{N}x{N}", N, steps,
                     "auto" if _full(device) else "torch", device, reps=4)


def bench_fdtd4096(device):
    N, steps = (4096, 2048) if _full(device) else (256, 32)
    return _fdtd_row(f"fdtd_yee_updates_{N}x{N}_auto", N, steps,
                     "auto" if _full(device) else "torch", device)


def bench_fdtd8192(device):
    N, steps = (8192, 512) if _full(device) else (256, 32)
    return _fdtd_row(f"fdtd_yee_updates_{N}x{N}_ttiled", N, steps,
                     "ttiled" if _full(device) else "torch", device)


# ---------------------------------------------------------------------------
# FDFD
# ---------------------------------------------------------------------------


def _warm_solve(solve, device):
    """(result, seconds) of a warm call: one untimed call, then one timed."""
    solve()
    with _timer(device) as t:
        out = solve()
    return out, t.seconds


def bench_fdfd512(device):
    """Exact block-Thomas solve at 512^2 to a 1e-6 true residual: factor
    and a first solve untimed (``factor_s``), then a warm solve."""
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    N, dx, omega = (512, 1e-3, 17e9) if _full(device) else (128, 1e-3, 17e9)
    eps, mu, src = _fdfd512_scene(N, omega)
    # the scene's src already carries -1j*omega
    kw = dict(rhs_scale=1.0, refine_target=1e-6)
    with _timer(device) as tf:
        solver = DirectSolver(eps, mu, dx, dx, omega, device=device)
        solver.solve(src, **kw)
    with _timer(device) as t:
        _, trace = solver.solve(src, **kw)
    _check(trace[-2] < 1e-5, f"direct {N}^2 solve did not converge: {trace}")
    return {"metric": f"fdfd_{N}sq_solve", "value": round(t.seconds, 3),
            "unit": "s", "vs_baseline": round(FDFD512_BASELINE_S / t.seconds, 1),
            "factor_s": round(tf.seconds, 2)}


def bench_fdfd512_iter(device):
    """FDM-FGMRES in complex64 at 512^2, restart 20; the returned field's
    residual recomputed in complex128. The line carries the iterations of
    the timed solve: the host-bound solve's time is about proportional."""
    import torch

    from fdtd2d_tpu_torch.fdfd.refine import true_relative_residual
    from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    N, dx, omega = (512, 1e-3, 17e9) if _full(device) else (128, 1e-3, 17e9)
    eps, mu, src = _fdfd512_scene(N, omega)
    op = make_operator(eps, mu, dx, dx, omega, pml_thickness=40, device=device)
    b = torch.as_tensor(src, device=device).to(torch.complex64)
    M, _ = resolve_preconditioner(op, "fdm")
    kw = dict(preconditioner=M, tol=1e-6, maxiter=3000, restart=20)
    res, dt = _warm_solve(lambda: solve_fdfd(op, b, **kw), device)
    op128 = make_operator(eps, mu, dx, dx, omega, pml_thickness=40,
                          dtype=torch.complex128, device=device)
    true_res = true_relative_residual(op128, torch.as_tensor(src, device=device), res.x)
    _check(float(res.relative_residual) < 1e-4 and true_res < 1e-4,
           f"fdfd {N}^2 iterative: residual {res.relative_residual}, complex128 {true_res}")
    return {"metric": f"fdfd_{N}sq_iterative_solve", "value": round(dt, 3),
            "unit": "s", "vs_baseline": round(FDFD512_BASELINE_S / dt, 1),
            "iterations": res.iterations, "c128_residual": true_res}


def bench_direct1024(device):
    """Exact block-Thomas warm solve to 1e-6 on the hard binary scene."""
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    N, omega = (1024, 17e9) if _full(device) else (128, 17e9)
    dx = 1e-3
    eps, mu, src = _contrast_scene(N)
    solver = DirectSolver(eps, mu, dx, dx, omega, device=device)
    (_, trace), dt = _warm_solve(lambda: solver.solve(src, refine_target=1e-6), device)
    _check(trace[-2] < 1e-5, f"direct solve did not converge: {trace}")
    return {"metric": f"direct_{N}sq_hard_contrast_warm_solve",
            "value": round(dt, 3), "unit": "s",
            "vs_baseline": round(TILED1024_BASELINE_S / dt, 2)}


def bench_direct1024_batched(device):
    """One stored factorization, a 16-source sweep through
    ``solve_batched``: seconds PER SOURCE."""
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    N, omega, B = (1024, 17e9, 16) if _full(device) else (128, 17e9, 4)
    dx = 1e-3
    eps, mu, src = _contrast_scene(N)
    rng = np.random.default_rng(0)
    ij = rng.integers(N // 4, 3 * N // 4, size=(B, 2))
    srcs = np.zeros((B, N, N))
    srcs[np.arange(B), ij[:, 0], ij[:, 1]] = 1.0
    solver = DirectSolver(eps, mu, dx, dx, omega, device=device)
    (_, res, _), dt = _warm_solve(lambda: solver.solve_batched(srcs, refine_target=1e-6),
                                  device)
    dt /= B
    worst = float(np.max(np.asarray(res)))
    _check(worst < 1e-5, f"batched direct solve did not converge: {worst}")
    return {"metric": f"direct_{N}sq_batched{B}_warm_per_source",
            "value": round(dt, 3), "unit": "s",
            "vs_baseline": round(DIRECT1024_BASELINE_S / dt, 1)}


def bench_direct2048(device):
    """HODLR-compressed factors (rank 20, leaf 128, one power iteration)
    built and solved one sublattice at a time (``stacked_solve=False``), as
    bench.py runs them; a warm solve to 1e-6 on the hard scene. ``factor_s``
    is the factor and a first solve."""
    import torch

    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

    N, omega = (2048, 17e9) if _full(device) else (128, 17e9)
    dx = 1e-3
    eps, mu, src = hard_binary_scene(N, seed=3, source_amp=10.0)
    with _timer(device) as tf:
        solver = DirectSolver(eps, mu, dx, dx, omega, pml_thickness=40,
                              compressed=True, rank=DIRECT2048_RANK, leaf=128,
                              power_iters=DIRECT2048_Q, stacked_solve=False, device=device)
        solver.solve(src, refine_target=1e-6)
    with _timer(device) as t:
        _, trace = solver.solve(src, refine_target=1e-6)
    _check(trace[-2] < 1e-5, f"direct 2048 solve did not converge: {trace}")
    out = {"metric": f"direct_{N}sq_compressed_warm_solve",
           "value": round(t.seconds, 3), "unit": "s", "vs_baseline": None,
           "store_gb": round(solver.compressed_bytes / 1e9, 2),
           "rounds": len(trace) - 2, "factor_s": round(tf.seconds, 2),
           "trace": [float(f"{r:.3e}") for r in trace]}
    if _full(device):
        out["peak_gb"] = round(torch.cuda.max_memory_allocated(device) / 1e9, 2)
    return out


def bench_tiled1024(device):
    """Two-level tiled warm solve at 1024^2, contrast 1.5, to 1e-6."""
    from fdtd2d_tpu_torch.fdfd.tiled import TiledSolver

    N, omega = (1024, 17e9) if _full(device) else (160, 17e9)
    dx = 1e-3
    eps, mu, src = _block_scene(N, contrast=1.5)
    solver = TiledSolver(eps, mu, dx, dx, omega, device=device)
    kw = dict(solver_tol=1e-4, solver_maxiter=300, refine_target=1e-6)
    (_, trace), dt = _warm_solve(lambda: solver.solve(src, **kw), device)
    _check(trace[-2] < 1e-5, f"tiled solve did not converge: {trace}")
    return {"metric": f"tiled_{N}sq_exact_warm_solve", "value": round(dt, 3),
            "unit": "s", "vs_baseline": round(TILED1024_BASELINE_S / dt, 2)}


def bench_tiled1024_approx(device):
    """The same scene to a 1e-2 relative residual, no refinement, restart
    10: the reference's accuracy class."""
    from fdtd2d_tpu_torch.fdfd.tiled import TiledSolver

    N, omega = (1024, 17e9) if _full(device) else (160, 17e9)
    dx = 1e-3
    eps, mu, src = _block_scene(N, contrast=1.5)
    solver = TiledSolver(eps, mu, dx, dx, omega, outer_restart=10, device=device)
    kw = dict(solver_tol=1e-2, solver_maxiter=60, refine_target=None)
    (_, trace), dt = _warm_solve(lambda: solver.solve(src, **kw), device)
    _check(trace[-1] < 1e-2, f"tiled approx solve did not converge: {trace}")
    return {"metric": f"tiled_{N}sq_refaccuracy_warm_solve",
            "value": round(dt, 3), "unit": "s",
            "vs_baseline": round(TILED1024_BASELINE_S / dt, 2)}


def bench_timedomain4096(device):
    """Frequency-locked time-domain warm solve to a 1e-6 true residual at
    4096^2 / 17 GHz, contrast 1.5 (no stored factors)."""
    from fdtd2d_tpu_torch.fdfd.timedomain import TimeDomainSolver

    N, omega = (4096, 17e9) if _full(device) else (192, 30e9)
    dx = 1e-3
    eps, mu, src = _block_scene(N, contrast=1.5)
    solver = TimeDomainSolver(eps, mu, dx, dx, omega,
                              transits=TD4096_TRANSITS if _full(device) else 4.0,
                              device=device)
    (_, trace), dt = _warm_solve(lambda: solver.solve(src, refine_target=1e-6), device)
    _check(trace[-2] < 1e-6, f"timedomain did not converge: {trace}")
    return {"metric": f"timedomain_{N}sq_warm_solve", "value": round(dt, 2),
            "unit": "s", "vs_baseline": None,
            "steps_per_apply": solver.steps_per_apply,
            "rounds": len(trace) - 2}


# ---------------------------------------------------------------------------
# Surrogate
# ---------------------------------------------------------------------------


def bench_datagen(device):
    """Exact-label datagen: seed 0 warms up, seed 1 is timed. The port's
    draws differ from JAX's for a seed, so the check holds, not the
    fields."""
    from fdtd2d_tpu_torch.models.datagen import generate_batch

    size, batch = ((256, 256), 32) if _full(device) else ((64, 64), 8)
    generate_batch(0, batch=batch, shape=size, device=device)
    with _timer(device) as t:
        out = generate_batch(1, batch=batch, shape=size, device=device)
    sps = batch / t.seconds
    worst = float(np.max(out["residuals"]))
    _check(worst < 1e-4, f"datagen labels unconverged: {worst:.1e}")
    return {"metric": f"datagen_{size[0]}sq_samples_per_s",
            "value": round(sps, 2), "unit": "samples/s",
            "vs_baseline": round(sps / DATAGEN_BASELINE_SPS, 1)}


def bench_trainstep(device, compute_dtype: str = "float32"):
    """ms a step of a 32-step ``train_epoch`` of the full-width UNet2D() at
    batch 8 (a warm epoch after an untimed one); the step's FLOPs counted by
    FlopCounterMode, and on the card their share of the bf16 peak."""
    import torch

    from fdtd2d_tpu_torch.models.diffusion import DDPMSchedule
    from fdtd2d_tpu_torch.models.train import TrainConfig, create_state, train_epoch
    from fdtd2d_tpu_torch.utils.metrics import step_flops

    full = _full(device)
    H = 256 if full else 64
    B = 8
    nb = 32                      # steps an epoch
    n = nb * B
    cfg = TrainConfig(batch_size=B, compute_dtype=compute_dtype)
    state = create_state(0, (H, H), cfg, device=device)
    schedule = DDPMSchedule.create(cfg.num_train_timesteps, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    data = {name: torch.randn((n, H, H), generator=gen, device=device)
            for name in ("eps", "mu", "src", "Ez")}
    data["omega"] = torch.full((n,), 2.4, device=device)
    perm = torch.arange(n, device=device)
    state, loss = train_epoch(state, schedule, gen, data, perm, batch_size=B)
    with _timer(device) as t:
        state, loss = train_epoch(state, schedule, gen, data, perm, batch_size=B)
    ms = t.seconds / nb * 1e3
    _check(bool(np.isfinite(loss)), f"train epoch loss {loss}")
    flops = step_flops({k: v[:B] for k, v in data.items()})
    _check(flops > 0, f"FlopCounterMode counted {flops} FLOPs")
    tag = "" if compute_dtype == "float32" else "_bf16"
    out = {"metric": f"train_step_b{B}_{H}sq{tag}", "value": round(ms, 2),
           "unit": "ms",
           "vs_baseline": round(TRAINSTEP_BASELINE_MS / ms, 1) if full else None,
           "flops_per_step": flops}
    if full:
        out["mfu_vs_bf16_peak"] = round(flops / (ms / 1e3) / BF16_PEAK_FLOPS, 4)
    return out


def bench_trainstep_bf16(device):
    return bench_trainstep(device, compute_dtype="bfloat16")


# headline LAST
BENCHES = [
    ("fdtd4096", bench_fdtd4096),
    ("fdtd8192", bench_fdtd8192),
    ("fdfd512", bench_fdfd512),
    ("fdfd512iter", bench_fdfd512_iter),
    ("direct1024", bench_direct1024),
    ("direct1024batched", bench_direct1024_batched),
    ("direct2048", bench_direct2048),
    ("tiled1024", bench_tiled1024),
    ("tiled1024approx", bench_tiled1024_approx),
    ("timedomain4096", bench_timedomain4096),
    ("datagen", bench_datagen),
    ("trainstep", bench_trainstep),
    ("trainstepbf16", bench_trainstep_bf16),
    ("fdtd2048", bench_fdtd2048),
]


def _card(device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU's row."""
    if not _full(device):
        return {"card": "cpu", "power_limit": None}
    from fdtd2d_tpu_torch.utils.metrics import device_info

    info = device_info()
    return {"card": info["name"], "power_limit": info["power_limit"]}


def run_row(name: str, device) -> dict:
    """One row's line, checked, with the card's name and power limit."""
    import torch

    if _full(device):
        torch.cuda.reset_peak_memory_stats(device)
    return {**dict(BENCHES)[name](device), **_card(device)}


def run_child(name: str, device: str) -> None:
    if name == "_hang":
        # hidden host-only row that never returns: exercises the parent's
        # hung-child timeout without importing torch
        time.sleep(3600)
        return
    print(json.dumps(run_row(name, device)), flush=True)


def _child_env() -> dict:
    """The environment of a child: this checkout's package first on the
    path, whatever the parent's working directory."""
    path = os.environ.get("PYTHONPATH")
    return {**os.environ,
            "PYTHONPATH": str(PACKAGE_ROOT) + (os.pathsep + path if path else "")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fdtd2d_tpu_torch.bench",
                                 description="the port's benchmark suite, headline last")
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated bench names (default: all)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (bench.py's full sizes) or cpu (its off-TPU sizes)")
    ap.add_argument("--child", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child:
        run_child(args.child, args.device)
        return 0

    names = [n for n, _ in BENCHES]
    if args.only:
        keep = set(args.only.split(","))
        unknown = keep - set(names) - {"_hang"}
        if unknown:
            sys.stderr.write(f"unknown bench(es): {sorted(unknown)}\n")
            return 2
        names = [n for n in names if n in keep]
        if "_hang" in keep:          # test hook, see run_child
            names.append("_hang")
    if names != ["_hang"]:
        _full(args.device)           # raises when a missing CUDA device was asked for

    # A wall-clock cap a child (a hung child blocks the suite otherwise), and
    # a suite deadline past which the remaining rows are skipped loudly.
    child_timeout = float(os.environ.get("FDTD2D_BENCH_TIMEOUT", "1200"))
    deadline = time.monotonic() + float(
        os.environ.get("FDTD2D_BENCH_SUITE_TIMEOUT", "5400"))

    results = []
    for name in names:
        line = None
        for attempt in range(3):
            left = deadline - time.monotonic()
            if left <= 0:
                sys.stderr.write(f"[bench {name}] suite deadline exceeded; "
                                 f"skipping remaining attempts\n")
                break
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "fdtd2d_tpu_torch.bench",
                     "--child", name, "--device", args.device],
                    capture_output=True, text=True, env=_child_env(),
                    timeout=min(child_timeout, left))
            except subprocess.TimeoutExpired:
                sys.stderr.write(
                    f"[bench {name}] attempt {attempt + 1} timed out after "
                    f"{min(child_timeout, left):.0f} s; killed\n")
                continue
            lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
            if proc.returncode == 0 and lines:
                line = lines[-1]
                break
            sys.stderr.write(f"[bench {name}] attempt {attempt + 1} failed "
                             f"(rc={proc.returncode})\n{proc.stderr[-2000:]}\n")
        if line is None:
            sys.stderr.write(f"[bench {name}] giving up\n")
            continue
        results.append((name, line))
        sys.stderr.write(f"[bench {name}] {line}\n")
    # all JSON lines on stdout, headline last
    for _, line in results:
        print(line)
    # a reader takes the FINAL line as the headline: fail loudly when the
    # last requested row produced nothing
    if not results or results[-1][0] != names[-1]:
        sys.stderr.write(f"[bench] headline {names[-1]!r} missing\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
