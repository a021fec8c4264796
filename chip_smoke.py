"""Smoke run of the PyTorch/CUDA port (fdtd2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA device is required (there is no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them.
2. Build: compiles K1 and K2 from fdtd2d_tpu_torch/ops/csrc/ with nvcc (one
   nvcc per source, in parallel) and prints ptxas' registers and spills per
   kernel, and K2's dynamic shared memory per block at the 4096^2 plan
   (ptxas reports static shared memory only).
3. Kernel vs plain version on an odd non-square grid (203x157) with a
   seeded random medium, Ricker and sinusoidal sources, each run once as one
   call and once as two chunks with a step offset:
   - from a zero state, 300 steps, source at the centre and at (7, 9): the
     source's timing and place. In 300 steps the wave spreads about 45
     cells, so these runs leave most of the Mur bands near zero;
   - from a seeded random state, 60 steps, source at (rows-8, cols-10): the
     four Mur bands, the four corners and the cells the step never writes.
     Before the comparison counts, each band and each corner must hold a
     field of at least 1e-3 of max |Ez|, so that a wrong value there shows
     as an error about 100 times the tolerance.
   The float32 kernel is held against the float64 plain version on the same
   card, fed the same float32-rounded coefficients and state; the chunked
   run must equal the single run bit for bit.
4. The slice at full size: the 2048^2 bench scene through
   ``simulate(backend="auto")`` with 10 frames of 2000 steps. The backend must
   resolve to the kernel and the launch counter must advance by the launches
   of that run; fields and snapshots must be finite and non-zero. Then 200
   steps of the same scene on the kernel and on the float64 plain path: the
   interior and the source at full size (in 200 steps the wave from the
   centre reaches no Mur band; phase 3 checks those).
5. Time: GCells/s of the kernel and of the plain float32 torch path at 2048^2,
   1000 steps per timed run after a warm-up, CUDA events, in turns
   (plain, kernel, kernel, plain).
6. K2 (the temporally tiled kernel) vs its plain versions on the 203x157
   medium of phase 3, with forced small tiles so that tile seams cross every
   band and corner and windows of non-edge tiles hold band cells (7x10
   tiles at K = 7: TH - K = 0 and TW - K = 3 < 6), K = 7 and K = 3, which
   divide none of the step counts. Sources at the centre, in the halo overlap
   of four tiles (15, 21) and in corner tiles; zero states (300 steps) and
   random states (60 and 62 steps, band and corner coverage asserted as in
   phase 3). The float32 kernel is held to the float64 plain step and to the
   tile emulation (the same tiles) run in float64 on the kernel's float32
   inputs, both within the tolerance, and to itself run in two chunks, bit
   for bit: each cell's value at each step comes from the same expression on
   the same inputs, whichever tile computes it. (A float32 emulation is no
   yardstick at 1e-5: on the zero-state sinusoidal case with the source at
   (15, 21) the float32 plain arithmetic is itself 7.2e-06 from float64 in
   Hy, and the kernel's FMA rounding differs from it in the other direction.)
7. K3 mode (K2 at K = 1, entry fdtd_multistep_blocked): the cases of phase 6
   at K = 1.
8. The slice at full size: the 4096^2 bench scene (bench.py's fdtd4096 row:
   2048 steps, backend auto) through ``simulate(backend="auto")`` with 8
   frames: it must resolve to "ttiled", and the K2 counter must advance by
   the sweeps of that run; fields and snapshots finite and non-zero, in the
   staggered shapes. Then 200 steps against the float64 plain path. The
   8192^2 scene (fdtd8192: 512 steps, backend ttiled) once with the same
   checks, and 50 steps against float64. K3 through its entry point on the
   2048^2 scene: 200 steps, its counter advancing by 200, against phase 4's
   float64 run.
9. Time: ms a step of K2, K1 and the plain float32 path at 4096^2 and
   8192^2, and of K2, K3 mode, K1 and plain at 2048^2, through the op-level
   entry points with the state on the card; CUDA events after a warm-up, in
   turns (plain, K1, K2[, K3, K3], K2, K1, plain).

10. FDFD operator on the ``fdfd512`` scene (bench.py:126-134: 512^2, dx
    1e-3 m, omega 17e9, a 2.5x block, PML 40): the complex64 apply and
    diagonal on the card against the complex128 ones on the CPU (<= 1e-5
    relative); the five-point form against apply in complex128 on the card
    (<= 1e-12).
11. ``fdfd512`` (bench.py:137-164) through ``DirectSolver``: the factor
    time (the first ``torch.linalg.inv`` call's start-up apart), a warm-up
    and a timed warm solve with ``rhs_scale=1.0, refine_target=1e-6``;
    ``trace[-2] < 1e-5`` as the bench asserts; the returned complex128
    iterate's true residual recomputed on the CPU with the plain complex128
    operator (<= 1e-6). At 128^2 (the bench's CPU size) the refined field
    against scipy's spsolve of the matrix assembled from the complex128
    five-point coefficients (<= 1e-5). TF32 must be off.
12. ``direct1024`` and ``direct1024batched`` (bench.py:228-270) on the hard
    binary scene: factor time, a timed warm solve to 1e-6, then 16 sources
    from ``default_rng(0)`` through ``solve_batched``, timed per source; the
    worst true residual < 1e-5; each batched field against its single solve
    (<= 1e-5 relative in the 2-norm).
13. The checkpointed mode at 512^2, stride 32: its raw complex64 backsolve
    against the stored-factor one (<= 1e-5), its refined residual (<= 1e-6),
    factor and warm-solve times. It runs right after phase 11, while that
    phase's stored factors are still on the card, and before phase 12.
14. ``fdfd512iter`` (bench.py:167-194): FDM-FGMRES, restart 20, tol 1e-6,
    maxiter 3000, a timed warm solve; relative residual < 1e-4 (and its
    complex128 residual on the CPU), iterations.
15. The CLI: ``python -m fdtd2d_tpu_torch.cli fdfd --size 512 --solver
    direct|krylov --device cuda --out ""``; direct's f64-iterate residual
    <= --tol, krylov's residual < 10 --tol.
Each FDFD phase checks before it prints a time, and reads the peak device
memory (``torch.cuda.max_memory_allocated``) after its work.

Tolerance: 1e-5 relative (max |kernel - plain| / max |plain|), the bound of
the float64 oracle tests (tests/test_fdtd_oracle.py). The kernel and the
plain path differ in rounding only: nvcc contracts a + b*c into FMA and
CUDA's expf differs from the plain path's exp in the last bits, both far
inside that bound at float32.

Before its last line the script prints one JSON object with each kernel's
launches (counted in its main-path run of phase 4 or 8), error and times, one
with the GCells/s of phase 5, one with the times and errors of phases 6-9,
one with the times, residuals and peak memory of phases 10-15, and the
nvidia-smi line; its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
COVER = 1e-3  # least field in each Mur band and corner, relative to max |Ez|
DT, DX, FC = 5e-14, 1e-4, 30e9
Z0 = 376.73   # vacuum impedance: scales the random H to the random Ez


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((x.double() - ref).abs().max() / ref.abs().max())


def max_abs_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.double() - ref.double()).abs().max())


def phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0: float, what: str = "ok"):
    print(f"   {what} ({time.perf_counter() - t0:.2f} s)", flush=True)


def boundary_cover(Ez: torch.Tensor, band: int) -> float:
    """Smallest max |Ez| over the four Mur bands and the four corners,
    relative to max |Ez| over the grid."""
    b = band
    parts = (Ez[b:-b, :b], Ez[b:-b, -b:], Ez[:b, b:-b], Ez[-b:, b:-b],
             Ez[:b, :b], Ez[:b, -b:], Ez[-b:, :b], Ez[-b:, -b:])
    return float(min(p.abs().max() for p in parts) / Ez.abs().max())


def check_fields(fields, snaps, N: int, nframes: int):
    """Finite, non-zero fields (and snapshots) in the staggered shapes."""
    Ez, Hx, Hy = fields
    if nframes and (snaps is None or tuple(snaps.shape) != (nframes, N, N)):
        raise AssertionError(f"snapshots: {None if snaps is None else tuple(snaps.shape)}")
    named = (("Ez", Ez), ("Hx", Hx), ("Hy", Hy)) + ((("snapshots", snaps),) if nframes else ())
    for name, t in named:
        if not bool(torch.isfinite(t).all()) or float(t.abs().max()) == 0.0:
            raise AssertionError(f"{name} is not finite and non-zero")
    if tuple(Hx.shape) != (N, N - 1) or tuple(Hy.shape) != (N - 1, N):
        raise AssertionError("staggered shapes not kept")


def against_plain(kern, plain, what: str):
    """Relative errors of (Ez, Hx, Hy) against the float64 plain fields;
    raises above TOL. Returns (errors by name, max absolute error)."""
    errs = {name: rel_err(k, p) for name, k, p in zip(("Ez", "Hx", "Hy"), kern, plain)}
    if not all(e <= TOL for e in errs.values()):
        raise AssertionError(f"{what}: relative errors {errs} exceed {TOL}")
    return errs, max(max_abs_err(k, p) for k, p in zip(kern, plain))


def tiled_edge_cases(kernel, emulate, plain, states, cases, band):
    """Phases 6 and 7: ``kernel``/``emulate``/``plain`` run
    (fields, nsteps, offset, source, kind, K, tile) -> fields. Returns the
    worst relative error (against the float64 plain step and against the
    emulation) and the least band/corner coverage of the random states."""
    worst, least_cover = 0.0, 1.0
    for K, tile, start, nsteps, split, sources in cases:
        for (sx, sy), kind_ in ((s, k) for s in sources for k in ("ricker", "sinusoidal")):
            case = (f"K={K}, tiles {tile}, {start} state, {nsteps} steps, "
                    f"source {(sx, sy)}, {kind_}")
            args = ((sx, sy), kind_, K, tile)
            single = kernel(states[start], nsteps, 0, *args)
            chunked = kernel(kernel(states[start], split, 0, *args), nsteps - split,
                             split, *args)
            emu = emulate(states[start], nsteps, 0, *args)
            ref = plain(states[start], nsteps, 0, *args)
            torch.cuda.synchronize()
            if start == "random":
                cover = boundary_cover(ref[0], band)
                least_cover = min(least_cover, cover)
                if not cover >= COVER:
                    raise AssertionError(f"{case}: a Mur band or corner holds only "
                                         f"{cover:.2e} of max |Ez| (< {COVER})")
            case_worst = {"float64 plain": 0.0, "float64 tile emulation": 0.0}
            for name, k, c, e, p in zip(("Ez", "Hx", "Hy"), single, chunked, emu, ref):
                if k.shape != p.shape:
                    raise AssertionError(f"{name}: shape {tuple(k.shape)} != {tuple(p.shape)}")
                if not torch.equal(k, c):
                    raise AssertionError(f"{name}: chunked run differs from one run ({case})")
                for against, err in (("float64 plain", rel_err(k, p)),
                                     ("float64 tile emulation", rel_err(k, e))):
                    case_worst[against] = max(case_worst[against], err)
                    if not err <= TOL:
                        raise AssertionError(f"{name}: relative error {err:.3e} against "
                                             f"the {against} > {TOL} ({case})")
            worst = max(worst, *case_worst.values())
            print(f"   {case}: ok, relative error " +
                  ", ".join(f"{v:.3e} vs the {k}" for k, v in case_worst.items()))
    return worst, least_cover


def time_in_turns(order, runs, cells: int, steps: int):
    """GCells/s of each named run, timed with CUDA events after a warm-up,
    one timed run per appearance in ``order``."""
    from fdtd2d_tpu_torch.utils.metrics import throughput_gcells

    timed = {name: [] for name in order}
    for name in order:
        timed[name].append(throughput_gcells(cells, steps, runs[name], repeats=1, warmup=1))
    return timed


def bench_scene(N: int, constants):
    """The bench scene of bench.py's fdtd rows: a 4x dielectric block."""
    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    mu = np.full((N, N), constants.MU_0, np.float32)
    return eps, mu


def fdfd512_scene(N: int, omega: float, constants):
    """The scene of bench.py's fdfd512 rows: a 2.5x block, and a point
    source that already carries -1j*omega."""
    eps = np.full((N, N), constants.EPSILON_0)
    eps[N // 3 : 2 * N // 3, N // 4 : N // 2] *= 2.5
    mu = np.full((N, N), constants.MU_0)
    src = np.zeros((N, N), np.complex128)
    src[N // 2, N // 2] = -1j * omega
    return eps, mu, src


def complex_rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max |ref| in complex128, on x's device."""
    ref = ref.to(x.device, torch.complex128)
    return float((x.to(torch.complex128) - ref).abs().max() / ref.abs().max())


def norm_rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.to(ref.dtype) - ref) / torch.linalg.vector_norm(ref))


def cpu_residual(op128_cpu, b, x) -> float:
    """True relative residual of ``x`` with the plain complex128 operator
    on the CPU."""
    b = b.cpu().to(torch.complex128)
    r = op128_cpu.residual(b, x.cpu().to(torch.complex128))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def timed(fn, dev):
    """(result, seconds) of ``fn()`` on the host clock, the device
    synchronized before and after."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9


def fdfd_phases(dev) -> dict:
    """Phases 10-15: the FDFD path on the card. Returns the numbers of the
    ``{"fdfd": ...}`` line."""
    import re
    import subprocess

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.core.scenes import hard_binary_scene
    from fdtd2d_tpu_torch.fdfd.direct import DirectSolver, five_point_coefficients
    from fdtd2d_tpu_torch.fdfd.solver import resolve_preconditioner, solve_fdfd
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator

    out = {}
    dx, omega, N = 1e-3, 17e9, 512
    eps, mu, src = fdfd512_scene(N, omega, constants)

    # -- 10. operator -------------------------------------------------------------
    t0 = phase("10. FDFD operator, fdfd512 scene: c64 on the card vs c128 on the CPU")
    torch.cuda.reset_peak_memory_stats(dev)
    op32 = make_operator(eps, mu, dx, dx, omega, dtype=torch.complex64, device=dev)
    op128 = make_operator(eps, mu, dx, dx, omega, dtype=torch.complex128, device=dev)
    op128_cpu = make_operator(eps, mu, dx, dx, omega, dtype=torch.complex128)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    errs = {"apply_c64": complex_rel_err(op32.apply(x.to(dev, torch.complex64)), op128_cpu.apply(x)),
            "diagonal_c64": complex_rel_err(op32.diagonal(), op128_cpu.diagonal())}
    d, e, w, s_, n = five_point_coefficients(op128)
    xd = x.to(dev)
    shifted = (torch.nn.functional.pad(xd[:, 2:], (0, 2)), torch.nn.functional.pad(xd[:, :-2], (2, 0)),
               torch.nn.functional.pad(xd[2:], (0, 0, 0, 2)), torch.nn.functional.pad(xd[:-2], (0, 0, 2, 0)))
    five = d * xd + e * shifted[0] + w * shifted[1] + s_ * shifted[2] + n * shifted[3]
    errs["five_point_c128"] = complex_rel_err(five, op128.apply(xd))
    for name, bound in (("apply_c64", TOL), ("diagonal_c64", TOL), ("five_point_c128", 1e-12)):
        if not errs[name] <= bound:
            raise AssertionError(f"operator {name}: relative error {errs[name]:.3e} > {bound}")
    out["operator"] = {"rel_err": errs, "peak_gb": peak_gb(dev)}
    del op128, d, e, w, s_, n, five, shifted, xd
    done(t0, ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # -- 11. fdfd512, direct ----------------------------------------------------------
    t0 = phase("11. fdfd512: DirectSolver at 512^2, refine to 1e-6, rhs_scale 1.0")
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 is on: the pivotless c64 block-LU needs full-fp32 matmuls")
    _, inv_startup_s = timed(lambda: torch.linalg.inv(
        torch.eye(8, dtype=torch.complex64, device=dev)), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    solver, factor_s = timed(lambda: DirectSolver(eps, mu, dx, dx, omega, device=dev), dev)
    kw = dict(rhs_scale=1.0, refine_target=1e-6)
    (_, trace_first), first_s = timed(lambda: solver.solve(src, **kw), dev)
    (x512, trace), solve_s = timed(lambda: solver.solve(src, **kw), dev)
    if not trace[-2] < 1e-5 or not trace[-2] <= kw["refine_target"]:
        raise AssertionError(f"direct 512^2 solve did not converge: {trace}")
    (x512_64, trace64), split_s = timed(lambda: solver.solve(src, return_split=True, **kw), dev)
    b512 = torch.tensor(src)
    res_cpu = cpu_residual(op128_cpu, b512, x512_64)
    if not res_cpu <= 1e-6:
        raise AssertionError(f"the returned c128 iterate's CPU residual is {res_cpu:.3e}")
    peak = peak_gb(dev)
    # bench.py's CPU size: the refined field against scipy's spsolve
    n128 = 128
    eps_s, mu_s, src_s = fdfd512_scene(n128, omega, constants)
    small = DirectSolver(eps_s, mu_s, dx, dx, omega, device=dev)
    xs64, _ = small.solve(src_s, rhs_scale=1.0, refine_target=1e-10, return_split=True)
    coeffs = [c.numpy().ravel() for c in five_point_coefficients(
        make_operator(eps_s, mu_s, dx, dx, omega, dtype=torch.complex128))]
    d_, e_, w_, s2, n2 = coeffs
    off = 2 * n128
    A = sp.diags([d_, e_[:-2], w_[2:], s2[:-off], n2[off:]], [0, 2, -2, off, -off], format="csc")
    x_sp = spla.spsolve(A, src_s.ravel()).reshape(n128, n128)
    err_sp = complex_rel_err(xs64.cpu(), torch.tensor(x_sp))
    if not err_sp <= TOL:
        raise AssertionError(f"128^2 direct vs spsolve: relative error {err_sp:.3e} > {TOL}")
    out["fdfd512"] = {"inv_startup_s": inv_startup_s, "factor_s": factor_s,
                      "first_solve_s": first_s, "warm_solve_s": solve_s,
                      "warm_solve_split_s": split_s, "trace": trace, "trace_first": trace_first,
                      "cpu_c128_residual": res_cpu, "factor_growth": solver.factor_growth,
                      "peak_gb": peak, "spsolve_128_rel_err": err_sp}
    done(t0, f"factor {factor_s:.3f} s (first inv {inv_startup_s:.3f} s), warm solve "
             f"{solve_s:.4f} s, trace {[f'{t:.2e}' for t in trace]}, CPU c128 residual "
             f"{res_cpu:.3e}, 128^2 vs spsolve {err_sp:.3e}, peak {peak:.3f} GB")

    # -- 13 needs phase 11's solver: the checkpointed mode at 512^2 --------------------
    t0 = phase("13. checkpointed DirectSolver at 512^2, stride 32")
    torch.cuda.reset_peak_memory_stats(dev)
    ckpt, ck_factor_s = timed(lambda: DirectSolver(eps, mu, dx, dx, omega, checkpointed=True,
                                                   stride=32, device=dev), dev)
    unit = torch.tensor(rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)),
                        dtype=torch.complex64, device=dev)
    unit = unit / torch.linalg.vector_norm(unit)
    raw_err = complex_rel_err(ckpt._solve(unit), solver._solve(unit))
    if not raw_err <= TOL:
        raise AssertionError(f"checkpointed raw backsolve vs stored factors: {raw_err:.3e}")
    ckpt.solve(src, **kw)
    (_, ck_trace), ck_solve_s = timed(lambda: ckpt.solve(src, **kw), dev)
    if not ck_trace[-2] <= 1e-6:
        raise AssertionError(f"checkpointed refined residual: {ck_trace}")
    out["ckpt512"] = {"stride": 32, "factor_s": ck_factor_s, "warm_solve_s": ck_solve_s,
                      "raw_backsolve_rel_err": raw_err, "trace": ck_trace,
                      "peak_gb": peak_gb(dev)}
    del ckpt, solver, x512, x512_64, unit
    torch.cuda.empty_cache()
    done(t0, f"factor {ck_factor_s:.3f} s, warm solve {ck_solve_s:.4f} s, raw backsolve vs "
             f"stored {raw_err:.3e}, trace {[f'{t:.2e}' for t in ck_trace]}")

    # -- 12. direct1024 and direct1024batched -----------------------------------------
    t0 = phase("12. direct1024 / direct1024batched: hard binary scene at 1024^2")
    N2, B = 1024, 16
    eps2, mu2, src2 = hard_binary_scene(N2)
    torch.cuda.reset_peak_memory_stats(dev)
    solver2, factor2_s = timed(lambda: DirectSolver(eps2, mu2, dx, dx, omega, device=dev), dev)
    factor_peak = peak_gb(dev)
    solver2.solve(src2, refine_target=1e-6)
    (_, trace2), solve2_s = timed(lambda: solver2.solve(src2, refine_target=1e-6), dev)
    if not trace2[-2] < 1e-5:
        raise AssertionError(f"direct 1024^2 solve did not converge: {trace2}")
    rng0 = np.random.default_rng(0)
    ij = rng0.integers(N2 // 4, 3 * N2 // 4, size=(B, 2))
    srcs = np.zeros((B, N2, N2))
    srcs[np.arange(B), ij[:, 0], ij[:, 1]] = 1.0
    solver2.solve_batched(srcs, refine_target=1e-6)
    torch.cuda.reset_peak_memory_stats(dev)
    (xb, per_sample, trace_b), batched_s = timed(
        lambda: solver2.solve_batched(srcs, refine_target=1e-6), dev)
    batched_peak = peak_gb(dev)
    worst = float(per_sample.max())
    if not worst < 1e-5:
        raise AssertionError(f"batched direct solve did not converge: {worst}")
    singles = []
    for i in range(B):
        xi, _ = solver2.solve(srcs[i], refine_target=1e-6)
        singles.append(norm_rel(xb[i], xi))
    if not max(singles) <= TOL:
        raise AssertionError(f"batched vs single solves: {max(singles):.3e} > {TOL}")
    out["direct1024"] = {"factor_s": factor2_s, "warm_solve_s": solve2_s, "trace": trace2,
                         "factor_growth": solver2.factor_growth,
                         "factor_peak_gb": factor_peak}
    out["direct1024batched"] = {"sources": B, "warm_s": batched_s,
                                "warm_per_source_s": batched_s / B, "trace": trace_b,
                                "worst_residual": worst,
                                "batched_vs_single_rel_err": max(singles),
                                "peak_gb": batched_peak}
    del solver2, xb
    torch.cuda.empty_cache()
    done(t0, f"factor {factor2_s:.3f} s (peak {factor_peak:.3f} GB), warm solve {solve2_s:.4f} s "
             f"{[f'{t:.2e}' for t in trace2]}; batched {B}: {batched_s / B:.4f} s a source, "
             f"worst {worst:.3e}, vs singles {max(singles):.3e}, peak {batched_peak:.3f} GB")

    # -- 14. fdfd512iter --------------------------------------------------------------
    t0 = phase("14. fdfd512iter: FDM-FGMRES at 512^2, restart 20")
    torch.cuda.reset_peak_memory_stats(dev)
    b32 = torch.tensor(src, dtype=torch.complex64, device=dev)
    M, _ = resolve_preconditioner(op32, "fdm")
    kwi = dict(preconditioner=M, tol=1e-6, maxiter=3000, restart=20)
    solve_fdfd(op32, b32, **kwi)
    res_it, iter_s = timed(lambda: solve_fdfd(op32, b32, **kwi), dev)
    if not res_it.relative_residual < 1e-4:
        raise AssertionError(f"fdfd512iter residual {res_it.relative_residual}")
    it_cpu = cpu_residual(op128_cpu, b512, res_it.x)
    out["fdfd512iter"] = {"warm_solve_s": iter_s, "relative_residual": res_it.relative_residual,
                          "cpu_c128_residual": it_cpu, "iterations": res_it.iterations,
                          "converged": res_it.converged, "peak_gb": peak_gb(dev)}
    done(t0, f"warm solve {iter_s:.4f} s, {res_it.iterations} iterations, residual "
             f"{res_it.relative_residual:.3e} (c128 on the CPU {it_cpu:.3e})")

    # -- 15. the CLI --------------------------------------------------------------------
    t0 = phase("15. CLI: fdtd2d_tpu_torch.cli fdfd --size 512 --device cuda --out ''")
    tol = 1e-6
    cli = {}
    for solver_name in ("direct", "krylov"):
        cmd = [sys.executable, "-m", "fdtd2d_tpu_torch.cli", "fdfd", "--size", "512",
               "--solver", solver_name, "--tol", str(tol), "--device", "cuda", "--out", ""]
        t_cli = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t_cli
        if proc.returncode != 0:
            raise AssertionError(f"CLI {solver_name} exited {proc.returncode}: {proc.stderr[-2000:]}")
        m = re.search(r"^relative residual: (\S+)(?: \(f64 iterate: (\S+)\))?$",
                      proc.stdout, re.M)
        if m is None:
            raise AssertionError(f"CLI {solver_name} printed no residual: {proc.stdout!r}")
        first = float(m.group(1))
        if solver_name == "direct":
            iterate = float(m.group(2))
            if not iterate <= tol:
                raise AssertionError(f"CLI direct: f64-iterate residual {iterate} > {tol}")
            cli[solver_name] = {"residual": first, "f64_iterate_residual": iterate}
        else:
            if not first < 10 * tol:
                raise AssertionError(f"CLI krylov: residual {first} >= {10 * tol}")
            cli[solver_name] = {"residual": first}
        cli[solver_name]["process_s"] = seconds
        print(f"   {solver_name}: {proc.stdout.strip()} ({seconds:.1f} s)")
    out["cli"] = cli
    done(t0)
    return out


def main() -> int:
    # -- 1. device ------------------------------------------------------------
    t0 = phase("1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import fdtd2d_tpu_torch
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.core.grid import grid_init
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, resolve_backend, simulate
    from fdtd2d_tpu_torch.fdtd.step import MUR_BAND, precompute_coefficients
    from fdtd2d_tpu_torch.ops import _build, fdtd_blocked, fdtd_fused, fdtd_ttiled
    from fdtd2d_tpu_torch.utils.metrics import Timer, device_info, throughput_gcells

    pkg_root = Path(fdtd2d_tpu_torch.__file__).resolve().parents[1]
    if pkg_root != ROOT:
        raise RuntimeError(f"fdtd2d_tpu_torch was imported from {pkg_root}, "
                           f"not from this checkout ({ROOT})")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    info = device_info()
    kind = torch.cuda.get_device_name(0)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    done(t0)

    # -- 2. build -------------------------------------------------------------
    t0 = phase("2. build K1 and K2 with nvcc")
    with Timer() as build_timer:
        lib_path = _build.build()
        _build.load()
    log = (lib_path.parent / "build.log")
    kernel_name = "?"
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            kernel_name = next((k for k in ("h_update_and_save_strips", "e_interior_update",
                                            "boundary_update", "ttiled_sweep") if k in line),
                               line.strip())
        elif "registers" in line or "spill" in line:
            print(f"   ptxas {kernel_name}: {line.strip()}")
    K, TH, TW = fdtd_ttiled.pick_sweep_depth(4096, 4096)
    smem = fdtd_ttiled.smem_bytes(fdtd_ttiled.window_extent(4096, TH, K),
                                  fdtd_ttiled.window_extent(4096, TW, K))
    print(f"   ttiled_sweep at 4096^2 (K={K}, {TH}x{TW} tiles): {smem} B of dynamic "
          f"shared memory a block ({fdtd_ttiled.SMEM_BUDGET} B fit two blocks an SM)")
    done(t0, f"built {lib_path.relative_to(ROOT)} in {build_timer.seconds:.2f} s")

    # -- 3. kernel vs plain version, edge cases --------------------------------
    t0 = phase("3. kernel vs plain float64, 203x157")
    rows, cols = 203, 157
    rng = np.random.default_rng(0)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    eps[0, 0] = constants.EPSILON_0
    mu = np.full((rows, cols), constants.MU_0)
    # The float64 plain run takes the kernel's float32 coefficients and
    # state, so that the comparison measures the kernel's arithmetic and not
    # the rounding of its inputs to float32.
    coeffs32 = precompute_coefficients(torch.tensor(eps, device=dev),
                                       torch.tensor(mu, device=dev), DT, DX,
                                       torch.float32)
    coeffs = {torch.float32: coeffs32,
              torch.float64: tuple(c.double() for c in coeffs32)}
    states = {"zero": grid_init(rows, cols, torch.float32, dev),
              "random": tuple(torch.tensor(rng.standard_normal(shape), device=dev,
                                           dtype=torch.float32) / scale
                              for shape, scale in (((rows, cols), 1.0),
                                                   ((rows, cols - 1), Z0),
                                                   ((rows - 1, cols), Z0)))}
    cases = (("zero", 300, 137, ((rows // 2, cols // 2), (7, 9))),
             ("random", 60, 27, ((rows - 8, cols - 10),)))
    worst, least_cover = 0.0, 1.0
    for start, nsteps, split, sources in cases:
        for (sx, sy), kind_ in ((s, k) for s in sources for k in ("ricker", "sinusoidal")):
            def run(dtype, n, offset, fields):
                ce, ch, coef = coeffs[dtype]
                fn = (fdtd_fused.fdtd_multistep_fused if dtype == torch.float32
                      else fdtd_fused.fdtd_multistep_fused_reference)
                fields = tuple(f.to(dtype) for f in fields)
                return fn(*fields, ce, ch, coef, DT, FC, sx, sy, n, kind_, offset)

            case = f"{start} state, {nsteps} steps, source {(sx, sy)}, {kind_}"
            single = run(torch.float32, nsteps, 0, states[start])
            chunked = run(torch.float32, nsteps - split, split,
                          run(torch.float32, split, 0, states[start]))
            plain = run(torch.float64, nsteps, 0, states[start])
            torch.cuda.synchronize()
            if start == "random":
                cover = boundary_cover(plain[0], MUR_BAND)
                least_cover = min(least_cover, cover)
                if not cover >= COVER:
                    raise AssertionError(f"{case}: a Mur band or corner holds only "
                                         f"{cover:.2e} of max |Ez| (< {COVER})")
            case_worst = 0.0
            for name, k, c, p in zip(("Ez", "Hx", "Hy"), single, chunked, plain):
                if k.shape != p.shape:
                    raise AssertionError(f"{name}: shape {tuple(k.shape)} != {tuple(p.shape)}")
                if not torch.equal(k, c):
                    raise AssertionError(f"{name}: chunked run differs from one run ({case})")
                err = rel_err(k, p)
                case_worst = max(case_worst, err)
                if not err <= TOL:
                    raise AssertionError(f"{name}: relative error {err:.3e} > {TOL} ({case})")
            worst = max(worst, case_worst)
            print(f"   {case}: ok, relative error {case_worst:.3e}")
    done(t0, f"worst relative error {worst:.3e} <= {TOL}; chunked == single; "
             f"random state: each band and corner >= {least_cover:.3e} of max |Ez|")

    # -- 4. the slice at full size --------------------------------------------
    t0 = phase("4. simulate(backend='auto') on the 2048^2 bench scene")
    N = 2048
    eps, mu = bench_scene(N, constants)
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=2000, source_xy=(N // 2, N // 2),
                     source_fc=FC, nframes=10, backend="auto", device="cuda")
    backend = resolve_backend(cfg.backend, (N, N), cfg.device)
    if backend != "fused":
        raise AssertionError(f"backend 'auto' resolved to {backend!r}, not 'fused'")
    fdtd_fused.launches = 0
    (Ez, Hx, Hy), snaps = simulate(eps, mu, cfg)
    torch.cuda.synchronize()
    main_launches = fdtd_fused.launches
    expected = 3 * cfg.nsteps
    if main_launches != expected:
        raise AssertionError(f"K1 launch counter advanced by {main_launches}, "
                             f"expected {expected}")
    check_fields((Ez, Hx, Hy), snaps, N, cfg.nframes)
    print(f"   {main_launches} K1 launches; max |Ez| = {float(Ez.abs().max()):.4e}")

    short = FDTDConfig(dt=DT, dx=DX, nsteps=200, source_xy=(N // 2, N // 2),
                       source_fc=FC, backend="auto", device="cuda")
    plain_cfg = FDTDConfig(dt=DT, dx=DX, nsteps=200, source_xy=(N // 2, N // 2),
                           source_fc=FC, backend="torch", device="cuda",
                           dtype=torch.float64)
    kern, _ = simulate(eps, mu, short)
    plain, _ = simulate(eps.astype(np.float64), mu.astype(np.float64), plain_cfg)
    torch.cuda.synchronize()
    errs, abs_err = against_plain(kern, plain, "2048^2 200-step")
    done(t0, "200 steps vs float64 plain: " +
         ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # -- 5. time ----------------------------------------------------------------
    t0 = phase("5. GCells/s at 2048^2, 1000 steps per run, CUDA events")
    steps = 1000
    # scene already on the card: the timed runs hold no host-to-device copy
    eps_d, mu_d = torch.tensor(eps, device=dev), torch.tensor(mu, device=dev)
    timed = {"torch": [], "fused": []}
    for backend in ("torch", "fused", "fused", "torch"):
        run_cfg = FDTDConfig(dt=DT, dx=DX, nsteps=steps, source_xy=(N // 2, N // 2),
                             source_fc=FC, backend=backend, device="cuda")
        start = (Ez, Hx, Hy)
        timed[backend].append(throughput_gcells(
            N * N, steps, lambda: simulate(eps_d, mu_d, run_cfg, state=start),
            repeats=1, warmup=1))
    kernel_gcells, plain_gcells = max(timed["fused"]), max(timed["torch"])
    done(t0, f"kernel {timed['fused']} GCells/s, plain torch {timed['torch']} GCells/s")

    def step_ms(gcells, n=N):
        return n * n / (gcells * 1e9) * 1e3

    # -- 6. K2 vs its plain versions, edge cases ---------------------------------
    t0 = phase("6. K2 vs the float64 plain step and tile emulation, 203x157")

    def tiled_runner(fn, dtype):
        def run(fields, n, offset, src, kind_, K, tile):
            ce, ch, coef = coeffs[dtype]
            fields = tuple(f.to(dtype) for f in fields)
            return fn(*fields, ce, ch, coef, DT, FC, *src, n, kind_, offset, K=K, tile=tile)
        return run

    def plain_runner(fields, n, offset, src, kind_, K, tile):
        ce, ch, coef = coeffs[torch.float64]
        return fdtd_fused.fdtd_multistep_fused_reference(
            *(f.double() for f in fields), ce, ch, coef, DT, FC, *src, n, kind_, offset)

    emulate = tiled_runner(fdtd_ttiled.fdtd_multistep_ttiled_reference, torch.float64)
    k2_cases = ((7, (7, 10), "zero", 300, 137, ((rows // 2, cols // 2), (15, 21), (3, 4))),
                (7, (7, 10), "random", 60, 27, ((rows - 3, cols - 2),)),
                (3, (13, 16), "random", 62, 29, ((2, 3),)))
    k2_worst, k2_cover = tiled_edge_cases(
        tiled_runner(fdtd_ttiled.fdtd_multistep_ttiled, torch.float32), emulate,
        plain_runner, states, k2_cases, MUR_BAND)
    done(t0, f"worst relative error {k2_worst:.3e} <= {TOL}; chunked == single; "
             f"random state: each band and corner >= {k2_cover:.3e} of max |Ez|")

    # -- 7. K3 mode vs its plain versions, edge cases ----------------------------
    t0 = phase("7. K3 mode (K2 at K = 1) vs the float64 plain step and emulation, 203x157")

    def blocked_runner(fields, n, offset, src, kind_, K, tile):
        ce, ch, coef = coeffs[torch.float32]
        return fdtd_blocked.fdtd_multistep_blocked(*fields, ce, ch, coef, DT, FC, *src,
                                                   n, kind_, offset, tile=tile)

    k3_cases = tuple((1, tile, start, n, split, srcs)
                     for _, tile, start, n, split, srcs in k2_cases)
    k3_worst, k3_cover = tiled_edge_cases(blocked_runner, emulate, plain_runner, states,
                                          k3_cases, MUR_BAND)
    done(t0, f"worst relative error {k3_worst:.3e} <= {TOL}; chunked == single; "
             f"random state: each band and corner >= {k3_cover:.3e} of max |Ez|")

    # -- 8. the slice at full size: 4096^2 and 8192^2 on K2, K3 at 2048^2 ---------
    t0 = phase("8. simulate(backend='auto') on the 4096^2 bench scene; 8192^2; K3")
    big = {}
    for n_big, nsteps_big, backend_big, nframes_big, parity_steps in (
            (4096, 2048, "auto", 8, 200), (8192, 512, "ttiled", 0, 50)):
        eps_b, mu_b = bench_scene(n_big, constants)
        cfg_b = FDTDConfig(dt=DT, dx=DX, nsteps=nsteps_big, source_xy=(n_big // 2, n_big // 2),
                           source_fc=FC, nframes=nframes_big, backend=backend_big,
                           device="cuda")
        resolved = resolve_backend(cfg_b.backend, (n_big, n_big), cfg_b.device)
        if resolved != "ttiled":
            raise AssertionError(f"backend {backend_big!r} resolved to {resolved!r} "
                                 f"at {n_big}^2, not 'ttiled'")
        K, TH, TW = fdtd_ttiled.pick_sweep_depth(n_big, n_big)
        per_frame = nsteps_big // nframes_big if nframes_big else nsteps_big
        expected = (nsteps_big // per_frame) * -(-per_frame // K)
        fdtd_ttiled.launches = 0
        fields_b, snaps_b = simulate(eps_b, mu_b, cfg_b)
        torch.cuda.synchronize()
        sweeps = fdtd_ttiled.launches
        if sweeps != expected:
            raise AssertionError(f"K2 launch counter advanced by {sweeps} at {n_big}^2, "
                                 f"expected {expected}")
        check_fields(fields_b, snaps_b, n_big, nframes_big)
        del snaps_b
        short_b = dataclasses.replace(cfg_b, nsteps=parity_steps, nframes=0)
        kern_b, _ = simulate(eps_b, mu_b, short_b)
        plain_b, _ = simulate(eps_b.astype(np.float64), mu_b.astype(np.float64),
                              dataclasses.replace(short_b, backend="torch",
                                                  dtype=torch.float64))
        torch.cuda.synchronize()
        errs_b, abs_b = against_plain(kern_b, plain_b, f"{n_big}^2 {parity_steps}-step")
        del kern_b, plain_b
        torch.cuda.empty_cache()
        big[n_big] = {"fields": fields_b, "eps": eps_b, "mu": mu_b, "sweeps": sweeps,
                      "plan": [K, TH, TW], "rel_err": errs_b, "abs_err": abs_b,
                      "parity_steps": parity_steps}
        print(f"   {n_big}^2 {backend_big} -> ttiled, plan K={K} tiles {TH}x{TW}: "
              f"{sweeps} K2 launches for {nsteps_big} steps; {parity_steps} steps vs "
              f"float64: " + ", ".join(f"{k} {v:.3e}" for k, v in errs_b.items()))
    k2_main_launches = big[4096]["sweeps"]

    fdtd_blocked.launches = 0
    ce2, ch2, coef2 = precompute_coefficients(torch.tensor(eps, device=dev),
                                              torch.tensor(mu, device=dev), DT, DX)
    k3_out = fdtd_blocked.fdtd_multistep_blocked(
        *grid_init(N, N, torch.float32, dev), ce2, ch2, coef2, DT, FC, N // 2, N // 2,
        200, "ricker", 0)
    torch.cuda.synchronize()
    k3_main_launches = fdtd_blocked.launches
    if k3_main_launches != 200:
        raise AssertionError(f"K3 launch counter advanced by {k3_main_launches}, expected 200")
    k3_errs, k3_abs = against_plain(k3_out, plain, "K3 2048^2 200-step")
    done(t0, f"K3 at 2048^2: {k3_main_launches} launches, 200 steps vs float64: " +
             ", ".join(f"{k} {v:.3e}" for k, v in k3_errs.items()))

    # -- 9. time: K2, K1, plain (and K3) ------------------------------------------
    t0 = phase("9. ms a step of K2, K1, K3 mode and plain, CUDA events, in turns")

    def op_runs(n, fields, ce_, ch_, coef_, steps):
        args = (ce_, ch_, coef_, DT, FC, n // 2, n // 2, steps, "ricker", 0)
        return {"plain": lambda: fdtd_fused.fdtd_multistep_fused_reference(*fields, *args),
                "K1": lambda: fdtd_fused.fdtd_multistep_fused(*fields, *args),
                "K2": lambda: fdtd_ttiled.fdtd_multistep_ttiled(*fields, *args),
                "K3": lambda: fdtd_blocked.fdtd_multistep_blocked(*fields, *args)}

    times = {}
    order_small = ("plain", "K1", "K2", "K3", "K3", "K2", "K1", "plain")
    order_big = ("plain", "K1", "K2", "K2", "K1", "plain")
    for n_t, steps_t, order in ((2048, 1000, order_small), (4096, 500, order_big),
                                (8192, 200, order_big)):
        if n_t == 2048:
            fields_t, ce_t, ch_t, coef_t = (Ez, Hx, Hy), ce2, ch2, coef2
        else:
            fields_t = big[n_t]["fields"]
            ce_t, ch_t, coef_t = precompute_coefficients(
                torch.tensor(big[n_t]["eps"], device=dev),
                torch.tensor(big[n_t]["mu"], device=dev), DT, DX)
        timed_t = time_in_turns(order, op_runs(n_t, fields_t, ce_t, ch_t, coef_t, steps_t),
                                n_t * n_t, steps_t)
        best = {name: max(v) for name, v in timed_t.items()}
        times[n_t] = {"steps_per_run": steps_t, "order": list(order), "gcells": timed_t,
                      "ms_per_step": {name: step_ms(g, n_t) for name, g in best.items()}}
        print(f"   {n_t}^2, {steps_t} steps a run: " + "; ".join(
            f"{name} {times[n_t]['ms_per_step'][name]:.5f} ms ({', '.join(f'{g:.3f}' for g in v)}"
            f" GCells/s)" for name, v in timed_t.items()))
        del ce_t, ch_t
        torch.cuda.empty_cache()
    done(t0)
    # free the FDTD fields before the FDFD phases read peak device memory
    for d in big.values():
        del d["fields"]
    del fields_t, Ez, Hx, Hy, kern, plain, k3_out, ce2, ch2, coef2, eps_d, mu_d
    torch.cuda.empty_cache()

    fdfd = fdfd_phases(dev)

    print(json.dumps({"kernels": [{
        "name": "fdtd_fused (K1)", "route": "cuda",
        "source": "fdtd2d_tpu_torch/ops/csrc/fdtd_fused.cu",
        "replaces": "fdtd2d_tpu/ops/pallas_fdtd.py:42",
        "launches": main_launches, "max_abs_err": abs_err,
        "ms": step_ms(kernel_gcells), "plain_ms": step_ms(plain_gcells),
        "ms_unit": "per leapfrog step at 2048x2048, float32 (3 launches)",
    }, {
        "name": "fdtd_ttiled (K2)", "route": "cuda",
        "source": "fdtd2d_tpu_torch/ops/csrc/fdtd_ttiled.cu",
        "replaces": "fdtd2d_tpu/ops/pallas_fdtd_ttiled.py:70",
        "launches": k2_main_launches, "max_abs_err": big[4096]["abs_err"],
        "ms": times[4096]["ms_per_step"]["K2"], "plain_ms": times[4096]["ms_per_step"]["plain"],
        "ms_unit": "per leapfrog step at 4096x4096, float32 (one launch per sweep of K steps)",
    }, {
        "name": "fdtd_blocked (K3, K2 at K=1)", "route": "cuda",
        "source": "fdtd2d_tpu_torch/ops/csrc/fdtd_ttiled.cu",
        "replaces": "fdtd2d_tpu/ops/pallas_fdtd_blocked.py:80",
        "launches": k3_main_launches, "max_abs_err": k3_abs,
        "ms": times[2048]["ms_per_step"]["K3"], "plain_ms": times[2048]["ms_per_step"]["plain"],
        "ms_unit": "per leapfrog step at 2048x2048, float32 (one launch a step)",
    }]}))
    print(json.dumps({"fdtd2048": {
        "kernel_gcells": timed["fused"], "plain_torch_gcells": timed["torch"],
        "steps_per_run": steps, "order": ["plain", "kernel", "kernel", "plain"],
        "card": info["name"], "power_limit": info["power_limit"],
        "edge_case_worst_rel_err": worst, "edge_case_least_cover": least_cover,
        "rel_err_2048_200": errs,
    }}))
    print(json.dumps({"ttiled": {
        "card": info["name"], "power_limit": info["power_limit"],
        "times": times, "k2_edge_case_worst_rel_err": k2_worst,
        "k3_edge_case_worst_rel_err": k3_worst,
        "edge_case_least_cover": min(k2_cover, k3_cover),
        "full_size": {n_b: {k: v for k, v in d.items() if k not in ("fields", "eps", "mu")}
                      for n_b, d in big.items()},
        "k3_2048_200": {"rel_err": k3_errs, "abs_err": k3_abs},
    }}))
    print(json.dumps({"fdfd": {"card": info["name"], "power_limit": info["power_limit"],
                               **fdfd}}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
