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

Tolerance: 1e-5 relative (max |kernel - plain| / max |plain|), the bound of
the float64 oracle tests (tests/test_fdtd_oracle.py). The kernel and the
plain path differ in rounding only: nvcc contracts a + b*c into FMA and
CUDA's expf differs from the plain path's exp in the last bits, both far
inside that bound at float32.

Before its last line the script prints one JSON object with each kernel's
launches (counted in its main-path run of phase 4 or 8), error and times, one
with the GCells/s of phase 5, one with the times and errors of phases 6-9,
and the nvidia-smi line; its last line is
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
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
