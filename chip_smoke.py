"""Smoke run of the PyTorch/CUDA port (fdtd2d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: a CUDA device is required (there is no CPU fallback); prints the
   card's name and power limit as nvidia-smi reports them.
2. Build: compiles the K1 kernel from fdtd2d_tpu_torch/ops/csrc/ with nvcc.
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

Tolerance: 1e-5 relative (max |kernel - plain| / max |plain|), the bound of
the float64 oracle tests (tests/test_fdtd_oracle.py). The kernel and the
plain path differ in rounding only: nvcc contracts a + b*c into FMA and
CUDA's expf differs from the plain path's exp in the last bits, both far
inside that bound at float32.

Before its last line the script prints one JSON object with the kernel's
launches, error and times, one with the GCells/s of both paths, and the
nvidia-smi line; its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

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
    from fdtd2d_tpu_torch.ops import _build, fdtd_fused
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
    t0 = phase("2. build K1 with nvcc")
    with Timer() as build_timer:
        lib_path = _build.build()
        _build.load()
    log = (lib_path.parent / "build.log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line:
            print(f"   ptxas: {line.strip()}")
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
    if snaps is None or tuple(snaps.shape) != (10, N, N):
        raise AssertionError(f"snapshots: {None if snaps is None else tuple(snaps.shape)}")
    for name, t in (("Ez", Ez), ("Hx", Hx), ("Hy", Hy), ("snapshots", snaps)):
        if not bool(torch.isfinite(t).all()) or float(t.abs().max()) == 0.0:
            raise AssertionError(f"{name} is not finite and non-zero")
    if tuple(Hx.shape) != (N, N - 1) or tuple(Hy.shape) != (N - 1, N):
        raise AssertionError("staggered shapes not kept")
    print(f"   {main_launches} K1 launches; max |Ez| = {float(Ez.abs().max()):.4e}")

    short = FDTDConfig(dt=DT, dx=DX, nsteps=200, source_xy=(N // 2, N // 2),
                       source_fc=FC, backend="auto", device="cuda")
    plain_cfg = FDTDConfig(dt=DT, dx=DX, nsteps=200, source_xy=(N // 2, N // 2),
                           source_fc=FC, backend="torch", device="cuda",
                           dtype=torch.float64)
    kern, _ = simulate(eps, mu, short)
    plain, _ = simulate(eps.astype(np.float64), mu.astype(np.float64), plain_cfg)
    torch.cuda.synchronize()
    errs = {name: rel_err(k, p) for name, k, p in zip(("Ez", "Hx", "Hy"), kern, plain)}
    abs_err = max(max_abs_err(k, p) for k, p in zip(kern, plain))
    if not all(e <= TOL for e in errs.values()):
        raise AssertionError(f"2048^2 200-step relative errors {errs} exceed {TOL}")
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

    def step_ms(gcells):
        return N * N / (gcells * 1e9) * 1e3

    print(json.dumps({"kernels": [{
        "name": "fdtd_fused (K1)", "route": "cuda",
        "source": "fdtd2d_tpu_torch/ops/csrc/fdtd_fused.cu",
        "replaces": "fdtd2d_tpu/ops/pallas_fdtd.py:42",
        "launches": main_launches, "max_abs_err": abs_err,
        "ms": step_ms(kernel_gcells), "plain_ms": step_ms(plain_gcells),
        "ms_unit": "per leapfrog step at 2048x2048, float32 (3 launches)",
    }]}))
    print(json.dumps({"fdtd2048": {
        "kernel_gcells": timed["fused"], "plain_torch_gcells": timed["torch"],
        "steps_per_run": steps, "order": ["plain", "kernel", "kernel", "plain"],
        "card": info["name"], "power_limit": info["power_limit"],
        "edge_case_worst_rel_err": worst, "edge_case_least_cover": least_cover,
        "rel_err_2048_200": errs,
    }}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
