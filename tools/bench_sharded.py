"""The sharded FDTD path on the GPU: K2's block mode held to its plain
versions at small sizes, and the rollout at full size checked and timed
beside the single-device one.

    python tools/bench_sharded.py [--parity] [--cells 8192:2x2,8192:4x1,4096:4:8]

Every block of a mesh lives on the one card (``make_mesh(devices=["cuda:0"]
* n)``): the decomposition, the ghost cells, the halo exchange and one kernel
launch a block a sweep are all as on distinct cards, but no copy between two
cards is made and no scaling is measured. ``chip_smoke.py`` runs the same
functions as its sharded phases.

``--parity`` (:func:`block_parity`): 203x157 and 400x360 with seeded random
media and random states that reach every Mur band and corner, cut into 2x2,
1x4, 4x1 and 3x2 blocks; forced small tiles at 203x157, so that seams cross
bands, corners and block boundaries, the planner's tiles at 400x360 (interior
windows at ghost boundaries); thin blocks whose ghost cells hold a
neighbour's band (64 rows over 8, 60 over 6, 44x52 over 4x4); the source on
the corner where four blocks meet, inside a ghost region and outside all
blocks but one; 61 steps, no multiple of any K used. The float32 kernel is
held to the float64 plain step (<= 1e-5 relative), to its emulation run in
float64 on the same tiles (<= 1e-5) and to single-device K2 (expected equal
bit for bit, both using fdtd_step.cuh's register forms: the max abs
difference is printed, and more than 1e-5 relative fails). The launch counter
must advance by one a block a sweep.

``--cells N:RxC[:frames]`` (:func:`full_size`): the bench scene of bench.py's
fdtd rows at N^2 (512 steps at 8192^2, 2048 at 4096^2) through
``simulate_sharded(backend="auto")`` on an R x C mesh (``N:R`` is a 1D mesh
of R row blocks, the only kind that takes frames): every sweep of every
block counted as a kernel launch, fields finite and non-zero in the staggered
shapes, equal to single-device ``simulate(auto)`` within 1e-5 relative (the
max abs difference printed) and, on a short run, to the float64 plain step.
Then ms a step with CUDA events after a warm-up, in turns with the single
device (single, sharded, sharded, single), of the whole call and of its
steady state (the difference of two call lengths over the difference in
steps, which leaves out set-up), the host's time to enqueue a step (its clock
from the call's start to its return, before the card has finished), launches
and strip copies a sweep, the HBM
traffic of the blocks' plans with the exchange, and the peak device memory.

Prints one JSON line with the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
COVER = 1e-3  # least field in each Mur band and corner, relative to max |Ez|
DT, DX, FC = 5e-14, 1e-4, 30e9
Z0 = 376.73   # vacuum impedance: scales the random H to the random Ez
HBM_BYTES_S = 3.35e12  # H100 SXM at its 700 W limit (NVIDIA's data sheet)

# (grid, seed, mesh, K, tile, source); K and tile None take the planner's.
PARITY_CASES = (
    ((203, 157), 0, (2, 2), 7, (13, 16), (102, 79)),    # source where four blocks meet
    ((203, 157), 0, (1, 4), 3, (29, 20), (100, 41)),    # in block 0's ghost columns
    ((203, 157), 0, (4, 1), 8, (17, 40), (10, 10)),     # outside three blocks' arrays
    ((203, 157), 0, (3, 2), 5, (17, 20), (199, 153)),
    ((400, 360), 4, (2, 2), None, None, (200, 180)),
    ((400, 360), 4, (1, 4), None, None, (200, 92)),
    ((400, 360), 4, (4, 1), None, None, (395, 355)),
    ((400, 360), 4, (3, 2), None, None, (130, 179)),
    ((64, 48), 7, (8, 1), 8, (8, 24), (30, 20)),        # thin: block 1's ghosts hold the top band
    ((60, 48), 7, (6, 1), 8, (10, 48), (11, 3)),        # thin: arrays pulled to the edge
    ((44, 52), 7, (4, 4), 8, (11, 13), (22, 26)),       # thin both ways: ghost corners
)
PARITY_STEPS = 61


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((x.double() - ref).abs().max() / ref.abs().max())


def boundary_cover(Ez: torch.Tensor, b: int) -> float:
    """Smallest max |Ez| over the four Mur bands and the four corners,
    relative to max |Ez| over the grid."""
    parts = (Ez[b:-b, :b], Ez[b:-b, -b:], Ez[:b, b:-b], Ez[-b:, b:-b],
             Ez[:b, :b], Ez[:b, -b:], Ez[-b:, :b], Ez[-b:, -b:])
    return float(min(p.abs().max() for p in parts) / Ez.abs().max())


def seeded_scene(rows: int, cols: int, seed: int, constants):
    """A random medium (eps 1..4, eps[0, 0] = 1) and a random state scaled
    so that H matches Ez, float32-rounded; the recipe of chip_smoke.py's
    phases 3 and 6, whose 203x157 (seed 0) and 400x360 (seed 4) scenes these
    are."""
    rng = np.random.default_rng(seed)
    eps = constants.EPSILON_0 * (1.0 + 3.0 * rng.random((rows, cols)))
    eps[0, 0] = constants.EPSILON_0
    mu = np.full((rows, cols), constants.MU_0)
    state = tuple((rng.standard_normal(shape) / scale).astype(np.float32)
                  for shape, scale in (((rows, cols), 1.0), ((rows, cols - 1), Z0),
                                       ((rows - 1, cols), Z0)))
    return eps.astype(np.float32), mu.astype(np.float32), state


def bench_scene(N: int, constants):
    """The bench scene of bench.py's fdtd rows: a 4x dielectric block."""
    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    eps[N // 4 : N // 2, N // 4 : N // 3] *= 4.0
    mu = np.full((N, N), constants.MU_0, np.float32)
    return eps, mu


def card_mesh(shape, dev):
    """A mesh whose every entry is the one card."""
    from fdtd2d_tpu_torch.parallel import make_mesh

    return make_mesh(shape, devices=[dev] * math.prod(shape))


def block_parity(dev, log=print) -> dict:
    """Hold K2's block mode to its plain versions on the cases of
    PARITY_CASES; raises on a failure. Returns the worst relative errors,
    the max abs difference to single-device K2, the least band and corner
    coverage and the least count of interior tiles over the planner's
    cases."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate
    from fdtd2d_tpu_torch.fdtd.step import MUR_BAND
    from fdtd2d_tpu_torch.ops import fdtd_ttiled
    from fdtd2d_tpu_torch.parallel import fdtd_sharded, mesh_blocks
    from fdtd2d_tpu_torch.utils import trace

    worst = {"float64 plain": 0.0, "float64 emulation": 0.0, "single-device K2": 0.0}
    single_abs, least_cover, least_interior = 0.0, 1.0, None
    for (rows, cols), seed, shape, K, tile, src in PARITY_CASES:
        eps, mu, state = seeded_scene(rows, cols, seed, constants)
        K, G, TH, TW = fdtd_sharded._resolve_plan(rows, cols, *shape, K, tile)
        blocks = [b for row in mesh_blocks(rows, cols, *shape, G) for b in row]
        interior = sum(fdtd_ttiled.interior_tiles(rows, cols, K, TH, TW, b) for b in blocks)
        if tile is None:
            least_interior = interior if least_interior is None else min(least_interior, interior)
            if not interior > 0:
                raise AssertionError(f"{(rows, cols)} over {shape}: no interior tile")
        for kind in ("ricker", "sinusoidal"):
            case = (f"{rows}x{cols} over {shape[0]}x{shape[1]} blocks, K={K}, tiles {TH}x{TW} "
                    f"({interior} interior), source {src}, {kind}")
            cfg = FDTDConfig(dt=DT, dx=DX, nsteps=PARITY_STEPS, source_xy=src, source_fc=FC,
                             source_kind=kind, backend="ttiled", device=str(dev))
            cfg64 = dataclasses.replace(cfg, backend="torch", dtype=torch.float64)
            mesh = card_mesh(shape, dev)
            before = trace.counters()
            kern, _ = fdtd_sharded.simulate_sharded_ttiled(eps, mu, cfg, mesh, state=state,
                                                           K=K, tile=(TH, TW))
            torch.cuda.synchronize()
            counted = (trace.delta(before, "fdtd.kernels.k2_block_sweeps"),
                       trace.delta(before, "fdtd.kernels.k2_sweeps"))
            sweeps = -(-PARITY_STEPS // K)
            if counted != (sweeps * len(blocks), 0):
                raise AssertionError(f"{case}: counted {counted} launches, expected "
                                     f"{sweeps * len(blocks)} in block mode and 0 others")
            plain, _ = simulate(eps, mu, cfg64, state=state)
            emu, _ = fdtd_sharded._rollout(eps, mu, cfg64, mesh, state, K, G, (TH, TW),
                                           by_sweeps=True, kernel=False)
            single, _ = simulate(eps, mu, cfg, state=state)
            torch.cuda.synchronize()
            cover = boundary_cover(plain[0], MUR_BAND)
            least_cover = min(least_cover, cover)
            if not cover >= COVER:
                raise AssertionError(f"{case}: a Mur band or corner holds only {cover:.2e} of "
                                     f"max |Ez| (< {COVER})")
            errs = dict.fromkeys(worst, 0.0)
            for name, k, p, e, s in zip(("Ez", "Hx", "Hy"), kern, plain, emu, single):
                if k.shape != p.shape:
                    raise AssertionError(f"{name}: shape {tuple(k.shape)} != {tuple(p.shape)}")
                for against, ref in (("float64 plain", p), ("float64 emulation", e),
                                     ("single-device K2", s)):
                    err = rel_err(k, ref)
                    errs[against] = max(errs[against], err)
                    if not err <= TOL:
                        raise AssertionError(f"{name}: relative error {err:.3e} against the "
                                             f"{against} > {TOL} ({case})")
                single_abs = max(single_abs, float((k - s).abs().max()))
            for against, err in errs.items():
                worst[against] = max(worst[against], err)
            log(f"   {case}: ok, " + ", ".join(f"{v:.3e} vs the {k}" for k, v in errs.items()))
    return {"worst_rel_err": worst, "max_abs_diff_to_single_device": single_abs,
            "least_cover": least_cover, "least_interior_tiles": least_interior,
            "cases": 2 * len(PARITY_CASES), "steps": PARITY_STEPS}


def plan_traffic_ms(N: int, M: int, grid_shape, plan) -> dict:
    """ms a step of the HBM traffic of a sharded sweep at 3.35 TB/s, on
    ``grid_shape`` = (row blocks, column blocks): each
    block reads five fields over every window and writes three over its
    owned cells; each strip of an exchange is read and written, three
    fields. Also the share of ghost cells in the blocks' arrays."""
    from fdtd2d_tpu_torch.ops import fdtd_ttiled
    from fdtd2d_tpu_torch.parallel import fdtd_sharded, mesh_blocks

    K, G, TH, TW = plan
    grid = mesh_blocks(N, M, *grid_shape, G)
    blocks = [b for row in grid for b in row]
    owned = [(b.r1 - b.r0) * (b.c1 - b.c0) for b in blocks]
    stepped = sum((fdtd_ttiled.redundancy(N, M, K, TH, TW, b) + 1) * o
                  for b, o in zip(blocks, owned))
    sweep_bytes = (5 * stepped + 3 * sum(owned)) * 4
    strips = fdtd_sharded.exchange_plan(grid)
    strip_cells = sum((dsl[0].stop - dsl[0].start) * (dsl[1].stop - dsl[1].start)
                      for _, dsl, _, _ in strips)
    exchange_bytes = 2 * 3 * strip_cells * 4
    arrays = sum(b.shape[0] * b.shape[1] for b in blocks)
    return {"plan_bound_ms": (sweep_bytes + exchange_bytes) / K / HBM_BYTES_S * 1e3,
            "sweep_bytes": sweep_bytes, "exchange_bytes": exchange_bytes,
            "strip_copies_a_sweep": len(strips), "ghost_share": 1 - sum(owned) / arrays}


def call_ms(fn):
    """(ms on the card, ms on the host) of one call of ``fn`` after one
    warm-up call: CUDA events around it, and the host's clock from its
    start to its return, before the card has finished. A host time near the
    card's says that the host's launches, not the kernels, set the pace."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end), host


def full_size(dev, N: int, shape, nsteps: int, nframes: int = 0, parity_steps: int = 50,
              log=print) -> dict:
    """One cell: the N^2 bench scene through ``simulate_sharded(auto)`` on a
    mesh of ``shape`` blocks of the one card, checked and timed as the
    module docstring says."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, resolve_backend, simulate
    from fdtd2d_tpu_torch.parallel import fdtd_sharded, plan_sharded_ttiled_2d, simulate_sharded
    from fdtd2d_tpu_torch.utils import trace

    mesh = card_mesh(shape, dev)
    grid_shape = mesh.grid_shape
    what = f"{N}^2 over {grid_shape[0]}x{grid_shape[1]} blocks"
    eps, mu = (torch.tensor(a, device=dev) for a in bench_scene(N, constants))
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=nsteps, source_xy=(N // 2, N // 2), source_fc=FC,
                     nframes=nframes, backend="auto", device=str(dev))
    plan = plan_sharded_ttiled_2d(N, N, *grid_shape)
    if plan is None:
        raise AssertionError(f"{what}: the planner admits no decomposition")
    K = plan[0]
    n_blocks = math.prod(shape)
    traffic = plan_traffic_ms(N, N, grid_shape, plan)
    if resolve_backend("auto", (N, N), dev, nsteps // max(nframes, 1)) != "ttiled":
        raise AssertionError(f"single-device 'auto' does not take K2 at {N}^2")

    # -- the main path, counted -----------------------------------------------------
    before = trace.counters()
    torch.cuda.reset_peak_memory_stats(dev)
    fields, snaps = simulate_sharded(eps, mu, cfg, mesh)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    sweeps = -(-nsteps // K)
    counted = tuple(trace.delta(before, f"fdtd.kernels.{k}")
                    for k in ("k2_block_sweeps", "k2_sweeps", "k1"))
    if counted != (sweeps * n_blocks, 0, 0):
        raise AssertionError(f"{what}: counted {counted} launches (block mode, single-device "
                             f"K2, K1), expected {sweeps * n_blocks}, 0, 0")
    copies = fdtd_sharded.exchange_copies
    if copies != sweeps * traffic["strip_copies_a_sweep"]:
        raise AssertionError(f"{what}: {copies} strip copies in {sweeps} sweeps")
    Ez, Hx, Hy = fields
    if tuple(Hx.shape) != (N, N - 1) or tuple(Hy.shape) != (N - 1, N):
        raise AssertionError(f"{what}: staggered shapes not kept")
    if nframes and (snaps is None or tuple(snaps.shape) != (nframes, N, N)):
        raise AssertionError(f"{what}: snapshots {None if snaps is None else tuple(snaps.shape)}")
    for name, t in (("Ez", Ez), ("Hx", Hx), ("Hy", Hy)) + ((("snapshots", snaps),)
                                                           if nframes else ()):
        if not bool(torch.isfinite(t).all()) or float(t.abs().max()) == 0.0:
            raise AssertionError(f"{what}: {name} is not finite and non-zero")

    # -- against the single device, and float64 on a short run ----------------------
    single, single_snaps = simulate(eps, mu, cfg)
    torch.cuda.synchronize()
    named = list(zip(("Ez", "Hx", "Hy"), fields, single))
    if nframes:
        named.append(("snapshots", snaps, single_snaps))
    rel = {name: rel_err(a, b) for name, a, b in named}
    abs_diff = max(float((a - b).abs().max()) for _, a, b in named)
    if not all(e <= TOL for e in rel.values()):
        raise AssertionError(f"{what}: against single-device K2: {rel} exceed {TOL}")
    del single, single_snaps, snaps, named, fields, Ez, Hx, Hy
    short = dataclasses.replace(cfg, nsteps=parity_steps, nframes=0)
    kern, _ = simulate_sharded(eps, mu, short, mesh)
    plain64, _ = simulate(eps.double(), mu.double(),
                          dataclasses.replace(short, backend="torch", dtype=torch.float64))
    torch.cuda.synchronize()
    rel64 = {name: rel_err(k, p) for name, k, p in zip(("Ez", "Hx", "Hy"), kern, plain64)}
    abs64 = max(float((k.double() - p).abs().max()) for k, p in zip(kern, plain64))
    if not all(e <= TOL for e in rel64.values()):
        raise AssertionError(f"{what}: {parity_steps} steps against float64: {rel64} > {TOL}")
    del kern, plain64
    torch.cuda.empty_cache()

    # -- time, in turns with the single device ----------------------------------------
    fewer = dataclasses.replace(cfg, nsteps=nsteps // 4, nframes=nframes // 4 if nframes else 0)
    runs = {"single": lambda c: simulate(eps, mu, c), "sharded": lambda c: simulate_sharded(
        eps, mu, c, mesh)}
    timed = {name: {"call_ms": [], "call_host_ms": [], "fewer_ms": []} for name in runs}
    for name in ("single", "sharded", "sharded", "single"):
        on_card, on_host = call_ms(lambda: runs[name](cfg))
        timed[name]["call_ms"].append(on_card)
        timed[name]["call_host_ms"].append(on_host)
        timed[name]["fewer_ms"].append(call_ms(lambda: runs[name](fewer))[0])
    out = {"N": N, "mesh": list(shape), "plan": list(plan), "nsteps": nsteps, "nframes": nframes,
           "launches": counted[0], "launches_a_sweep": n_blocks, "strip_copies": copies,
           **traffic, "peak_gb": peak_gb, "rel_diff_to_single_device": rel,
           "max_abs_diff_to_single_device": abs_diff, "rel_err_float64": rel64,
           "max_abs_err_float64": abs64, "parity_steps": parity_steps, "timed": timed}
    for name, t in timed.items():
        call, few = min(t["call_ms"]), min(t["fewer_ms"])
        out[f"{name}_ms_per_step"] = call / nsteps
        out[f"{name}_steady_ms_per_step"] = (call - few) / (nsteps - fewer.nsteps)
        out[f"{name}_host_ms_per_step"] = min(t["call_host_ms"]) / nsteps
    out["share_of_plan_bound"] = traffic["plan_bound_ms"] / out["sharded_steady_ms_per_step"]
    log(f"   {what}, plan K={K} G={plan[1]} tiles {plan[2]}x{plan[3]}, {nsteps} steps"
        f"{f' in {nframes} frames' if nframes else ''}: {counted[0]} launches ({n_blocks} a "
        f"sweep), {traffic['strip_copies_a_sweep']} strip copies a sweep, ghost cells "
        f"{traffic['ghost_share']:.4f} of the arrays, peak {peak_gb:.3f} GB; against "
        f"single-device K2: max abs difference {abs_diff:.3e} (relative " +
        ", ".join(f"{k} {v:.3e}" for k, v in rel.items()) + f"); {parity_steps} steps vs "
        f"float64: " + ", ".join(f"{k} {v:.3e}" for k, v in rel64.items()))
    log(f"   {what}: ms a step, whole call / steady state: sharded "
        f"{out['sharded_ms_per_step']:.5f} / {out['sharded_steady_ms_per_step']:.5f}, single "
        f"device {out['single_ms_per_step']:.5f} / {out['single_steady_ms_per_step']:.5f}; "
        f"host time to enqueue a step: sharded {out['sharded_host_ms_per_step']:.5f}, single "
        f"device {out['single_host_ms_per_step']:.5f}; "
        f"{out['share_of_plan_bound']:.3f} of its plans' {traffic['plan_bound_ms']:.5f} ms of "
        f"HBM traffic (exchange {traffic['exchange_bytes'] / 1e6:.2f} MB of "
        f"{(traffic['sweep_bytes'] + traffic['exchange_bytes']) / 1e6:.1f} MB a sweep)")
    return out


def plain_engine_ms(dev, N: int, shape, nsteps: int = 16) -> float:
    """ms a step of the block mode's plain version at full size: the same
    decomposition and exchange with the plain step on each block's array
    (``simulate_sharded(backend="torch")``), float32, one timed call."""
    from fdtd2d_tpu_torch import constants
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig
    from fdtd2d_tpu_torch.parallel import simulate_sharded

    eps, mu = (torch.tensor(a, device=dev) for a in bench_scene(N, constants))
    cfg = FDTDConfig(dt=DT, dx=DX, nsteps=nsteps, source_xy=(N // 2, N // 2), source_fc=FC,
                     backend="torch", device=str(dev))
    mesh = card_mesh(shape, dev)
    return call_ms(lambda: simulate_sharded(eps, mu, cfg, mesh))[0] / nsteps


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parity", action="store_true")
    parser.add_argument("--cells", default="8192:2x2,8192:4x1,4096:4:8")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sharded: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fdtd2d_tpu_torch.utils.metrics import device_info

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    out = {}
    if args.parity:
        out["parity"] = block_parity(dev)
        print(f"block-mode parity: {out['parity']}", flush=True)
    cells = []
    for cell in filter(None, args.cells.split(",")):
        n, mesh, *frames = cell.split(":")
        shape = tuple(int(d) for d in mesh.split("x"))
        cells.append(full_size(dev, int(n), shape, 512 if int(n) >= 8192 else 2048,
                               int(frames[0]) if frames else 0))
        torch.cuda.empty_cache()
    out["cells"] = cells
    info = device_info()
    out["card"], out["power_limit"] = info["name"], info["power_limit"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
