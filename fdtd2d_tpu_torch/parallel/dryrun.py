"""The port's multi-device dry run: every sharded leg once, each held to the
single-device call on the same inputs.

Counterpart of ``__graft_entry__.dryrun_multichip``, stage for stage (1, 2,
3, 4, 4b, 4b', 4c-4e, 4f, 5, 6). That one runs each stage and asserts
nothing; here each stage asserts finite fields and parity with the
single-device path within a bound of its own, printed with the error. Stage
4f (the sharded time domain at 0.5 transits, which stalls by design in two
rounds) is held to the parity of one application, not to a residual. The
meshes are laid over ``devices`` (which may name one device several times:
``["cpu"] * 8`` in the tests, ``["cuda:0"] * 8`` on one card).

Stage 1 runs ``simulate_sharded(backend="auto")``: on CUDA entries that is
K2's block mode, which raises where its plan does not admit the grid, so
the stage's grid is the smallest square of 64, 128, ... that the mesh's plan
admits. Stages 4 and 4f use the plain step (backend "torch") and the
time-domain step, as the JAX stages do.
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Sequence

import numpy as np
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.parallel.mesh import make_mesh


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.to(got.device)
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale else 1.0)


def _check(results: dict, name: str, err: float, bound: float, t0: float, *fields):
    """Record and print a stage; raise unless every field is finite and the
    error within the bound."""
    finite = all(bool(torch.isfinite(torch.view_as_real(f) if f.is_complex() else f).all())
                 for f in fields)
    secs = time.perf_counter() - t0
    results[name] = {"err": err, "bound": bound, "seconds": secs}
    print(f"   dryrun {name}: {err:.3e} from the single-device call (bound {bound:.0e}), "
          f"{secs:.2f} s", flush=True)
    if not (finite and err <= bound):
        raise AssertionError(f"dryrun stage {name}: error {err:.3e} (bound {bound:.0e}), "
                             f"finite {finite}")


def _square_admitted(Dr: int, Dc: int) -> int:
    from fdtd2d_tpu_torch.parallel.fdtd_sharded import plan_sharded_ttiled_2d

    N = 64
    while plan_sharded_ttiled_2d(N, N, Dr, Dc) is None:
        N *= 2
    return N


def dryrun_multichip(devices: Sequence, *, workdir: str | None = None,
                     rank_timeout: float = 600.0) -> dict:
    """Run every stage on meshes of ``devices`` (at least 4 entries, as the
    JAX stages' sublattice meshes need) and return ``{stage: {"err",
    "bound", "seconds"}}``; raises ``AssertionError`` on the first stage out
    of its bound. ``workdir``: where stage 6's ranks meet (a temporary
    directory when None)."""
    from fdtd2d_tpu_torch.fdfd.solver import solve_fdfd
    from fdtd2d_tpu_torch.fdfd.tiled import TiledSolver
    from fdtd2d_tpu_torch.fdfd.timedomain import TimeDomainSolver
    from fdtd2d_tpu_torch.fdtd.simulate import FDTDConfig, simulate, simulate_batched
    from fdtd2d_tpu_torch.ops.helmholtz import make_operator
    from fdtd2d_tpu_torch.parallel import (factor_sharded, shard_operator, simulate_sharded,
                                           simulate_sharded_ttiled, simulate_sharded_ttiled_2d,
                                           solve_factored_sharded, solve_fdfd_sharded, train_dp)
    from fdtd2d_tpu_torch.parallel.tiled_sharded import run_fdfd_tiled_sharded
    from fdtd2d_tpu_torch.parallel.timedomain_sharded import TimeDomainSolverSharded

    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n < 4:
        raise ValueError(f"the dry run needs at least 4 mesh entries, got {n}")
    first = devices[0]
    out = {}
    N = 64
    eps = np.full((N, N), constants.EPSILON_0, np.float32)
    mu = np.full((N, N), constants.MU_0, np.float32)

    # 1) spatially sharded FDTD rollout over a 2D mesh (auto: K2's block mode
    # where its plan admits the grid), against the single-device plain step
    t0 = time.perf_counter()
    mesh2d = make_mesh(devices=devices)
    N1 = _square_admitted(*mesh2d.grid_shape)
    e1 = np.full((N1, N1), constants.EPSILON_0, np.float32)
    m1 = np.full((N1, N1), constants.MU_0, np.float32)
    cfg = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=4, source_xy=(N1 // 2, N1 // 2), source_fc=30e9,
                     device=str(first))
    (Ez, _, _), _ = simulate_sharded(e1, m1, cfg, mesh2d)
    (want, _, _), _ = simulate(e1, m1, dataclasses.replace(cfg, backend="torch"))
    _check(out, f"1 simulate_sharded {N1}^2 on {mesh2d.grid_shape}", _rel(Ez, want), 1e-5, t0, Ez)

    # 2) spatially sharded FDFD Krylov solve (halo strips + dots summed by block)
    t0 = time.perf_counter()
    op = make_operator(eps, mu, 1e-3, 1e-3, 17e9, pml_thickness=8, device=first)
    src = np.zeros((N, N), np.float32)
    src[N // 2, N // 2] = 1.0
    b = torch.tensor(-1j * 17e9 * src, dtype=torch.complex64, device=first)
    got = solve_fdfd_sharded(op, b, mesh2d, tol=1e-4, maxiter=30)
    want = solve_fdfd(op, b, tol=1e-4, maxiter=30)
    _check(out, "2 solve_fdfd_sharded", _rel(got.x, want.x), 1e-4, t0, got.x)

    # 3) the halo-exchange matvec on a 1D and a 2D mesh
    t0 = time.perf_counter()
    x = torch.ones((N, N), dtype=torch.complex64, device=first)
    mesh1d = make_mesh((n,), axis_names=("x",), devices=devices)
    errs = []
    for mesh in (mesh1d, mesh2d):
        sop = shard_operator(op, mesh)
        errs.append(_rel(sop.layout.gather(sop.apply(sop.layout.scatter(x))), op.apply(x)))
    _check(out, "3 sharded_matvec_shardmap 1D, 2D", max(errs), 1e-6, t0, x)

    # 4) dp x sp: a batch of scenes split over 'dp', each scene's rows over
    # 'sp' (the halo-exchange rollout with the plain step), held to
    # simulate_batched with per-scene sources
    t0 = time.perf_counter()
    dp = 2 if n % 2 == 0 else 1
    sp = n // dp
    grid = np.array(devices, dtype=object).reshape(dp, sp)
    B = dp * 2
    eps_b = np.stack([eps * (1.0 + k) for k in range(B)])
    mu_b = np.stack([mu] * B)
    sources = [(N // 2 + k, N // 3 + 2 * k) for k in range(B)]
    cfg4 = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=12, source_xy=sources[0], source_fc=30e9,
                      backend="torch", device=str(first))
    (want, _, _), _ = simulate_batched(eps_b, mu_b, cfg4, sources_xy=sources)
    errs = []
    for k in range(B):
        mesh_sp = make_mesh((sp,), axis_names=("sp",), devices=list(grid[k // 2]))
        (ez, _, _), _ = simulate_sharded(eps_b[k], mu_b[k],
                                         dataclasses.replace(cfg4, source_xy=sources[k]), mesh_sp)
        errs.append(_rel(ez, want[k]))
    _check(out, f"4 dp x sp ({dp} x {sp}) plain step vs simulate_batched", max(errs), 1e-6, t0,
           want)

    # 4b) row-sharded FDTD with K2's block mode (its emulation on CPU entries)
    t0 = time.perf_counter()
    Nt = 128
    et = np.full((Nt, Nt), constants.EPSILON_0, np.float32)
    mt = np.full((Nt, Nt), constants.MU_0, np.float32)
    cfg_t = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=10, source_xy=(Nt // 2, Nt // 2),
                       source_fc=30e9, device=str(first))
    (ezt, _, _), _ = simulate_sharded_ttiled(et, mt, cfg_t, mesh1d)
    (want, _, _), _ = simulate(et, mt, dataclasses.replace(cfg_t, backend="torch"))
    _check(out, f"4b simulate_sharded_ttiled {Nt}^2 on ({n},)", _rel(ezt, want), 1e-5, t0, ezt)

    # 4b') 2D mesh at kernel speed, source on a block corner
    t0 = time.perf_counter()
    rows2 = max(n // 4, 1)
    mesh_2d = make_mesh((rows2, 4), axis_names=("r", "c"), devices=devices)
    N2, M2 = 32 * rows2, 512
    e2 = np.full((N2, M2), constants.EPSILON_0, np.float32)
    m2 = np.full((N2, M2), constants.MU_0, np.float32)
    cfg_2 = FDTDConfig(dt=5e-14, dx=1e-4, nsteps=10, source_xy=(N2 // 2, M2 // 2),
                       source_fc=30e9, device=str(first))
    (ez2, _, _), _ = simulate_sharded_ttiled_2d(e2, m2, cfg_2, mesh_2d)
    (want, _, _), _ = simulate(e2, m2, dataclasses.replace(cfg_2, backend="torch"))
    _check(out, f"4b' simulate_sharded_ttiled_2d {N2}x{M2} on ({rows2}, 4)", _rel(ez2, want),
           1e-5, t0, ez2)

    # 4c-4e) the sublattice-sharded direct solve (stored, checkpointed,
    # compressed) on 4 entries, against a mesh of one entry (the stacked
    # single-device path), in complex128
    op128 = make_operator(eps.astype(np.float64), mu.astype(np.float64), 1e-3, 1e-3, 17e9,
                          pml_thickness=8, dtype=torch.complex128, device=first)
    b128 = b.to(torch.complex128)
    mesh_s = make_mesh((4,), axis_names=("s",), devices=devices[:4])
    mesh_one = make_mesh((1,), axis_names=("s",), devices=devices[:1])
    for name, kw in (("4c stored", {}), ("4d checkpointed", dict(checkpointed=True, stride=8)),
                     ("4e compressed", dict(compressed=True, rank=8, leaf=8))):
        t0 = time.perf_counter()
        got = solve_factored_sharded(factor_sharded(op128, mesh_s, **kw), b128)
        want = solve_factored_sharded(factor_sharded(op128, mesh_one, **kw), b128)
        _check(out, f"{name} factor_sharded", _rel(got, want), 1e-6, t0, got)

    # 4f) the sharded time domain: sublattice x column axes, one application
    t0 = time.perf_counter()
    shape_td = (4, n // 4) if n % 4 == 0 else (1, n)
    mesh_td = make_mesh(shape_td, axis_names=("sub", "c"), devices=devices)
    td_kw = dict(pml_thickness=8, transits=0.5, device=first)
    td = TimeDomainSolverSharded(eps, mu, 1e-3, 1e-3, 30e9, mesh_td,
                                 sub_axis="sub" if shape_td[0] > 1 else None, col_axis="c",
                                 **td_kw)
    unit = torch.tensor(src, dtype=torch.complex64, device=first)
    got = td.precondition(unit)
    want = TimeDomainSolver(eps, mu, 1e-3, 1e-3, 30e9, **td_kw).precondition(unit)
    _check(out, f"4f TimeDomainSolverSharded on {shape_td}, one application", _rel(got, want),
           1e-5, t0, got)

    # 5) the patch-sharded tiled Schwarz solve, against the single-device
    # two-level solve with the patch level forced on
    t0 = time.perf_counter()
    mesh_p = make_mesh((n,), axis_names=("p",), devices=devices)
    tkw = dict(patch_size=24, padding=12, pml_thickness=6, global_pml_thickness=8,
               inner_iters=4)
    sol, _ = run_fdfd_tiled_sharded(eps, mu, 1e-3, 1e-3, 17e9, src, mesh_p, solver_tol=1e-2,
                                    solver_maxiter=4, refine_target=None, **tkw)
    want, _ = TiledSolver(eps, mu, 1e-3, 1e-3, 17e9, outer_restart=30, device=first,
                          **tkw).solve(src, solver_tol=1e-2, solver_maxiter=4,
                                       refine_target=None, adaptive=False)
    _check(out, f"5 run_fdfd_tiled_sharded on ({n},)", _rel(sol, want), 1e-5, t0, sol)

    # 6) the data-parallel train step: two ranks (nccl on two cards, else
    # gloo), float64, held to the single-device step
    t0 = time.perf_counter()
    pair = [str(d) for d in devices[:2]]
    spec = dict(model=dict(channels=(4, 8, 16), bottleneck=32, time_embed_dim=32),
                dtype=torch.float64, seed=0, steps=2, batch=train_dp.random_batch(4, 32),
                recipe={}, devices=pair)
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        ranks = train_dp.train_ranks([spec], d, timeout=rank_timeout)[0]
    ref = train_dp.reference_steps(spec, first)
    err = max(max(train_dp.max_param_diff(r["params"], ref["params"]),
                  max(abs(a - c) for a, c in zip(r["losses"], ref["losses"]))) for r in ranks)
    _check(out, f"6 train_step_dp on {pair} ({train_dp.backend_for(pair)})", err, 1e-10, t0,
           torch.tensor(ranks[0]["losses"]))
    return out


if __name__ == "__main__":
    import sys

    # python -m fdtd2d_tpu_torch.parallel.dryrun [device ...] (default: 8
    # entries of cuda:0)
    dryrun_multichip(sys.argv[1:] or ["cuda:0"] * 8)
    print("dryrun ok")
