"""Command-line entry point of the port (the ``fdtd``, ``fdfd``, ``tiled``
and ``invdes`` subcommands so far):

    python -m fdtd2d_tpu_torch.cli fdtd --size 2048 --steps 2000 --device cuda
    fdtd2d-torch fdtd --size 200 --steps 1000 [--structure img.png] [--video out.mp4]
    fdtd2d-torch fdfd --size 512 --omega 17e9 --solver direct|krylov|timedomain [--out Ez.png]
    fdtd2d-torch tiled --size 512 --mode krylov|additive|multiplicative [--plot-patches p.png]
    fdtd2d-torch invdes --size 250 --steps 100 --freqs 10 [--decade] [--out resp.png]

Flags and printed lines are those of ``fdtd2d fdtd``, ``fdtd2d fdfd``,
``fdtd2d tiled`` and ``fdtd2d invdes`` (fdtd2d_tpu/cli.py), plus
``--device``. ``--out ""`` skips the plot.
``--backend`` takes the port's names and the JAX CLI's: ``jax`` is
``torch`` (the plain step) and ``pallas`` is ``fused`` (K1).
"""

from __future__ import annotations

import argparse
import sys

# the JAX CLI's names for the port's backends
BACKEND_ALIASES = {"jax": "torch", "pallas": "fused"}


def cmd_fdtd(args):
    from fdtd2d_tpu_torch.core.grid import Scene
    from fdtd2d_tpu_torch.core.guards import check_courant
    from fdtd2d_tpu_torch.fdtd.simulate import simulate, FDTDConfig
    from fdtd2d_tpu_torch.viz.render import render_video

    scene = Scene.from_image(args.structure, args.size, args.size, dx=args.dx,
                             device=args.device)
    eps, mu = scene.eps.cpu().numpy(), scene.mu.cpu().numpy()
    courant = check_courant(eps, mu, args.dt, scene.dx)
    print(f"courant number: {courant:.4f}")
    cfg = FDTDConfig(dt=args.dt, dx=scene.dx, nsteps=args.steps,
                     source_xy=(args.size // 2, args.size // 2),
                     source_fc=args.fc, nframes=args.frames,
                     backend=BACKEND_ALIASES.get(args.backend, args.backend),
                     device=args.device)
    (Ez, _, _), snaps = simulate(scene.eps, scene.mu, cfg)
    print(f"max |Ez| = {float(Ez.abs().max()):.4e}")
    if args.video and snaps is not None:
        out = render_video(snaps.cpu().numpy(), eps, args.video, fps=15)
        print(f"wrote {out}")


def cmd_fdfd(args):
    from fdtd2d_tpu_torch.core.grid import Scene
    from fdtd2d_tpu_torch.core.guards import check_resolution

    scene = Scene.from_image(args.structure, args.size, args.size, dx=args.dx,
                             black_point=3.0, device=args.device)
    check_resolution(scene.eps.cpu().numpy(), scene.mu.cpu().numpy(), args.omega, scene.dx)
    source = scene.point_source(args.size // 5, args.size // 5)
    if args.solver == "direct":
        from fdtd2d_tpu_torch.fdfd.direct import DirectSolver

        solver = DirectSolver(scene.eps, scene.mu, scene.dx, scene.dx, args.omega,
                              device=args.device)
        x, trace = solver.solve(source, rhs_scale=args.omega, refine_target=args.tol)
        print(f"relative residual: {trace[-1]:.3e} "
              f"(f64 iterate: {trace[-2]:.3e})")
    elif args.solver == "timedomain":
        from fdtd2d_tpu_torch.fdfd.timedomain import TimeDomainSolver

        solver = TimeDomainSolver(scene.eps.cpu().numpy(), scene.mu.cpu().numpy(), scene.dx,
                                  scene.dx, args.omega, device=args.device)
        x, trace = solver.solve(source.cpu().numpy(), rhs_scale=args.omega,
                                refine_target=args.tol)
        print(f"relative residual: {trace[-1]:.3e} "
              f"(f64 iterate: {trace[-2]:.3e}; "
              f"{solver.steps_per_apply} wave steps/apply)")
    else:
        from fdtd2d_tpu_torch.fdfd.solver import run_fdfd

        res = run_fdfd(scene.eps, scene.mu, scene.dx, scene.dx, args.omega, source,
                       rhs_scale=args.omega,  # reference convention (fdfd.py:112)
                       tol=args.tol, maxiter=args.maxiter, device=args.device)
        x = res.x
        print(f"relative residual: {res.relative_residual:.3e}")
    if args.out:
        from fdtd2d_tpu_torch.viz.render import plot_Ez

        Ez = x.real.cpu().numpy()
        m = float(abs(Ez).max()) or 1.0
        plot_Ez(Ez, scene.eps.cpu().numpy(), args.out, vmax=m, vmin=-m)
        print(f"wrote {args.out}")


def cmd_tiled(args):
    from fdtd2d_tpu_torch.core.grid import Scene
    from fdtd2d_tpu_torch.fdfd.tiled import bfs_order, generate_patches, run_fdfd_tiled

    scene = Scene.from_image(args.structure, args.size, args.size, dx=args.dx,
                             black_point=3.0, device="cpu")
    eps, mu = scene.eps.numpy(), scene.mu.numpy()
    source = scene.point_source(args.size // 2, args.size // 2).numpy()
    if args.plot_patches:
        from fdtd2d_tpu_torch.viz.plots import plot_patch_distances

        W = args.patch_size + 2 * args.padding
        origins = generate_patches(args.size, args.size, args.patch_size, args.padding)
        dists = bfs_order(origins, W, source, halo=10)
        plot_patch_distances(origins, dists, W, eps.shape, args.plot_patches, source=source)
        print(f"wrote {args.plot_patches}")
    sol, trace = run_fdfd_tiled(eps, mu, scene.dx, scene.dx, args.omega, source,
                                mode=args.mode, patch_size=args.patch_size,
                                padding=args.padding,
                                refine_target=args.refine_target or None, verbose=True,
                                device=args.device)
    print(f"convergence trace: {[f'{t:.2e}' for t in trace]}")
    if args.out:
        from fdtd2d_tpu_torch.viz.render import plot_Ez

        Ez = sol.real.cpu().numpy()
        m = float(abs(Ez).max()) or 1.0
        plot_Ez(Ez, eps, args.out, vmax=m, vmin=-m)
        print(f"wrote {args.out}")


def cmd_invdes(args):
    from fdtd2d_tpu_torch.apps.inverse_design import (decade_lowpass_problem,
                                                      lowpass_problem, optimize)

    if args.decade:
        problem = decade_lowpass_problem(N=max(args.size, 848), n_freqs=args.freqs,
                                         tol=args.tol, maxiter=args.maxiter,
                                         device=args.device)
    else:
        problem = lowpass_problem(N=args.size, n_freqs=args.freqs, tol=args.tol,
                                  maxiter=args.maxiter, device=args.device)
    design, responses, history = optimize(
        problem, steps=args.steps, lr=args.lr,
        callback=lambda s, v, d: print(f"step {s}: loss {v:.6f}"))
    print(f"final loss: {history[-1]:.6f}")
    if args.out:
        from fdtd2d_tpu_torch.viz.plots import plot_frequency_response

        plot_frequency_response(problem.omegas, responses.cpu().numpy(),
                                problem.ideal_response.cpu().numpy(), args.out)
        print(f"wrote {args.out}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fdtd2d-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    f = sub.add_parser("fdtd", help="time-domain rollout")
    f.add_argument("--size", type=int, default=200)
    f.add_argument("--steps", type=int, default=1000)
    f.add_argument("--dt", type=float, default=5e-14)
    f.add_argument("--dx", type=float, default=1e-4)
    f.add_argument("--fc", type=float, default=30e9)
    f.add_argument("--frames", type=int, default=200)
    f.add_argument("--structure", type=str, default=None)
    f.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "torch", "fused", "ttiled", *BACKEND_ALIASES])
    f.add_argument("--video", type=str, default=None)
    f.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    f.set_defaults(fn=cmd_fdtd)

    f = sub.add_parser("fdfd", help="steady-state solve")
    f.add_argument("--size", type=int, default=512)
    f.add_argument("--omega", type=float, default=17e9)
    f.add_argument("--dx", type=float, default=1e-3)
    f.add_argument("--tol", type=float, default=1e-6)
    f.add_argument("--maxiter", type=int, default=1000)
    f.add_argument("--solver", type=str, default="krylov",
                   choices=["krylov", "direct", "timedomain"],
                   help="krylov: FDM-FGMRES (scales past the direct "
                        "solver's memory); direct: exact sublattice "
                        "block-Thomas factorization (any contrast); "
                        "timedomain: frequency-locked wave run to steady "
                        "state (wavelength-robust, no factor memory)")
    f.add_argument("--structure", type=str, default=None)
    f.add_argument("--out", type=str, default="Ez.png",
                   help='plot of Re(Ez); "" skips it')
    f.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    f.set_defaults(fn=cmd_fdfd)

    f = sub.add_parser("tiled", help="domain-decomposed solve")
    f.add_argument("--size", type=int, default=512)
    f.add_argument("--omega", type=float, default=17e9)
    f.add_argument("--dx", type=float, default=1e-3)
    f.add_argument("--mode", type=str, default="krylov",
                   choices=["krylov", "additive", "multiplicative"])
    f.add_argument("--patch-size", type=int, default=100)
    f.add_argument("--padding", type=int, default=30)
    f.add_argument("--refine-target", type=float, default=1e-6,
                   help="true-f64-residual target for iterative refinement "
                        "(krylov mode; 0 disables refinement)")
    f.add_argument("--structure", type=str, default=None)
    f.add_argument("--out", type=str, default="Ez_tiled.png",
                   help='plot of Re(Ez); "" skips it')
    f.add_argument("--plot-patches", type=str, default=None,
                   help="write the BFS patch-distance diagnostic map here")
    f.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    f.set_defaults(fn=cmd_tiled)

    f = sub.add_parser("invdes", help="inverse design (low-pass filter)")
    f.add_argument("--size", type=int, default=250)
    f.add_argument("--steps", type=int, default=100)
    f.add_argument("--freqs", type=int, default=10)
    f.add_argument("--lr", type=float, default=0.05)
    f.add_argument("--tol", type=float, default=1e-6)
    f.add_argument("--maxiter", type=int, default=400)
    f.add_argument("--decade", action="store_true",
                   help="the reference's full 10-100 GHz sweep on a grid "
                        "fine enough for 100 GHz (N >= 848)")
    f.add_argument("--out", type=str, default="frequency_response.png",
                   help='plot of the final response; "" skips it')
    f.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    f.set_defaults(fn=cmd_invdes)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
