"""Command-line entry point of the port (the ``fdtd`` and ``fdfd``
subcommands so far):

    python -m fdtd2d_tpu_torch.cli fdtd --size 2048 --steps 2000 --device cuda
    fdtd2d-torch fdtd --size 200 --steps 1000 [--structure img.png] [--video out.mp4]
    fdtd2d-torch fdfd --size 512 --omega 17e9 --solver direct --device cuda [--out Ez.png]

Flags and printed lines are those of ``fdtd2d fdtd`` and ``fdtd2d fdfd``
(fdtd2d_tpu/cli.py), plus ``--device``. ``--out ""`` skips the plot.
"""

from __future__ import annotations

import argparse
import sys


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
                     backend=args.backend, device=args.device)
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
                   choices=["auto", "torch", "fused", "ttiled"])
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
                   choices=["krylov", "direct"],
                   help="krylov: FDM-FGMRES (scales past the direct "
                        "solver's memory); direct: exact sublattice "
                        "block-Thomas factorization (any contrast)")
    f.add_argument("--structure", type=str, default=None)
    f.add_argument("--out", type=str, default="Ez.png",
                   help='plot of Re(Ez); "" skips it')
    f.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu")
    f.set_defaults(fn=cmd_fdfd)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
