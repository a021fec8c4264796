"""Reference workflow 1: an FDTD rollout with video export (counterpart of
``examples/fdtd_video.py``).

The reference driver's scene: a 200x200 grid with a dielectric box wall,
driven by a centered 30 GHz Ricker point source for 1000 steps, 200
snapshot frames rendered to a video. ``simulate``'s ``auto`` backend runs
it on the card with K1's resident mode (one launch a frame). The rollout
runs twice on the scene already on the device, the second call warm and
timed as ``tools/profile_fdtd.py`` times its wall: the whole ``simulate``
call, coefficients and frame buffer included. Another ``N`` moves the box
by ``N / 200``.

Writes ``OUT/fdtd_video.npz`` (the frames over their max |Ez|, float16, and
the relative permittivity), and from it ``animation.mp4`` where ffmpeg is
installed (else ``animation.gif`` of every fourth frame) and a strip of
eight frames, ``fdtd_frames.png``.

Run: python -m fdtd2d_tpu_torch.apps.fdtd_video [--device cuda|cpu]
        [--out DIR] [--draw DIR]
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.apps._common import cli, half, scaled, timed
from fdtd2d_tpu_torch.core import RegionDrawer, check_courant, material_init
from fdtd2d_tpu_torch.fdtd import FDTDConfig, resolve_backend, simulate
from fdtd2d_tpu_torch.utils import trace

N0 = 200
DT, DX, FC = 5e-14, 1e-4, 30e9
VMAX = 1e-3   # the script's colour scale, in the field's units
STRIP = 8


def box_scene(N: int = N0):
    """``(eps, mu)`` numpy arrays of the script's scene at ``N``."""
    drawer = RegionDrawer(N, N)
    drawer.draw_box((scaled(50, N, N0), scaled(50, N, N0)), scaled(100, N, N0),
                    scaled(8, N, N0))
    eps = drawer.to_eps(black_point=10.0)
    _, mu = material_init(None, N, N)
    return eps, mu


def config(N: int = N0, nsteps: int = 1000, nframes: int = 200, device="cuda") -> FDTDConfig:
    return FDTDConfig(dt=DT, dx=DX, nsteps=nsteps, source_xy=(N // 2, N // 2),
                      source_fc=FC, nframes=nframes, device=str(device))


def run(N: int = N0, nsteps: int = 1000, nframes: int = 200, *, device="cuda",
        out=None) -> dict:
    """The script's rollout, twice; returns its numbers (the frames of the
    second call under ``arrays``)."""
    eps, mu = box_scene(N)
    courant = check_courant(eps, mu, DT, DX)
    print(f"courant: {courant:.4f}")
    cfg = config(N, nsteps, nframes, device)
    backend = resolve_backend("auto", (N, N), device, nsteps // nframes if nframes else None)
    eps_d, mu_d = (torch.as_tensor(a, dtype=cfg.dtype, device=device) for a in (eps, mu))
    (_, snaps), first_s = timed(lambda: simulate(eps_d, mu_d, cfg), device)
    before = trace.counters()
    (fields, snaps), warm_s = timed(lambda: simulate(eps_d, mu_d, cfg), device)
    resident = trace.delta(before, "fdtd.kernels.k1_resident")
    snaps = snaps.cpu().numpy()
    if out is not None:
        frames16, m = half(snaps)
        np.savez_compressed(os.path.join(out, "fdtd_video.npz"), frames=frames16, max_abs=m,
                            vmax=VMAX, eps_r=(eps / constants.EPSILON_0).astype(np.float16))
    return {"N": N, "nsteps": nsteps, "nframes": nframes, "courant": courant,
            "backend": backend, "k1_resident_launches": resident, "first_s": first_s,
            "rollout_ms": 1e3 * warm_s, "max_abs_Ez": float(np.abs(snaps).max()),
            "arrays": {"frames": snaps, "Ez": fields[0].cpu().numpy()}}


def draw(out_dir: str) -> list:
    from PIL import Image

    from fdtd2d_tpu_torch.viz import field_to_rgb, render_video

    d = np.load(os.path.join(out_dir, "fdtd_video.npz"))
    frames = d["frames"].astype(np.float32)
    vmax = float(d["vmax"]) / float(d["max_abs"])
    eps = d["eps_r"].astype(np.float64) * constants.EPSILON_0
    with tempfile.TemporaryDirectory() as work:
        # every frame into an mp4; a GIF of every fourth frame keeps its file small
        video = render_video(frames if shutil.which("ffmpeg") else frames[::4], eps,
                             os.path.join(out_dir, "animation.mp4"), fps=15, vmax=vmax,
                             vmin=-vmax, workdir=work)
    picks = np.linspace(0, len(frames) - 1, STRIP).round().astype(int)
    strip = np.concatenate(list(field_to_rgb(frames[picks], eps, vmax, -vmax)), axis=1)
    path = os.path.join(out_dir, "fdtd_frames.png")
    Image.fromarray(strip).save(path)
    return [video, path]


def main(argv=None) -> int:
    return cli("fdtd_video", __doc__, run, draw, argv)


if __name__ == "__main__":
    sys.exit(main())
