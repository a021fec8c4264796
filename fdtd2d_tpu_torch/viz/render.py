"""Field rendering and video export.

Pixel-equivalent of the reference's snapshot pipeline (reference:
python-src/main.py:153-179 capture_snapshot, python-src/utils.py:15-41
plot_Ez, python-src/main.py:126-150 ffmpeg video): Ez through the seismic
colormap alpha-blended (0.7) over a permittivity-derived grayscale background
(high permittivity = darker gray). Frame rendering here is vectorized over
whole snapshot stacks instead of one matplotlib round-trip per frame, and
video export falls back to an animated GIF when ffmpeg is unavailable.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np

from fdtd2d_tpu_torch import constants


def _eps_background(eps: np.ndarray) -> np.ndarray:
    """Grayscale background: vacuum -> white (255), max eps -> mid-gray (128)."""
    eps = np.asarray(eps, np.float64)
    eps_min = constants.EPSILON_0
    eps_max = float(eps.max())
    if eps_max == eps_min:
        return np.full(eps.shape, 255, np.uint8)
    normed = (eps - eps_min) / (eps_max - eps_min)
    return ((1.0 - normed) * 127 + 128).astype(np.uint8)


def field_to_rgb(Ez, eps, vmax: float = 20.0, vmin: float = -20.0) -> np.ndarray:
    """(..., H, W) fields -> (..., H, W, 3) uint8 frames (batched)."""
    from matplotlib import colormaps

    Ez = np.asarray(Ez, np.float64)
    normed = (np.clip(Ez, vmin, vmax) - vmin) / (vmax - vmin)
    rgba = colormaps["seismic"](normed)          # (..., H, W, 4)
    alpha = 0.7
    background = _eps_background(eps)[..., None].astype(np.float64) / 255.0
    rgb = rgba[..., :3] * alpha + background * (1.0 - alpha)
    return (rgb * 255).astype(np.uint8)


def capture_snapshot(Ez, eps, path: str, vmax: float = 20.0, vmin: float = -20.0) -> None:
    """Render one field frame to a PNG (reference capture_snapshot parity)."""
    from PIL import Image

    Image.fromarray(field_to_rgb(Ez, eps, vmax, vmin)).save(path)


# the reference keeps a duplicate of the same renderer in utils.py (plot_Ez);
# here it is literally the same function
plot_Ez = capture_snapshot


def save_frames(snapshots, eps, out_dir: str, vmax: float = 20.0,
                vmin: float = -20.0, prefix: str = "frame") -> Sequence[str]:
    """Render a (T, H, W) snapshot stack to PNG frames (one colormap pass)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    frames = field_to_rgb(np.asarray(snapshots), eps, vmax, vmin)
    paths = []
    for i, frame in enumerate(frames):
        p = os.path.join(out_dir, f"{prefix}_{i:04d}.png")
        Image.fromarray(frame).save(p)
        paths.append(p)
    return paths


def make_video_from_frames(frames_dir: str, out_path: str = "animation.mp4",
                           fps: int = 15, prefix: str = "frame") -> str:
    """ffmpeg H.264 export (reference main.py:126-150); GIF fallback when
    ffmpeg is absent (returns the path actually written)."""
    if shutil.which("ffmpeg"):
        cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-i",
               os.path.join(frames_dir, f"{prefix}_%04d.png"),
               "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            return out_path
        except subprocess.CalledProcessError as e:  # pragma: no cover
            print(f"Error creating video: {e.stderr.decode()}")

    from PIL import Image

    files = sorted(f for f in os.listdir(frames_dir)
                   if f.startswith(prefix) and f.endswith(".png"))
    images = [Image.open(os.path.join(frames_dir, f)) for f in files]
    gif_path = os.path.splitext(out_path)[0] + ".gif"
    images[0].save(gif_path, save_all=True, append_images=images[1:],
                   duration=int(1000 / fps), loop=0)
    return gif_path


def render_video(snapshots, eps, out_path: str = "animation.mp4",
                 fps: int = 15, vmax: Optional[float] = None,
                 vmin: Optional[float] = None, workdir: str = "frames") -> str:
    """Snapshot stack -> frames -> video, end to end."""
    snaps = np.asarray(snapshots)
    if vmax is None:
        vmax = float(np.abs(snaps).max()) or 1.0
    if vmin is None:
        vmin = -vmax
    save_frames(snaps, eps, workdir, vmax, vmin)
    return make_video_from_frames(workdir, out_path, fps)
