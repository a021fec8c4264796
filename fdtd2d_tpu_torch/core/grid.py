"""Staggered Yee-grid state and scene containers (torch tensors).

Grid convention, as in ``fdtd2d_tpu/core/grid.py``:

- ``Ez`` lives on cell nodes, shape ``(rows, cols)``.
- ``Hx`` lives on vertical edges, shape ``(rows, cols - 1)``.
- ``Hy`` lives on horizontal edges, shape ``(rows - 1, cols)``.

``scene_from_numpy`` and ``state_from_numpy`` take the JAX package's scene
and field arrays (``np.asarray`` of them) and return the port's, so that
both packages can compute the same rollout from the same parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from fdtd2d_tpu_torch import constants


def grid_init(rows: int, cols: int, dtype=torch.float32,
              device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero-initialized (Ez, Hx, Hy) fields on a staggered Yee grid."""
    return (
        torch.zeros((rows, cols), dtype=dtype, device=device),
        torch.zeros((rows, cols - 1), dtype=dtype, device=device),
        torch.zeros((rows - 1, cols), dtype=dtype, device=device),
    )


@dataclasses.dataclass(frozen=True)
class Scene:
    """Immutable simulation scene: materials + spatial resolution.

    ``eps``/``mu`` are absolute (not relative) permittivity/permeability maps
    of shape ``(rows, cols)``; ``dx`` is the (isotropic) cell size in meters.
    """

    eps: torch.Tensor
    mu: torch.Tensor
    dx: float

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.eps.shape)

    @staticmethod
    def vacuum(rows: int, cols: int, dx: float, dtype=torch.float32,
               device="cuda") -> "Scene":
        return Scene(
            eps=torch.full((rows, cols), constants.EPSILON_0, dtype=dtype, device=device),
            mu=torch.full((rows, cols), constants.MU_0, dtype=dtype, device=device),
            dx=dx,
        )

    @staticmethod
    def from_image(path: "str | None", rows: int, cols: int, dx: float,
                   black_point: float = 10.0, dtype=torch.float32,
                   device="cuda") -> "Scene":
        """Scene from a grayscale structure image (black -> black_point*eps0,
        white -> eps0; LANCZOS resize). ``path=None`` gives vacuum."""
        from fdtd2d_tpu_torch.core.materials import material_init

        eps, mu = material_init(path, rows, cols, black_point=black_point,
                                dtype=np.float64)
        return scene_from_numpy(eps, mu, dx, device, dtype)

    def point_source(self, x: int, y: int, amp: float = 10.0) -> torch.Tensor:
        """A single-point source map at (x, y) (the CLI's FDFD convention)."""
        src = torch.zeros(self.shape, dtype=torch.float32, device=self.eps.device)
        src[x, y] = amp
        return src


def scene_from_numpy(eps, mu, dx: float, device="cpu", dtype=torch.float32) -> Scene:
    """A :class:`Scene` from host arrays (e.g. ``np.asarray`` of a JAX scene)."""
    return Scene(eps=torch.as_tensor(np.asarray(eps), dtype=dtype, device=device),
                 mu=torch.as_tensor(np.asarray(mu), dtype=dtype, device=device),
                 dx=float(dx))


def state_from_numpy(state, device="cpu", dtype=torch.float32):
    """``(Ez, Hx, Hy)`` host arrays -> new tensors on ``device``."""
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device) for a in state)
