"""Device-mesh helper.

Counterpart of ``fdtd2d_tpu/parallel/mesh.py``. The JAX package lays its
grids over a ``jax.sharding.Mesh`` and lets one program run on all of its
devices; the port is one process that holds a mesh of ``torch.device``
entries and places one block of the grid on each. ``grid_sharding`` has no
meaning without a partitioner and has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An n-d array of ``torch.device`` entries and the names of its axes
    (``.devices.shape``, ``.devices.ndim`` and ``.axis_names`` read as on a
    ``jax.sharding.Mesh``)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def grid_shape(self) -> Tuple[int, int]:
        """(row blocks, column blocks) of a grid laid over the mesh: a 1D mesh
        is a column of row blocks."""
        if self.devices.ndim > 2:
            raise ValueError(f"a grid is laid over a 1D or 2D mesh, not {self.devices.shape}")
        return (*self.devices.shape, 1)[:2]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("x", "y"), devices=None) -> Mesh:
    """Build an n-d device mesh. Default: near-square 2D over all devices.

    ``devices`` defaults to every visible CUDA device. Given explicitly, it
    may name one device several times (``["cuda:0"] * 4``, ``["cpu"] * 8``):
    every block of the grid then lives on that device, with the same
    decomposition, ghost cells and halo exchange as on distinct devices. That
    is how a machine with one card (or none) runs and tests the sharded
    path; it is never chosen silently. Raises ``ValueError`` when ``shape``
    needs more devices than there are."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0:
        raise ValueError("no CUDA device is visible: pass devices= to make_mesh")
    if shape is None:
        rows = math.isqrt(n)
        while n % rows:
            rows -= 1
        shape = (rows, n // rows)
    size = math.prod(shape)
    if size > n:
        raise ValueError(f"mesh {tuple(shape)} needs more than {n} devices")
    devs = np.empty(size, dtype=object)
    devs[:] = devices[:size]
    return Mesh(devs.reshape(shape), tuple(axis_names[: len(shape)]))
