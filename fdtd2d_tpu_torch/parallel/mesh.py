"""Device-mesh helper.

Counterpart of ``fdtd2d_tpu/parallel/mesh.py``. The JAX package lays its
grids over a ``jax.sharding.Mesh`` and lets one program run on all of its
devices; the port is one process that holds a mesh of ``torch.device``
entries and places one block of the grid on each. ``grid_sharding`` has no
meaning without a partitioner and has no counterpart. :class:`BlockLayout`
cuts a field into the mesh's blocks and puts it back together.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

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

    def axis_size(self, name: str) -> int:
        """The number of entries along the axis ``name`` (``mesh.shape[name]``
        of a JAX mesh)."""
        return self.devices.shape[self.axis_names.index(name)]


def block_bounds(n: int, D: int) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]``: ``n`` cells cut into ``D`` runs as even as they
    come, the first ``n % D`` one cell longer."""
    base, extra = divmod(n, D)
    edges = [b * base + min(b, extra) for b in range(D + 1)]
    return list(zip(edges[:-1], edges[1:]))


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """An (Nx, Ny) field cut into the Dr x Dc blocks of a mesh (a 1D mesh is
    Dc = 1): block (r, c) holds rows ``rows[r]`` and columns ``cols[c]``
    (:func:`block_bounds`) on ``devices[r, c]``. A *block field* is the list
    of its blocks in row-major order, each a tensor of shape (..., rows,
    cols) on its device."""

    shape: Tuple[int, int]
    rows: Tuple[Tuple[int, int], ...]
    cols: Tuple[Tuple[int, int], ...]
    devices: np.ndarray

    @classmethod
    def of(cls, mesh: Mesh, shape) -> "BlockLayout":
        """The layout of a ``shape`` grid on ``mesh``; raises ``ValueError``
        where a block would hold no cell."""
        Dr, Dc = mesh.grid_shape
        Nx, Ny = shape
        if Nx < Dr or Ny < Dc:
            raise ValueError(f"a {Nx} x {Ny} grid over {Dr} x {Dc} blocks leaves a block "
                             f"without cells")
        return cls((Nx, Ny), tuple(block_bounds(Nx, Dr)), tuple(block_bounds(Ny, Dc)),
                   mesh.devices.reshape(Dr, Dc))

    @property
    def grid(self) -> Tuple[int, int]:
        return len(self.rows), len(self.cols)

    @property
    def first(self) -> torch.device:
        return self.devices[0, 0]

    def index(self, r: int, c: int) -> int:
        return r * len(self.cols) + c

    def slices(self):
        """``(r, c, (row slice, column slice), device)`` of every block, in
        row-major order."""
        for r, (r0, r1) in enumerate(self.rows):
            for c, (c0, c1) in enumerate(self.cols):
                yield r, c, (slice(r0, r1), slice(c0, c1)), self.devices[r, c]

    def scatter(self, full: torch.Tensor) -> list:
        """The block field of ``full`` (..., Nx, Ny): a contiguous copy of
        each block on its device."""
        return [full[(..., *sl)].to(dev, copy=True).contiguous()
                for _, _, sl, dev in self.slices()]

    def gather(self, blocks: list) -> torch.Tensor:
        """The (..., Nx, Ny) field of a block field, on the first device."""
        lead = blocks[0].shape[:-2]
        out = torch.empty(lead + tuple(self.shape), dtype=blocks[0].dtype, device=self.first)
        for blk, (_, _, sl, _) in zip(blocks, self.slices()):
            out[(..., *sl)] = blk
        return out


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
