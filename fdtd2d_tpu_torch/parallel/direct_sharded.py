"""Mesh-sharded direct Helmholtz solve: sublattices distributed over devices.

Counterpart of ``fdtd2d_tpu/parallel/direct_sharded.py``. The four
(i mod 2, j mod 2) sublattices of the block-Thomas factorization
(fdfd/direct.py) are independent linear systems that meet only at the
right-hand side's split and the solution's merge, so each can factor and
solve on its own device with no communication in between. Sublattice k
lives on mesh entry ``k * len(mesh) // 4``: on a mesh of 4 one each, of 2
two each (batched there as the stacked path batches four), of 1 all four.
Per-device factor storage drops by the mesh size, and ``checkpointed`` or
``compressed`` shrink it further (fdfd/direct.py, fdfd/compressed.py).

One process drives every entry, as in parallel/fdtd_sharded.py: a mesh may
name one device several times (``["cuda:0"] * 4``, ``["cpu"] * 4``), which
runs the same placement and merge on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fdtd2d_tpu_torch.fdfd.compressed import (
    factor_compressed_stacked, hodlr_plan, make_test_matrices,
)
from fdtd2d_tpu_torch.fdfd.direct import (
    _factor_rows, _solve_sub, merge_sublattices, split_sublattices, stack_coefficients,
)
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator


@dataclasses.dataclass(frozen=True)
class ShardedFactors:
    """Per mesh entry: (device, its first sublattice, the factors of its
    sublattices: stacked on a leading axis when it holds more than one)."""
    groups: Tuple[Tuple[torch.device, int, object], ...]
    shape: Tuple[int, int]


def factor_sharded(op: HelmholtzOperator, mesh, *, checkpointed: bool = False,
                   stride: int = 32, compressed: bool = False, rank: int = 20,
                   leaf: int = 128, power_iters: int = 1) -> ShardedFactors:
    """Factor with the sublattice axis spread over ``mesh`` (a 1D mesh of 1,
    2 or 4 entries; even Nx/Ny only). ``checkpointed=True`` stores W every
    ``stride`` rows; ``compressed=True`` stores the HODLR rows (``rank``,
    ``leaf``, ``power_iters``) with the test matrices of the single-device
    path, so both factor the same rows."""
    if checkpointed and compressed:
        raise ValueError("choose one of checkpointed/compressed")
    Nx, Ny = op.shape
    if Nx % 2 or Ny % 2:
        raise ValueError(f"sharded direct solve needs even N, got {(Nx, Ny)}")
    devices = mesh.devices
    if devices.ndim != 1 or 4 % devices.shape[0]:
        raise ValueError(f"use a 1D mesh of 1, 2, or 4 devices (the sublattice axis), "
                         f"got {devices.shape}")
    per = 4 // devices.shape[0]
    coeffs = stack_coefficients(op)
    groups = []
    for g, dev in enumerate(devices):
        dev = torch.device(dev)
        # one sublattice an entry factors unbatched, as the per-sublattice path
        part = tuple((c[g] if per == 1 else c[g * per:(g + 1) * per]).to(dev) for c in coeffs)
        if compressed:
            nc = Ny // 2
            L = hodlr_plan(nc, leaf=leaf, rank=rank)
            omegas = make_test_matrices(nc, L, rank, dtype=op.dtype, device=dev)
            fac = factor_compressed_stacked(part, omegas, L=L, q=power_iters)
        else:
            fac = _factor_rows(*part, stride=stride if checkpointed else None)
        groups.append((dev, g * per, fac))
    return ShardedFactors(groups=tuple(groups), shape=(Nx, Ny))


def solve_factored_sharded(f: ShardedFactors, b) -> torch.Tensor:
    """x = A^{-1} b from sharded factors; b (Nx, Ny) complex, or (K, Nx, Ny),
    on any device: each entry solves its sublattices, and the solution is
    merged on b's device."""
    Nx, Ny = f.shape
    bk = b.reshape(-1, Nx, Ny)
    b4 = torch.stack(split_sublattices(bk))
    per = 4 // len(f.groups)
    parts = []   # the groups hold the sublattices in order
    for dev, k0, fac in f.groups:
        part = b4[k0] if per == 1 else b4[k0:k0 + per]
        parts.extend(_solve_sub(fac, part.to(dev)).to(b.device).reshape((per,) + part.shape[-3:]))
    return merge_sublattices(parts, torch.zeros_like(bk)).reshape(b.shape)
