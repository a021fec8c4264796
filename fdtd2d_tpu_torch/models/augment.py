"""Exact dihedral data augmentation for the scene->field surrogate.

Counterpart of ``fdtd2d_tpu/models/augment.py``. On the datagen scenes
(square, dx == dy, a symmetric PML frame on all four edges, uniform mu) the
discrete Helmholtz operator is equivariant under the dihedral group D4 of
the square, so Ez(g . scene) == g . Ez(scene) for every g in D4; a random g
a sample multiplies the effective number of unique scenes by up to 8 at no
datagen cost. The JAX module's docstring gives the argument, and
tests/test_models.py pins it against the exact direct solver.

A batch is transformed by one gather a channel: each of the eight elements
is a fixed permutation of the H*W pixels, so a (B,) tensor of elements picks
one row of an (8, H*W) index table, on the device, with no host read.
"""

from __future__ import annotations

from functools import lru_cache

import torch


def dihedral(x: torch.Tensor, g: int) -> torch.Tensor:
    """Apply element ``g`` in [0, 8) of D4 to the LAST TWO axes of ``x``.

    g % 4 counts 90-degree counter-clockwise rotations (as np.rot90);
    g >= 4 additionally flips the first spatial axis BEFORE rotating, i.e.
    g = 4 + k is ``rot90(flipud(x), k)``. Requires square spatial dims."""
    if x.shape[-1] != x.shape[-2]:
        raise ValueError(f"dihedral augmentation needs square spatial dims, "
                         f"got {tuple(x.shape[-2:])}")
    g = int(g)
    if g >= 4:
        x = torch.flip(x, dims=(-2,))
    return torch.rot90(x, k=g % 4, dims=(-2, -1))


@lru_cache(maxsize=8)
def _index_table(n: int, device: torch.device) -> torch.Tensor:
    """(8, n*n) int64: row g is the source pixel of each pixel of
    ``dihedral(x, g)`` on an n x n grid."""
    flat = torch.arange(n * n).reshape(n, n)
    return torch.stack([dihedral(flat, g).reshape(-1) for g in range(8)]).to(device)


def dihedral_batch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dihedral(x[i], g[i])`` for every sample i of a (B, n, n) batch;
    ``g`` (B,) integer tensor on x's device."""
    B, n = x.shape[0], x.shape[-1]
    if x.shape[-2] != n:
        raise ValueError(f"dihedral augmentation needs square spatial dims, "
                         f"got {tuple(x.shape[-2:])}")
    idx = _index_table(n, x.device)[g.long()]
    return torch.gather(x.reshape(B, n * n), 1, idx).reshape(x.shape)


def augment_draws(generator: torch.Generator, batch_size: int) -> torch.Tensor:
    """One uniformly random element of D4 a sample, (B,) on the generator's
    device."""
    return torch.randint(0, 8, (batch_size,), generator=generator, device=generator.device)


def augment_batch(generator, batch: dict, channels=("eps", "mu", "src", "Ez"),
                  g: torch.Tensor = None) -> dict:
    """Transform each sample of a (B, H, W)-channel batch by a random element
    of D4 (``g``, drawn from ``generator`` when None), the same element
    across channels (the field must move with its scene). Non-spatial
    entries (e.g. ``omega``) pass through untouched."""
    if g is None:
        g = augment_draws(generator, batch[channels[0]].shape[0])
    out = dict(batch)
    for name in channels:
        if name in out:
            out[name] = dihedral_batch(out[name], g)
    return out
