"""DST-I transforms via FFT (counterpart of ``fdtd2d_tpu/ops/dst.py``).

Used by the shifted-Laplacian FDFD preconditioner (fdfd/solver.py): the
constant-coefficient distance-2 Helmholtz stencil is diagonalized by the
type-I discrete sine transform, giving an O(N^2 log N) inverse. DST-I is
built from ``torch.fft.fft`` of the odd extension.

DST-I convention: S[k] = sum_j f[j] sin(pi (j+1)(k+1) / (n+1)); the transform
is its own inverse up to a factor 2/(n+1).
"""

from __future__ import annotations

import torch


def dst1(f: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Type-I DST along ``axis`` (complex or real input, complex output)."""
    f = f.movedim(axis, -1)
    n = f.shape[-1]
    zeros = f.new_zeros(f.shape[:-1] + (1,))
    ext = torch.cat([zeros, f, zeros, -f.flip(-1)], dim=-1)  # length 2(n+1)
    G = torch.fft.fft(ext, dim=-1)
    S = 0.5j * G[..., 1 : n + 1]
    return S.movedim(-1, axis)


def idst1(S: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`dst1`."""
    n = S.shape[axis]
    return dst1(S, axis=axis) * (2.0 / (n + 1))


def dst2d(f: torch.Tensor) -> torch.Tensor:
    return dst1(dst1(f, axis=-1), axis=-2)


def idst2d(S: torch.Tensor) -> torch.Tensor:
    return idst1(idst1(S, axis=-1), axis=-2)
