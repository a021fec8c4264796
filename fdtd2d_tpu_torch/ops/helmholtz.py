"""Matrix-free FDFD Helmholtz operator with UPML (complex coordinate stretch).

Counterpart of ``fdtd2d_tpu/ops/helmholtz.py``; the same operator on torch
tensors:

    A = C_c M_mu C_c^T + C_r M_mu C_r^T - omega^2 M_eps
    C_c = diag(1/s_c) K_c,   C_r = diag(1/s_r) K_r

where K_c / K_r are central differences along the column / row axis of the
(Nx, Ny) field (zero-truncated at the boundary), M_mu = diag(1/mu),
M_eps = diag(eps), and s are polynomial-profile PML stretch factors
s = 1 + i sigma / (omega eps0) (reference: python-src/fdfd.py:14-61).
Since K^T = -K, the apply is

    A x = -(1/s_c) K_c[(1/mu) K_c((1/s_c) x)]
          -(1/s_r) K_r[(1/mu) K_r((1/s_r) x)] - omega^2 eps x.

Complex dtypes are native: ``make_operator(..., dtype=torch.complex128)``
is the float64 operator that iterative refinement evaluates residuals with
(the JAX package's split-complex ``HelmholtzF64``, which exists only because
its TPU cannot compile complex128). ``apply`` takes leading batch dims.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fdtd2d_tpu_torch import constants


def pml_sigma_profile(n: int, pml_thickness: int, sigma_max: float, m: int) -> np.ndarray:
    """1D polynomial PML conductivity profile (reference fdfd.py:16-30)."""
    sigma = np.zeros(n)
    if pml_thickness > 0:
        ramp = (np.arange(pml_thickness) / pml_thickness) ** m
        sigma[:pml_thickness] = sigma_max * ramp[::-1]
        sigma[n - pml_thickness :] = sigma_max * ramp
    return sigma


def stretch_factors(Nx: int, Ny: int, omega: float, pml_thickness: int,
                    sigma_max: float, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(s_row (Nx,), s_col (Ny,)): complex PML stretch factors per axis."""
    sig_r = pml_sigma_profile(Nx, pml_thickness, sigma_max, m)
    sig_c = pml_sigma_profile(Ny, pml_thickness, sigma_max, m)
    s_r = 1.0 + 1j * sig_r / (omega * constants.EPSILON_0)
    s_c = 1.0 + 1j * sig_c / (omega * constants.EPSILON_0)
    return s_r, s_c


def _dcol(f, inv2d):
    """Central difference along the last axis, zero-truncated:
    (f[..., j+1] - f[..., j-1]) * inv2d."""
    return (F.pad(f[..., 1:], (0, 1)) - F.pad(f[..., :-1], (1, 0))) * inv2d


def _drow(f, inv2d):
    """Central difference along the second-to-last axis, zero-truncated."""
    return (F.pad(f[..., 1:, :], (0, 0, 0, 1)) - F.pad(f[..., :-1, :], (0, 0, 1, 0))) * inv2d


@dataclasses.dataclass(frozen=True)
class HelmholtzOperator:
    """Matrix-free A for the 2D TE FDFD problem on an (Nx, Ny) grid. Real
    fields and scalars are in the real type of the complex ``dtype``."""

    eps: torch.Tensor          # (Nx, Ny) real
    inv_mu: torch.Tensor       # (Nx, Ny) real
    inv_s_row: torch.Tensor    # (Nx,) complex — 1/s along the row axis
    inv_s_col: torch.Tensor    # (Ny,) complex — 1/s along the column axis
    omega: torch.Tensor        # 0-d
    inv_2dx: torch.Tensor      # 0-d: 1/(2*dx), column-axis spacing
    inv_2dy: torch.Tensor      # 0-d: 1/(2*dy), row-axis spacing
    # PML metadata (carried so preconditioners can be rebuilt)
    pml_thickness: int = 40
    sigma_max: float = 2.0
    m: int = 3

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.eps.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.inv_s_row.dtype

    @property
    def device(self) -> torch.device:
        return self.eps.device

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for x of shape (..., Nx, Ny) (complex)."""
        isc = self.inv_s_col[None, :]
        isr = self.inv_s_row[:, None]
        tc = _dcol(x * isc, self.inv_2dx)
        tc = _dcol(tc * self.inv_mu, self.inv_2dx) * isc
        tr = _drow(x * isr, self.inv_2dy)
        tr = _drow(tr * self.inv_mu, self.inv_2dy) * isr
        return -(tc + tr) - (self.omega**2) * self.eps * x

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Flattened matvec (for Krylov drivers operating on vectors)."""
        if x.ndim == 1:
            return self.apply(x.reshape(self.shape)).reshape(-1)
        return self.apply(x)

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """b - A x."""
        return b - self.apply(x)

    def diagonal(self) -> torch.Tensor:
        """diag(A) as an (Nx, Ny) array (for Jacobi preconditioning)."""
        a_c = self.inv_2dx**2
        a_r = self.inv_2dy**2
        im = self.inv_mu
        # (C M C^T)[k,k] = (1/s_k)^2 * a * (1/mu_{k-1} + 1/mu_{k+1}), truncated.
        im_cm = F.pad(im[:, :-1], (1, 0))   # 1/mu at col j-1 (0 at edge)
        im_cp = F.pad(im[:, 1:], (0, 1))    # 1/mu at col j+1
        im_rm = F.pad(im[:-1, :], (0, 0, 1, 0))
        im_rp = F.pad(im[1:, :], (0, 0, 0, 1))
        dc = (self.inv_s_col[None, :] ** 2) * a_c * (im_cm + im_cp)
        dr = (self.inv_s_row[:, None] ** 2) * a_r * (im_rm + im_rp)
        return dc + dr - (self.omega**2) * self.eps


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype


def make_operator(eps, mu, dx, dy, omega, pml_thickness: int = 40,
                  sigma_max: float = 2.0, m: int = 3,
                  dtype=torch.complex64, device="cpu") -> HelmholtzOperator:
    """Build the matrix-free operator (defaults match reference fdfd.py:14).
    ``eps``/``mu`` are numpy arrays or tensors; ``1/mu`` is taken in their
    own precision before the cast, as the JAX package does."""
    eps = torch.as_tensor(eps, device=device)
    mu = torch.as_tensor(mu, device=device)
    Nx, Ny = eps.shape
    s_r, s_c = stretch_factors(Nx, Ny, float(omega), pml_thickness, sigma_max, m)
    real = _real_dtype(dtype)

    def scalar(v):
        return torch.tensor(v, dtype=real, device=device)

    return HelmholtzOperator(
        eps=eps.to(real),
        inv_mu=(1.0 / mu).to(real),
        inv_s_row=torch.as_tensor(1.0 / s_r).to(device=device, dtype=dtype),
        inv_s_col=torch.as_tensor(1.0 / s_c).to(device=device, dtype=dtype),
        omega=scalar(float(omega)),
        inv_2dx=scalar(1.0 / (2.0 * dx)),
        inv_2dy=scalar(1.0 / (2.0 * dy)),
        pml_thickness=pml_thickness,
        sigma_max=sigma_max,
        m=m,
    )


def operator_from_numpy(eps, inv_mu, inv_s_row, inv_s_col, omega, inv_2dx, inv_2dy,
                        *, pml_thickness: int, sigma_max: float, m: int,
                        device="cpu") -> HelmholtzOperator:
    """The operator from host arrays of its fields, in their own dtypes (e.g.
    ``np.asarray`` of a JAX ``HelmholtzOperator``'s fields), so that both
    packages compute from one operator."""

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    return HelmholtzOperator(eps=t(eps), inv_mu=t(inv_mu), inv_s_row=t(inv_s_row),
                             inv_s_col=t(inv_s_col), omega=t(omega), inv_2dx=t(inv_2dx),
                             inv_2dy=t(inv_2dy), pml_thickness=pml_thickness,
                             sigma_max=sigma_max, m=m)
