"""Fast-diagonalization (FDM) preconditioner for the UPML Helmholtz operator.

Counterpart of ``fdtd2d_tpu/ops/fdm.py``. For uniform (eps_ref, mu_ref) the
FDFD operator *including the PML stretch* is separable: A_ref = T_r (+) T_c
- omega^2 eps_ref I (Kronecker sum), with

    T_axis = (1/mu_ref) diag(1/s) K K^T diag(1/s)      (n x n, complex)

acting along one grid axis. Eigendecomposing the two small 1D matrices once
on the host (scipy.linalg.eig; they are non-symmetric complex) gives an exact
inverse of A_ref applied as four dense matrix multiplies per call:

    Y = P_r^{-1} R P_c^{-T};  Y /= (lam_r[:,None] + lam_c[None,:] - w2e);
    X = P_r Y P_c^T

As a preconditioner for heterogeneous media the error comes only from the
eps/mu deviation from the reference constants, so Krylov iteration counts
depend on material contrast, not on grid size or PML strength.

A stacked preconditioner (``stack_preconditioners``, or
``fdm_preconditioner_for`` of a stacked operator) holds one factor set per
omega: ``Pr``/``Pri`` (F, Nx, Nx), ``PcT``/``PcTi`` (F, Ny, Ny), ``D``
(F, Nx, Ny), applied to (F, Nx, Ny) with batched matmuls. An unstacked
preconditioner applied to a (P, Nx, Ny) batch (one preconditioner shared by
every patch of fdfd/tiled.py, as the JAX package applies it under ``vmap``)
broadcasts its factors over the batch in the same batched matmuls.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from fdtd2d_tpu_torch import constants
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator, pml_sigma_profile


def _t_matrix_1d(n: int, d: float, omega: float, pml_thickness: int,
                 sigma_max: float, m: int, mu_ref: float) -> np.ndarray:
    sig = pml_sigma_profile(n, pml_thickness, sigma_max, m)
    inv_s = 1.0 / (1.0 + 1j * sig / (omega * constants.EPSILON_0))
    a = 1.0 / (2.0 * d)
    K = np.zeros((n, n))
    idx = np.arange(n - 1)
    K[idx, idx + 1] = a
    K[idx + 1, idx] = -a
    L = K @ K.T
    return (1.0 / mu_ref) * (inv_s[:, None] * L * inv_s[None, :])


@lru_cache(maxsize=16)
def _fdm_factors(n: int, d: float, omega: float, pml_thickness: int,
                 sigma_max: float, m: int, mu_ref: float):
    import scipy.linalg

    T = _t_matrix_1d(n, d, omega, pml_thickness, sigma_max, m, mu_ref)
    lam, P = scipy.linalg.eig(T)
    Pinv = np.linalg.inv(P)
    return lam, P, Pinv


@dataclasses.dataclass(frozen=True)
class FDMPreconditioner:
    """Exact uniform-medium UPML inverse as dense factors on the device."""

    Pr: torch.Tensor     # (Nx, Nx), (F, Nx, Nx) when stacked
    Pri: torch.Tensor
    PcT: torch.Tensor    # (Ny, Ny), (F, Ny, Ny) when stacked
    PcTi: torch.Tensor
    D: torch.Tensor      # (Nx, Ny) spectral inverse, (F, Nx, Ny) when stacked

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        shape = r.shape
        batch = () if r.numel() == self.D.numel() else (-1,)
        R = r.reshape(batch + self.D.shape).to(self.Pr.dtype)
        Y = (self.Pri @ R @ self.PcTi) * self.D
        return (self.Pr @ Y @ self.PcT).reshape(shape)


def fdm_preconditioner(
    Nx: int, Ny: int, dx: float, dy: float, omega: float,
    pml_thickness: int, sigma_max: float = 2.0, m: int = 3,
    eps_ref: float = constants.EPSILON_0, mu_ref: float = constants.MU_0,
    dtype=torch.complex64, device="cuda",
) -> FDMPreconditioner:
    """Build M^{-1} (exact for the uniform-medium UPML operator). Host-side
    one-time eigendecomposition, cached per parameter set."""
    lam_r, P_r, P_r_inv = _fdm_factors(Nx, float(dy), float(omega),
                                       pml_thickness, sigma_max, m, float(mu_ref))
    lam_c, P_c, P_c_inv = _fdm_factors(Ny, float(dx), float(omega),
                                       pml_thickness, sigma_max, m, float(mu_ref))
    denom = lam_r[:, None] + lam_c[None, :] - omega**2 * eps_ref

    def t(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return FDMPreconditioner(
        Pr=t(P_r),
        Pri=t(P_r_inv),
        PcT=t(P_c.T),
        PcTi=t(P_c_inv.T),  # (P_c^T)^{-1} = (P_c^{-1})^T
        D=t(1.0 / denom),
    )


def stack_preconditioners(Ms) -> FDMPreconditioner:
    """One preconditioner stacked over the members of ``Ms`` (one per omega
    of a stacked operator, in its order)."""
    return FDMPreconditioner(**{f.name: torch.stack([getattr(M, f.name) for M in Ms])
                                for f in dataclasses.fields(FDMPreconditioner)})


def fdm_preconditioner_for(op: HelmholtzOperator) -> FDMPreconditioner:
    """FDM preconditioner matched to an operator's parameters (its mean eps
    and 1/mu, taken on the host in the operator's precision); stacked over
    omega when the operator is, one shared by every patch of a patch stack."""
    Nx, Ny = op.shape
    eps_ref = float(np.mean(op.eps.detach().cpu().numpy()))
    mu_ref = 1.0 / float(np.mean(op.inv_mu.detach().cpu().numpy()))
    dx = 1.0 / (2.0 * float(op.inv_2dx))
    dy = 1.0 / (2.0 * float(op.inv_2dy))
    Ms = [fdm_preconditioner(Nx, Ny, dx, dy, omega, op.pml_thickness, op.sigma_max, op.m,
                             eps_ref=eps_ref, mu_ref=mu_ref, dtype=op.dtype, device=op.device)
          for omega in op.omega.reshape(-1).tolist()]
    return stack_preconditioners(Ms) if op.omega.ndim else Ms[0]
