"""Plain FDFD reference: the Helmholtz operator with UPML of the upstream
code (github.com/skunnavakkam/fdtd-2d, python-src/fdfd.py, ``make_A``),
assembled as a scipy sparse matrix in complex128, its exact solutions, and
the upstream's resolution gate.

    A = C_c M_mu C_c^T + C_r M_mu C_r^T - omega^2 M_eps
    C_c = diag(1/s_c) K_c,   C_r = diag(1/s_r) K_r,   M_mu = diag(1/mu)

K_c and K_r are central differences (f[j+1] - f[j-1]) / (2 d) along the
column and the row axis of the row-major (Nx, Ny) field, cut off at the
edges; s = 1 + i sigma / (omega eps0), with sigma a polynomial ramp of order
m rising to sigma_max over the outer ``pml`` cells of each axis. The
right-hand side of a unit point source is ``-1j omega`` at its cell.

The central differences couple a cell only to cells two away, so on an
even grid A falls apart into four decoupled sublattices (row parity x
column parity), each a five-point operator: block tridiagonal by rows, with
tridiagonal diagonal blocks and diagonal off-diagonal blocks.
``Sublattices`` takes exactly those entries out of A (it refuses an A with
any other) and solves with them by dense block elimination in complex128
on the device, refined against the same entries until its own residual is
at rounding.

Everything is worked out again here from eps, mu and the configuration's
numbers. This module imports nothing of the measured program.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

EPSILON_0 = 8.85418e-12   # the upstream code's constant (python-src/main.py)


def check_resolution(eps, mu, omega: float, dx: float) -> None:
    """The upstream's gate (python-src/fdfd.py): lambda_min / 20 <= dx <=
    lambda_min / 10, with lambda_min = c_min / omega as the upstream writes
    it and c_min = 1 / sqrt(eps mu) at the slowest cell."""
    lam = float(np.min(1.0 / np.sqrt(np.asarray(eps) * np.asarray(mu)))) / omega
    if not lam / 20.0 <= dx <= lam / 10.0:
        raise ValueError(f"dx = {dx:g} lies outside the upstream's window "
                         f"[{lam / 20.0:g}, {lam / 10.0:g}] (lambda_min/20, lambda_min/10)")


def sigma_profile(n: int, pml: int, sigma_max: float, m: int) -> np.ndarray:
    sigma = np.zeros(n)
    if pml > 0:
        ramp = (np.arange(pml) / pml) ** m
        sigma[:pml] = sigma_max * ramp[::-1]
        sigma[n - pml :] = sigma_max * ramp
    return sigma


def central_difference(n: int, d: float) -> sp.csr_matrix:
    return sp.diags([-np.ones(n - 1), np.ones(n - 1)], [-1, 1], format="csr") / (2.0 * d)


def operator(eps, mu, dx: float, dy: float, omega: float, pml: int, sigma_max: float,
             m: int) -> sp.csr_matrix:
    """A (Nx Ny x Nx Ny), complex128, on the row-major flattening of
    (Nx, Ny) fields; dx is the spacing along the columns (last axis)."""
    eps = np.asarray(eps, np.float64)
    Nx, Ny = eps.shape
    s_r = 1.0 + 1j * sigma_profile(Nx, pml, sigma_max, m) / (omega * EPSILON_0)
    s_c = 1.0 + 1j * sigma_profile(Ny, pml, sigma_max, m) / (omega * EPSILON_0)
    C_c = sp.diags(np.tile(1.0 / s_c, Nx)) @ sp.kron(sp.identity(Nx), central_difference(Ny, dx))
    C_r = sp.diags(np.repeat(1.0 / s_r, Ny)) @ sp.kron(central_difference(Nx, dy), sp.identity(Ny))
    M_mu = sp.diags(1.0 / np.asarray(mu, np.float64).ravel())
    M_eps = sp.diags(eps.ravel())
    A = C_c @ M_mu @ C_c.T + C_r @ M_mu @ C_r.T - omega**2 * M_eps
    return A.tocsr().astype(np.complex128)


def point_sources(shape, positions, omega: float) -> np.ndarray:
    """(K, Nx Ny) right-hand sides of unit point sources at ``positions``."""
    b = np.zeros((len(positions), shape[0] * shape[1]), np.complex128)
    for k, (i, j) in enumerate(positions):
        b[k, i * shape[1] + j] = -1j * omega
    return b


def relative_residuals(A: sp.csr_matrix, b: np.ndarray, x: np.ndarray) -> np.ndarray:
    """||b - A x|| / ||b|| per row of (K, n) arrays, in complex128."""
    x = np.asarray(x).reshape(b.shape).astype(np.complex128)
    r = b - (A @ x.T).T
    return np.linalg.norm(r, axis=1) / np.linalg.norm(b, axis=1)


class Sublattices:
    """A on an even (Nx, Ny) grid as four five-point sublattices, on
    ``device`` in complex128. Fields go in and out as (K, Nx, Ny) tensors."""

    def __init__(self, A: sp.csr_matrix, shape, device):
        Nx, Ny = shape
        if Nx % 2 or Ny % 2:
            raise ValueError(f"the sublattice split needs an even grid, got {shape}")
        self.shape, self.device = (Nx, Ny), torch.device(device)
        nr, nc = Nx // 2, Ny // 2
        n = nr * nc
        idx = np.arange(Nx * Ny).reshape(Nx, Ny)
        order = np.concatenate([idx[p::2, q::2].ravel() for p in (0, 1) for q in (0, 1)])
        P = A.tocsr()[order][:, order].tocsr()
        offsets = (0, 1, -1, nc, -nc)
        diags = {k: [] for k in offsets}
        taken = 0
        for s in range(4):
            block = P[s * n : (s + 1) * n, s * n : (s + 1) * n]
            for k in offsets:
                d = block.diagonal(k)
                diags[k].append(d)
                taken += np.count_nonzero(d)
            # the +-1 diagonals may not couple the end of one row to the next
            for d in (diags[1][-1], diags[-1][-1]):
                if np.count_nonzero(d[nc - 1 :: nc]):
                    raise ValueError("a sublattice row couples to the next across its end")
        if taken != np.count_nonzero(P.data):
            raise ValueError("A is not four decoupled five-point sublattices")

        def dev(k, rows):
            d = np.stack(diags[k])
            d = np.pad(d, ((0, 0), (0, rows * nc - d.shape[1])))
            return torch.as_tensor(d.reshape(4, rows, nc), dtype=torch.complex128,
                                   device=self.device)

        self.d0, self.e, self.w = dev(0, nr), dev(1, nr), dev(-1, nr)  # centre, east, west
        self.up, self.lo = dev(nc, nr - 1), dev(-nc, nr - 1)          # row r to r+1, r+1 to r
        self.inv = None

    def _split(self, x):
        return torch.stack([x[:, p::2, q::2] for p in (0, 1) for q in (0, 1)])

    def _join(self, y):
        x = torch.empty((y.shape[1],) + self.shape, dtype=y.dtype, device=y.device)
        for s, (p, q) in enumerate((p, q) for p in (0, 1) for q in (0, 1)):
            x[:, p::2, q::2] = y[s]
        return x

    def _apply(self, y):
        """A y on split fields (4, K, nr, nc)."""
        d0, e, w = (a[:, None] for a in (self.d0, self.e, self.w))
        out = d0 * y
        out[..., :-1] += e[..., :-1] * y[..., 1:]
        out[..., 1:] += w[..., :-1] * y[..., :-1]
        out[..., :-1, :] += self.up[:, None] * y[..., 1:, :]
        out[..., 1:, :] += self.lo[:, None] * y[..., :-1, :]
        return out

    def apply(self, x):
        return self._join(self._apply(self._split(x.to(torch.complex128))))

    def factor(self):
        """The inverses of the row eliminations' Schur complements, (4, nr,
        nc, nc): S_0 = D_0, S_r = D_r - L_r S_{r-1}^{-1} U_{r-1}."""
        nr, nc = self.d0.shape[1:]
        self.inv = torch.empty((4, nr, nc, nc), dtype=torch.complex128, device=self.device)
        for r in range(nr):
            S = (torch.diag_embed(self.d0[:, r]) + torch.diag_embed(self.e[:, r, :-1], 1)
                 + torch.diag_embed(self.w[:, r, :-1], -1))
            if r:
                S -= self.lo[:, r - 1, :, None] * self.inv[:, r - 1] * self.up[:, r - 1, None, :]
            self.inv[:, r] = torch.linalg.inv(S)
        return self

    def _solve(self, f):
        """A^{-1} f on split fields (4, K, nr, nc), by the stored inverses."""
        f = f.permute(0, 2, 3, 1)                      # (4, nr, nc, K)
        nr = f.shape[1]
        y = torch.empty_like(f)
        y[:, 0] = self.inv[:, 0] @ f[:, 0]
        for r in range(1, nr):
            y[:, r] = self.inv[:, r] @ (f[:, r] - self.lo[:, r - 1, :, None] * y[:, r - 1])
        for r in range(nr - 2, -1, -1):
            y[:, r] -= self.inv[:, r] @ (self.up[:, r, :, None] * y[:, r + 1])
        return y.permute(0, 3, 1, 2)

    def solve(self, b, rounds: int = 3, tol: float = 1e-13):
        """(x, relative residual of each) for (K, Nx, Ny) right-hand sides:
        one solve, then refinement rounds against the same entries until the
        worst residual is under ``tol`` or ``rounds`` are done."""
        if self.inv is None:
            self.factor()
        f = self._split(b.to(torch.complex128))
        fn = torch.linalg.vector_norm(f, dim=(0, 2, 3))
        y = self._solve(f)
        for _ in range(rounds):
            r = f - self._apply(y)
            res = torch.linalg.vector_norm(r, dim=(0, 2, 3)) / fn
            if float(res.max()) <= tol:
                break
            y = y + self._solve(r)
        res = torch.linalg.vector_norm(f - self._apply(y), dim=(0, 2, 3)) / fn
        return self._join(y), res
