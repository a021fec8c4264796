"""Exact FDFD solutions at sizes where the four sublattices' inverses do not
fit on the card at once.

``OneAtATime`` is reference/fdfd.py's ``Sublattices``: the same entries taken
out of the same scipy operator (``operator``), the same dense block
elimination in complex128 on the device, the same refinement against the
same entries. It factors, solves and frees one sublattice at a time, so its
store is one sublattice's (nr, nc, nc) inverses: 17.2 GB at 2048^2, where
the four at once take 68.7 GB. A solve factors every sublattice anew, so a
caller solves all its right-hand sides in one call.

This module imports nothing of the measured program.
"""

from __future__ import annotations

import copy

import torch

from portbench.reference.fdfd import Sublattices


class OneAtATime(Sublattices):
    """A on an even (Nx, Ny) grid as four five-point sublattices, each
    factored only while its right-hand sides are solved."""

    def factor(self):
        """The inverses of the row eliminations' Schur complements of every
        sublattice this object holds, (S, nr, nc, nc): S_0 = D_0,
        S_r = D_r - L_r S_{r-1}^{-1} U_{r-1}."""
        S, nr, nc = self.d0.shape
        self.inv = torch.empty((S, nr, nc, nc), dtype=torch.complex128, device=self.device)
        for r in range(nr):
            A = (torch.diag_embed(self.d0[:, r]) + torch.diag_embed(self.e[:, r, :-1], 1)
                 + torch.diag_embed(self.w[:, r, :-1], -1))
            if r:
                A -= self.lo[:, r - 1, :, None] * self.inv[:, r - 1] * self.up[:, r - 1, None, :]
            self.inv[:, r] = torch.linalg.inv(A)
        return self

    def _one(self, s: int) -> "OneAtATime":
        """Sublattice ``s`` alone (its entries on a leading axis of 1), factored."""
        one = copy.copy(self)
        for name in ("d0", "e", "w", "up", "lo"):
            setattr(one, name, getattr(self, name)[s : s + 1])
        return one.factor()

    def solve(self, b, rounds: int = 3, tol: float = 1e-13):
        """(x, relative residual of each) for (K, Nx, Ny) right-hand sides:
        for each sublattice in turn, its factor, one solve and refinement
        rounds against its entries until its part of every residual is
        under ``tol`` of that right-hand side's whole norm or ``rounds`` are
        done; then the factor is freed."""
        f = self._split(b.to(torch.complex128))
        fn = torch.linalg.vector_norm(f, dim=(0, 2, 3))
        y = torch.empty_like(f)
        for s in range(4):
            one, fs = self._one(s), f[s : s + 1]
            ys = one._solve(fs)
            for _ in range(rounds):
                r = fs - one._apply(ys)
                if float((torch.linalg.vector_norm(r, dim=(0, 2, 3)) / fn).max()) <= tol:
                    break
                ys = ys + one._solve(r)
            y[s] = ys[0]
            del one, ys
        res = torch.linalg.vector_norm(f - self._apply(y), dim=(0, 2, 3)) / fn
        return self._join(y), res
