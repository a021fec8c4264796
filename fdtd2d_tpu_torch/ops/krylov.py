"""Right-preconditioned restarted flexible GMRES (counterpart of
``fdtd2d_tpu/ops/krylov.py``), with its numerics:

- modified Gram-Schmidt with one reorthogonalization pass (MGS2): single-pass
  MGS loses orthogonality and stalls the restart cycles in complex64;
- the small least-squares problem is solved by incremental complex Givens
  rotations (QR), not normal equations (which square the condition number);
- a guarded back-substitution (a zero pivot gives a zero coefficient);
- iterations are counted in whole restart cycles: a cycle always runs its
  full Arnoldi loop.

Right preconditioning solves A M^{-1} u = b, x = M^{-1} u, so convergence is
measured on the TRUE residual. The preconditioned vectors Z_j are stored
(flexible GMRES), so variable preconditioners are supported.

Every scalar of the Arnoldi and Givens recurrences stays on the device; the
host reads one residual per restart cycle, for the stopping test.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class GmresResult(NamedTuple):
    x: torch.Tensor
    relative_residual: float
    iterations: int


def _identity(r):
    return r


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a)


def _cdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> = sum(conj(a) * b)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def _givens(ab: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """The 2x2 complex rotation [[c, s], [-conj(s), conj(c)]] that maps
    ``ab = (a, b)`` to (r, 0); the identity when a = b = 0 (``e0`` is (1, 0)
    on the device)."""
    denom = _norm(ab)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    cs = torch.where(denom == 0, e0, ab.conj() / safe)
    return torch.stack([cs, torch.stack([-cs[1].conj(), cs[0].conj()])])


def fgmres(matvec: Callable, b: torch.Tensor, minv: Optional[Callable] = None,
           *, x0: Optional[torch.Tensor] = None, restart: int = 40,
           maxiter: int = 2000, tol: float = 1e-6,
           reorthogonalize: bool = True) -> GmresResult:
    """Solve A x = b with restarted right-preconditioned GMRES(restart)."""
    if minv is None:
        minv = _identity
    dtype, dev = b.dtype, b.device
    m = restart
    bnorm = _norm(b)
    x = torch.zeros_like(b) if x0 is None else x0
    max_cycles = -(-maxiter // m)
    e0 = torch.zeros((2,), dtype=dtype, device=dev)
    e0[0] = 1

    def cycle(x):
        r = b - matvec(x)
        beta = _norm(r)
        V = [r / torch.where(beta == 0, torch.ones_like(beta), beta)]
        Z = []                     # preconditioned basis M^{-1} v_j
        # Givens-updated QR of the Hessenberg: R (m x m), rhs g (m+1,)
        R = torch.zeros((m, m), dtype=dtype, device=dev)
        g = torch.zeros((m + 1,), dtype=dtype, device=dev)
        g[0] = beta
        rotations = []
        for j in range(m):
            z = minv(V[j])
            w = matvec(z)
            passes = []
            for _ in range(2 if reorthogonalize else 1):
                hp = []
                for i in range(j + 1):
                    hij = _cdot(V[i], w)
                    w = torch.addcmul(w, hij, V[i], value=-1)
                    hp.append(hij)
                passes.append(torch.stack(hp))
            hn = _norm(w)
            V.append(w / torch.where(hn == 0, torch.ones_like(hn), hn))
            Z.append(z)
            h = torch.cat([sum(passes[1:], passes[0]), hn.to(dtype)[None]])
            # apply the accumulated rotations to the new column, then the
            # new rotation annihilating h[j+1]
            for i, G in enumerate(rotations):
                h[i : i + 2] = G @ h[i : i + 2]
            G = _givens(h[j : j + 2], e0)
            rotations.append(G)
            h[j : j + 2] = G @ h[j : j + 2]
            h[j + 1] = 0
            g[j : j + 2] = G @ g[j : j + 2]
            R[: j + 1, j] = h[: j + 1]
        # guarded back-substitution R y = g[:m]
        y = torch.zeros((m,), dtype=dtype, device=dev)
        for j in range(m - 1, -1, -1):
            num = g[j] - torch.dot(R[j, j + 1 :], y[j + 1 :])
            rjj = R[j, j]
            zero = rjj.abs() == 0
            y[j] = torch.where(zero, torch.zeros_like(num),
                               num / torch.where(zero, torch.ones_like(rjj), rjj))
        x = x + torch.tensordot(y, torch.stack(Z), dims=1)
        return x, _norm(b - matvec(x)) / bnorm

    safe_bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    res = float(_norm(b - matvec(x)) / safe_bnorm)
    it = 0
    while res > tol and it < max_cycles * m:
        x, res_dev = cycle(x)
        res = float(res_dev)
        it += m
    return GmresResult(x=x, relative_residual=res, iterations=it)
