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
    relative_residual: float     # a list of floats, one a member, when batched
    iterations: int              # a list of ints when batched


def _identity(r):
    return r


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a)


def _cdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> = sum(conj(a) * b)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def _givens(ab: torch.Tensor, e0: torch.Tensor, norm: Callable) -> torch.Tensor:
    """The 2x2 complex rotation [[c, s], [-conj(s), conj(c)]] that maps
    ``ab = (a, b)`` to (r, 0); the identity when a = b = 0 (``e0`` is (1, 0)
    on the device). With ``ab`` of shape (F, 2) and ``norm`` over its last
    axis, (F, 2, 2): one rotation a member."""
    denom = norm(ab)[..., None]
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    cs = torch.where(denom == 0, e0, ab.conj() / safe)
    return torch.stack([cs, torch.stack([-cs[..., 1].conj(), cs[..., 0].conj()], -1)], -2)


def fgmres(matvec: Callable, b: torch.Tensor, minv: Optional[Callable] = None,
           *, x0: Optional[torch.Tensor] = None, restart: int = 40,
           maxiter: int = 2000, tol: float = 1e-6,
           reorthogonalize: bool = True, batched: bool = False) -> GmresResult:
    """Solve A x = b with restarted right-preconditioned GMRES(restart).

    ``batched=True``: ``b`` is (F, ...), F independent systems that
    ``matvec`` and ``minv`` apply to as one (F, ...) tensor. Dots and norms
    reduce over all but the first axis, and each member keeps its own
    Hessenberg, rotations and residual, so the launches an iteration do not
    grow with F. The loop follows ``jax.vmap`` of the JAX package's
    ``while_loop``: it runs while any member has ``res > tol`` and
    iterations left; a member that has stopped keeps its ``x`` exactly, and
    its residual and iterations are its own. The host reads the (F,)
    residuals once a restart cycle."""
    if minv is None:
        minv = _identity
    dtype, dev = b.dtype, b.device
    m = restart
    if batched:
        def norm(a):
            return torch.linalg.vector_norm(a.flatten(1), dim=1)

        def cdot(a, c):
            return torch.linalg.vecdot(a.flatten(1), c.flatten(1))

        def col(s):  # (F,) scalars against (F, ...) fields
            return s.reshape(s.shape + (1,) * (b.ndim - 1))

        def rotate(G, v):
            return (G @ v[..., None])[..., 0]
    else:
        norm, cdot = _norm, _cdot

        def col(s):
            return s

        def rotate(G, v):
            return G @ v
    lead = b.shape[:1] if batched else ()
    bnorm = norm(b)
    x = torch.zeros_like(b) if x0 is None else x0
    max_cycles = -(-maxiter // m)
    e0 = torch.zeros((2,), dtype=dtype, device=dev)
    e0[0] = 1

    def cycle(x):
        r = b - matvec(x)
        beta = norm(r)
        V = [r / col(torch.where(beta == 0, torch.ones_like(beta), beta))]
        Z = []                     # preconditioned basis M^{-1} v_j
        # Givens-updated QR of the Hessenberg: R (m x m), rhs g (m+1,), a member
        R = torch.zeros(lead + (m, m), dtype=dtype, device=dev)
        g = torch.zeros(lead + (m + 1,), dtype=dtype, device=dev)
        g[..., 0] = beta
        rotations = []
        for j in range(m):
            z = minv(V[j])
            w = matvec(z)
            passes = []
            for _ in range(2 if reorthogonalize else 1):
                hp = []
                for i in range(j + 1):
                    hij = cdot(V[i], w)
                    w = torch.addcmul(w, col(hij), V[i], value=-1)
                    hp.append(hij)
                passes.append(torch.stack(hp, -1))
            hn = norm(w)
            V.append(w / col(torch.where(hn == 0, torch.ones_like(hn), hn)))
            Z.append(z)
            h = torch.cat([sum(passes[1:], passes[0]), hn.to(dtype)[..., None]], -1)
            # apply the accumulated rotations to the new column, then the
            # new rotation annihilating h[j+1]
            for i, G in enumerate(rotations):
                h[..., i : i + 2] = rotate(G, h[..., i : i + 2])
            G = _givens(h[..., j : j + 2], e0, norm)
            rotations.append(G)
            h[..., j : j + 2] = rotate(G, h[..., j : j + 2])
            h[..., j + 1] = 0
            g[..., j : j + 2] = rotate(G, g[..., j : j + 2])
            R[..., : j + 1, j] = h[..., : j + 1]
        # guarded back-substitution R y = g[:m]
        y = torch.zeros(lead + (m,), dtype=dtype, device=dev)
        for j in range(m - 1, -1, -1):
            if batched:
                num = g[:, j] - (R[:, j, j + 1 :] * y[:, j + 1 :]).sum(-1)
            else:
                num = g[j] - torch.dot(R[j, j + 1 :], y[j + 1 :])
            rjj = R[..., j, j]
            zero = rjj.abs() == 0
            y[..., j] = torch.where(zero, torch.zeros_like(num),
                                    num / torch.where(zero, torch.ones_like(rjj), rjj))
        if batched:
            for j in range(m):
                x = torch.addcmul(x, col(y[:, j]), Z[j])
        else:
            x = x + torch.tensordot(y, torch.stack(Z), dims=1)
        return x, norm(b - matvec(x)) / bnorm

    safe_bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    res_dev = norm(b - matvec(x)) / safe_bnorm
    if not batched:
        res = float(res_dev)
        it = 0
        while res > tol and it < max_cycles * m:
            x, res_dev = cycle(x)
            res = float(res_dev)
            it += m
        return GmresResult(x=x, relative_residual=res, iterations=it)

    res = res_dev.tolist()
    its = [0] * len(res)
    while True:
        active = [r > tol and i < max_cycles * m for r, i in zip(res, its)]
        if not any(active):
            break
        x_new, res_new = cycle(x)
        keep = torch.tensor(active, device=dev)
        x = torch.where(col(keep), x_new, x)
        res_dev = torch.where(keep, res_new, res_dev)
        res = res_dev.tolist()
        its = [i + m * a for i, a in zip(its, active)]
    return GmresResult(x=x, relative_residual=res, iterations=its)
