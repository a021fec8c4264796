"""Krylov solvers on torch tensors (counterpart of ``fdtd2d_tpu/ops/krylov.py``
and of the ``jax.scipy.sparse.linalg`` solvers that the JAX package's
``solve_fdfd`` calls).

:func:`fgmres`, right-preconditioned restarted flexible GMRES, with the JAX
module's numerics:

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

:func:`bicgstab` and :func:`gmres` follow ``jax.scipy.sparse.linalg``'s
``bicgstab`` and ``gmres(solve_method="batched")`` step by step: the
stopping rule ``||r|| <= max(tol ||b||, atol)``, their preconditioning sides
(BiCGSTAB right, GMRES left: it measures ``||M (b - A x)||`` against that
bound), their breakdown guards and GMRES's restart.

Every scalar of the recurrences stays on the device; the host reads one
residual a restart cycle (FGMRES, GMRES) or an iteration (BiCGSTAB), for the
stopping test. The loops take their vector operations from a
:class:`Vectors` object, so that the same loop runs on tensors (the default)
and on fields cut into blocks over a mesh (``parallel/sharded.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class Vectors:
    """The vector operations of the Krylov loops on tensors: zeros, the
    difference, scaling by a device scalar, the scaled sum, the dot, the
    norm, and the combination of a basis. With ``batched`` the vectors are
    (F, ...) stacks of F independent systems: dots and norms reduce over all
    but the first axis and scalars are (F,)."""

    def __init__(self, batched: bool = False):
        self.batched = batched

    def scalar_like(self, b):
        """(dtype, device) of the recurrences' scalars for right-hand side b."""
        return b.dtype, b.device

    def numel(self, b) -> int:
        return b.numel()

    def zeros_like(self, a):
        return torch.zeros_like(a)

    def add(self, a, c):
        return a + c

    def sub(self, a, c):
        return a - c

    def scale(self, a, s):
        return a * self.col(s, a)

    def col(self, s, a):
        """Scalars ``s`` shaped to broadcast against the vectors ``a``."""
        return s.reshape(s.shape + (1,) * (a.ndim - 1)) if self.batched else s

    def div(self, a, s):
        return a / self.col(s, a)

    def add_scaled(self, a, s, v, sign: int = 1):
        """a + sign * s v."""
        return torch.addcmul(a, self.col(s, v), v, value=sign)

    def dot(self, a, c):
        """<a, c> = sum(conj(a) * c)."""
        if self.batched:
            return torch.linalg.vecdot(a.flatten(1), c.flatten(1))
        return torch.vdot(a.reshape(-1), c.reshape(-1))

    def norm(self, a):
        if self.batched:
            return torch.linalg.vector_norm(a.flatten(1), dim=1)
        return torch.linalg.vector_norm(a)

    def combine(self, x, y, Z):
        """x + sum_j y_j Z_j (``y`` is (m,), (F, m) when batched)."""
        if self.batched:
            for j in range(len(Z)):
                x = torch.addcmul(x, self.col(y[:, j], x), Z[j])
            return x
        return x + torch.tensordot(y, torch.stack(Z), dims=1)

    def where(self, keep, a, c):
        """``a`` where ``keep`` (a device bool, (F,) when batched), else ``c``."""
        return torch.where(self.col(keep, a), a, c)


class GmresResult(NamedTuple):
    x: torch.Tensor
    relative_residual: float     # a list of floats, one a member, when batched
    iterations: int              # a list of ints when batched


def _identity(r):
    return r


def _givens(ab: torch.Tensor, e0: torch.Tensor) -> torch.Tensor:
    """The 2x2 complex rotation [[c, s], [-conj(s), conj(c)]] that maps
    ``ab = (a, b)`` to (r, 0); the identity when a = b = 0 (``e0`` is (1, 0)
    on the device). With ``ab`` of shape (F, 2), (F, 2, 2): one rotation a
    member."""
    denom = torch.linalg.vector_norm(ab, dim=-1)[..., None]
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    cs = torch.where(denom == 0, e0, ab.conj() / safe)
    return torch.stack([cs, torch.stack([-cs[..., 1].conj(), cs[..., 0].conj()], -1)], -2)


def fgmres(matvec: Callable, b, minv: Optional[Callable] = None,
           *, x0=None, restart: int = 40,
           maxiter: int = 2000, tol: float = 1e-6,
           reorthogonalize: bool = True, batched: bool = False,
           vectors: Optional[Vectors] = None) -> GmresResult:
    """Solve A x = b with restarted right-preconditioned GMRES(restart).

    ``batched=True``: ``b`` is (F, ...), F independent systems that
    ``matvec`` and ``minv`` apply to as one (F, ...) tensor. Dots and norms
    reduce over all but the first axis, and each member keeps its own
    Hessenberg, rotations and residual, so the launches an iteration do not
    grow with F. The loop follows ``jax.vmap`` of the JAX package's
    ``while_loop``: it runs while any member has ``res > tol`` and
    iterations left; a member that has stopped keeps its ``x`` exactly, and
    its residual and iterations are its own. The host reads the (F,)
    residuals once a restart cycle.

    ``vectors``: the vector operations (default :class:`Vectors` on tensors,
    batched as ``batched`` says); ``b``, ``x0`` and what ``matvec`` and
    ``minv`` take and return are its vectors."""
    if minv is None:
        minv = _identity
    ops = Vectors(batched) if vectors is None else vectors
    batched = ops.batched
    dtype, dev = ops.scalar_like(b)
    m = restart
    if batched:
        def rotate(G, v):
            return (G @ v[..., None])[..., 0]
    else:
        def rotate(G, v):
            return G @ v
    norm = ops.norm
    lead = (len(b),) if batched else ()
    bnorm = norm(b)
    x = ops.zeros_like(b) if x0 is None else x0
    max_cycles = -(-maxiter // m)
    e0 = torch.zeros((2,), dtype=dtype, device=dev)
    e0[0] = 1

    def cycle(x):
        r = ops.sub(b, matvec(x))
        beta = norm(r)
        V = [ops.div(r, torch.where(beta == 0, torch.ones_like(beta), beta))]
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
                    hij = ops.dot(V[i], w)
                    w = ops.add_scaled(w, hij, V[i], -1)
                    hp.append(hij)
                passes.append(torch.stack(hp, -1))
            hn = norm(w)
            V.append(ops.div(w, torch.where(hn == 0, torch.ones_like(hn), hn)))
            Z.append(z)
            h = torch.cat([sum(passes[1:], passes[0]), hn.to(dtype)[..., None]], -1)
            # apply the accumulated rotations to the new column, then the
            # new rotation annihilating h[j+1]
            for i, G in enumerate(rotations):
                h[..., i : i + 2] = rotate(G, h[..., i : i + 2])
            G = _givens(h[..., j : j + 2], e0)
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
        x = ops.combine(x, y, Z)
        return x, norm(ops.sub(b, matvec(x))) / bnorm

    safe_bnorm = torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    res_dev = norm(ops.sub(b, matvec(x))) / safe_bnorm
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
        x = ops.where(keep, x_new, x)
        res_dev = torch.where(keep, res_new, res_dev)
        res = res_dev.tolist()
        its = [i + m * a for i, a in zip(its, active)]
    return GmresResult(x=x, relative_residual=res, iterations=its)


class IterativeResult(NamedTuple):
    """``x`` and the iterations a loop ran: BiCGSTAB's iterations, GMRES's
    Arnoldi steps (restart cycles times the restart length)."""
    x: torch.Tensor
    iterations: int


def bicgstab(matvec: Callable, b, minv: Optional[Callable] = None, *, x0=None,
             tol: float = 1e-5, atol: float = 0.0, maxiter: Optional[int] = None,
             vectors: Optional[Vectors] = None) -> IterativeResult:
    """Right-preconditioned BiCGSTAB, step for step
    ``jax.scipy.sparse.linalg.bicgstab`` (scipy's non-legacy tolerance): it
    runs while ``||r||^2 > max(tol^2 ||b||^2, atol^2)``, fewer than
    ``maxiter`` iterations have run (default 10 x the unknowns) and no
    breakdown has happened (``rho = 0``, ``alpha = 0`` or ``omega = 0``
    ends it, keeping that iteration's update); an iteration whose
    intermediate residual ``s`` already meets the bound takes only its first
    half-step. The host reads one flag an iteration."""
    if minv is None:
        minv = _identity
    ops = Vectors() if vectors is None else vectors
    dtype, dev = ops.scalar_like(b)
    if maxiter is None:
        maxiter = 10 * ops.numel(b)
    x = ops.zeros_like(b) if x0 is None else x0
    bs = ops.norm(b) ** 2
    atol2 = torch.maximum(tol**2 * bs, torch.as_tensor(atol**2, dtype=bs.dtype, device=dev))
    r = ops.sub(b, matvec(x))
    rhat, p, q = r, r, r
    one = torch.ones((), dtype=dtype, device=dev)
    alpha = omega = rho = one
    go = ops.norm(r) ** 2 > atol2
    k = 0
    while k < maxiter and bool(go):
        rho_ = ops.dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = ops.add_scaled(r, beta, ops.add_scaled(p, omega, q, -1))
        phat = minv(p)
        q = matvec(phat)
        alpha_ = rho_ / ops.dot(rhat, q)
        s = ops.add_scaled(r, alpha_, q, -1)
        exit_early = ops.norm(s) ** 2 < atol2
        shat = minv(s)
        t = matvec(shat)
        omega_ = ops.dot(t, s) / ops.dot(t, t)
        x = ops.where(exit_early, ops.add_scaled(x, alpha_, phat),
                      ops.add(x, ops.add_scaled(ops.scale(phat, alpha_), omega_, shat)))
        r = ops.where(exit_early, s, ops.add_scaled(s, omega_, t, -1))
        alpha, omega, rho = alpha_, omega_, rho_
        k += 1
        # a breakdown ends the loop, as JAX's negative counters (-11, -10) do
        broke = (omega == 0) | (alpha == 0) | (rho == 0)
        go = (ops.norm(r) ** 2 > atol2) & ~broke
    return IterativeResult(x=x, iterations=k)


def gmres(matvec: Callable, b, minv: Optional[Callable] = None, *, x0=None,
          tol: float = 1e-5, atol: float = 0.0, restart: int = 20,
          maxiter: Optional[int] = None, vectors: Optional[Vectors] = None) -> IterativeResult:
    """Left-preconditioned restarted GMRES, step for step
    ``jax.scipy.sparse.linalg.gmres(solve_method="batched")``.

    Each restart cycle runs the Arnoldi process on ``M A`` from the
    normalized preconditioned residual: one classical Gram-Schmidt pass (JAX's
    "twice is enough" loop condition ``k < max_iterations - 1`` ends after
    the first pass), a new vector taken as zero when its norm is under eps
    times its norm before the projection (a breakdown, which ends the cycle's
    Arnoldi loop and leaves identity rows in the Hessenberg), then the
    normal equations of the (restart + 1) x restart least-squares problem by
    Cholesky. Cycles run while fewer than ``maxiter`` (default 10 x the
    unknowns) have run and ``||M (b - A x)|| > max(tol ||b||, atol)``: the
    preconditioned residual against the unpreconditioned bound, as in JAX
    (where ``M`` shrinks norms by orders of magnitude, as the FDM inverse
    does, a loose ``tol`` ends the solve at ``x0``). Norms under the dtype's
    eps count as zero. The host reads one norm a cycle; the breakdown test
    stays on the device."""
    if minv is None:
        minv = _identity
    ops = Vectors() if vectors is None else vectors
    dtype, dev = ops.scalar_like(b)
    eps = torch.finfo(torch.empty((), dtype=dtype).real.dtype).eps
    size = ops.numel(b)
    if maxiter is None:
        maxiter = 10 * size
    restart = min(restart, size)
    x = ops.zeros_like(b) if x0 is None else x0
    bound = float(torch.clamp(tol * ops.norm(b), min=atol))

    def safe_normalize(v, thresh=eps):
        n = ops.norm(v)
        use = n > thresh
        return (ops.where(use, ops.div(v, n.to(dtype)), ops.zeros_like(v)),
                torch.where(use, n, torch.zeros_like(n)))

    def cycle(x, unit, rnorm):
        V = [unit]
        H = torch.eye(restart, restart + 1, dtype=dtype, device=dev)
        alive = torch.ones((), dtype=torch.bool, device=dev)
        for k in range(restart):
            v = minv(matvec(V[k]))
            _, vn0 = safe_normalize(v)
            h = torch.stack([ops.dot(V[i], v) for i in range(k + 1)])
            v = ops.sub(v, ops.combine(ops.zeros_like(v), h, V))
            unit_v, vn1 = safe_normalize(v, thresh=eps * vn0)
            V.append(unit_v)
            row = torch.cat([h, vn1.to(dtype)[None],
                             torch.zeros(restart - k - 1, dtype=dtype, device=dev)])
            H[k] = torch.where(alive, row, H[k])
            alive = alive & (vn1 != 0)
        beta = torch.zeros(restart + 1, dtype=dtype, device=dev)
        beta[0] = rnorm.to(dtype)
        # JAX's _lstsq: the normal equations of H^T y = beta, solved as
        # positive definite
        Hc = H.conj()
        y = torch.cholesky_solve((Hc @ beta)[:, None], torch.linalg.cholesky(Hc @ H.T))[:, 0]
        x = ops.combine(x, y, V[:restart])
        unit, rnorm = safe_normalize(minv(ops.sub(b, matvec(x))))
        return x, unit, rnorm

    unit, rnorm = safe_normalize(minv(ops.sub(b, matvec(x))))
    k = 0
    while k < maxiter and float(rnorm) > bound:
        x, unit, rnorm = cycle(x, unit, rnorm)
        k += 1
    return IterativeResult(x=x, iterations=k * restart)
