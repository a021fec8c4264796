"""Tiled FDFD: overlapping-patch domain decomposition (Schwarz methods).

Counterpart of ``fdtd2d_tpu/fdfd/tiled.py``, with the same functions and
defaults on torch tensors:

- uniform patch windows of W = patch_size + 2 padding, clamped inside the
  domain, so every patch solve of a sweep is one batched FGMRES
  (``fgmres(..., batched=True)``) over a patch-stacked operator
  (``stack_patch_operators``: eps and 1/mu gathered as (P, W, W) windows in
  one index from the whole grids; omega, the spacing and the local stretch
  vectors shared);
- ``mode="krylov"`` / :class:`TiledSolver`: the two-level preconditioner
  (the global FDM inverse as the coarse level plus partition-of-unity ORAS
  patch corrections, combined by a residual-minimizing step) inside a
  global FGMRES, wrapped in complex128 iterative refinement
  (fdfd/refine.py) where the JAX package uses its split-complex float64
  operator;
- ``mode="additive"`` (damped concurrent RAS sweep) and
  ``mode="multiplicative"`` (the reference's sequential source-outward
  sweep), with the Dirichlet ring imposed matrix-free.

Windows are read and corrections written back through one flat index of the
patch cover (``patch_flat_indices``): a gather, and one ``index_add_`` into
the flat grid. The JAX module's class docstring records the measured reasons
for each ingredient of the two-level preconditioner and its applicability
boundary (mild contrast, moderate electrical size).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fdtd2d_tpu_torch.fdfd.refine import refine, true_relative_residual
from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner, fdm_preconditioner_for
from fdtd2d_tpu_torch.ops.helmholtz import (HelmholtzOperator, _real_dtype, make_operator,
                                            stretch_factors)
from fdtd2d_tpu_torch.ops.krylov import fgmres


def generate_patches(Nx: int, Ny: int, patch_size: int, padding: int) -> np.ndarray:
    """Uniform-size patch origins: windows of W = patch_size + 2*padding
    centered like the reference's (tiled_solver.py:143-153) but clamped to
    stay inside the domain. Returns (P, 2) int array of (x0, y0)."""
    W = patch_size + 2 * padding
    assert Nx >= W and Ny >= W, f"grid {Nx}x{Ny} smaller than patch window {W}"
    xs = [min(max(0, c - W // 2), Nx - W) for c in range(patch_size // 2, Nx, patch_size)]
    ys = [min(max(0, c - W // 2), Ny - W) for c in range(patch_size // 2, Ny, patch_size)]
    xs.append(Nx - W)  # make sure the far edge is covered
    ys.append(Ny - W)
    return np.array([(x, y) for x in sorted(set(xs)) for y in sorted(set(ys))])


def bfs_order(origins: np.ndarray, W: int, source: np.ndarray, halo: int) -> np.ndarray:
    """Source-outward BFS distances over the patch-overlap graph
    (reference tiled_solver.py:159-185). Returns (P,) distances."""
    P = len(origins)
    src = np.asarray(source) != 0
    dist = np.full(P, np.iinfo(np.int32).max, np.int64)
    frontier = []
    for idx, (x0, y0) in enumerate(origins):
        if np.any(src[x0 + halo : x0 + W - halo, y0 + halo : y0 + W - halo]):
            dist[idx] = 0
            frontier.append(idx)
    d = 0
    while frontier:
        d += 1
        nxt = []
        for i in frontier:
            ax0, ay0 = origins[i]
            for j in range(P):
                if dist[j] <= d:
                    continue
                bx0, by0 = origins[j]
                if (ax0 <= bx0 + W and bx0 <= ax0 + W
                        and ay0 <= by0 + W and by0 <= ay0 + W):
                    dist[j] = d
                    nxt.append(j)
        frontier = nxt
    dist[dist == np.iinfo(np.int32).max] = d + 1
    return dist


RING_WIDTH = 2  # the distance-2 "outrigger" stencil needs a 2-cell clamp


def pou_weights(origins: np.ndarray, W: int, Nx: int, Ny: int,
                pml: int, padding: int) -> np.ndarray:
    """Smooth partition of unity over the patch cover: zero across each
    patch's local PML ring, cosine ramp over the remaining overlap, 1 in the
    core; normalized so the per-cell weights over all covering patches sum
    to 1 (0 in the thin boundary ring no core covers). Hard ownership seams
    put O(||A|| * jump) spikes into A z."""
    t1 = np.zeros(W)
    for i in range(W):
        d = min(i, W - 1 - i)
        if d <= pml:
            t1[i] = 0.0
        elif d >= padding:
            t1[i] = 1.0
        else:
            t1[i] = 0.5 * (1 - np.cos(np.pi * (d - pml) / (padding - pml)))
    wpatch = t1[:, None] * t1[None, :]
    wsum = np.zeros((Nx, Ny))
    for (x0, y0) in origins:
        wsum[x0 : x0 + W, y0 : y0 + W] += wpatch
    return np.stack([
        wpatch / np.maximum(wsum[x0 : x0 + W, y0 : y0 + W], 1e-30)
        for (x0, y0) in origins])


def patch_flat_indices(origins: np.ndarray, W: int, Ny: int) -> np.ndarray:
    """(P*W*W,) flat indices of the patch windows in the (Nx, Ny) grid, in
    (P, W, W) order: the gather of the windows and the overlapping
    write-back."""
    aw = np.arange(W)
    return ((origins[:, 0, None, None] + aw[None, :, None]) * Ny
            + (origins[:, 1, None, None] + aw[None, None, :])).ravel()


def _windows(a: torch.Tensor, flat_idx: torch.Tensor, W: int) -> torch.Tensor:
    """(P, W, W) windows of an (Nx, Ny) tensor, real or complex: one gather
    (the JAX package's ``_extract_real_windows`` and the window slices of
    its ``_oras_apply``)."""
    return a.reshape(-1).index_select(0, flat_idx).reshape(-1, W, W)


def stack_patch_operators(eps, mu, origins: np.ndarray, W: int, dx, dy,
                          omega: float, pml_thickness: int,
                          dtype, device="cuda") -> HelmholtzOperator:
    """The local-PML patch operators as ONE patch-stacked HelmholtzOperator
    (eps and 1/mu (P, W, W), gathered on the device from the whole grids in
    one index; omega, the spacing and the local stretch vectors shared by
    every patch)."""
    real = _real_dtype(dtype)
    Ny = np.shape(eps)[1]
    flat_idx = torch.as_tensor(patch_flat_indices(np.asarray(origins), W, Ny), device=device)
    eps_d = torch.as_tensor(np.asarray(eps), device=device).to(real)
    imu_d = (1.0 / torch.as_tensor(np.asarray(mu), device=device)).to(real)
    s_r, s_c = stretch_factors(W, W, float(omega), pml_thickness, 2.0, 3)

    def scalar(v):
        return torch.tensor(v, dtype=real, device=device)

    return HelmholtzOperator(
        eps=_windows(eps_d, flat_idx, W), inv_mu=_windows(imu_d, flat_idx, W),
        inv_s_row=torch.as_tensor(1.0 / s_r).to(device=device, dtype=dtype),
        inv_s_col=torch.as_tensor(1.0 / s_c).to(device=device, dtype=dtype),
        omega=scalar(float(omega)),
        inv_2dx=scalar(1.0 / (2.0 * float(dx))),
        inv_2dy=scalar(1.0 / (2.0 * float(dy))),
        pml_thickness=pml_thickness, sigma_max=2.0, m=3,
    )


def _patch(ops_stacked: HelmholtzOperator, p: int) -> HelmholtzOperator:
    """Patch ``p`` of a patch-stacked operator, as a stack of one."""
    return dataclasses.replace(ops_stacked, eps=ops_stacked.eps[p : p + 1],
                               inv_mu=ops_stacked.inv_mu[p : p + 1])


def _ring_mask(W: int, halo: int) -> np.ndarray:
    """The Dirichlet ring: a RING_WIDTH-cell band at offset ``halo`` from the
    window edge. The reference clamps a 1-cell ring (tiled_solver.py:62-99),
    but the operator couples cells at distance 2, so a 1-cell ring lets the
    interior see the locally-PML'd halo band and the Schwarz fixed point is
    biased. Two cells shield the stencil completely."""
    rw = RING_WIDTH
    mask = np.zeros((W, W), bool)
    mask[halo : halo + rw, halo : W - halo] = True
    mask[W - halo - rw : W - halo, halo : W - halo] = True
    mask[halo : W - halo, halo : halo + rw] = True
    mask[halo : W - halo, W - halo - rw : W - halo] = True
    return mask


def _solve_patches_batched(ops_stacked, M, rings, bvals, rhs, tol, maxiter):
    """Masked-Dirichlet FGMRES(30) over the patch batch, one batched solve
    (each patch stops on its own, as under ``jax.vmap``).

    ``rings`` is a per-patch (P, W, W) clamp mask (or broadcastable)."""

    def matvec(x):
        return torch.where(rings, x, ops_stacked.apply(x))

    def minv(r):
        return torch.where(rings, r, M(r))

    rhs_masked = torch.where(rings, bvals, rhs)
    return fgmres(matvec, rhs_masked, minv, restart=30, maxiter=maxiter, tol=tol,
                  batched=True).x


def _oras_apply(r2, gop, ops_k, M, weights, flat_idx, *, W: int, inner: int):
    """PoU-blended ORAS patch correction of an (Nx, Ny) residual: the window
    gather, one batched FGMRES(inner) of ``inner`` iterations over the
    patches, the weights, and one scatter-add into the flat grid."""
    Nx, Ny = gop.shape
    rloc = _windows(r2, flat_idx, W)
    # restart=inner: fgmres's cost granularity is the restart cycle; no
    # reorthogonalization: a preconditioner needs 1-2 digits locally
    sols = fgmres(ops_k.apply, rloc, M, restart=inner, maxiter=inner, tol=1e-12,
                  reorthogonalize=False, batched=True).x * weights
    z = torch.zeros((Nx * Ny, 2), dtype=weights.dtype, device=r2.device)
    z.index_add_(0, flat_idx, torch.view_as_real(sols).reshape(-1, 2))
    return torch.view_as_complex(z).reshape(Nx, Ny)


def _residual_min_step(r2, z2, gop):
    """(alpha, A z2): the complex step alpha = <A z2, r2> / ||A z2||^2 that
    minimizes ||r2 - alpha A z2||, on the device."""
    az2 = gop.apply(z2)
    denom = torch.linalg.vector_norm(az2) ** 2
    alpha = torch.vdot(az2.reshape(-1), r2.reshape(-1)) / torch.where(
        denom == 0, torch.ones_like(denom), denom)
    return alpha, az2


def _solve_global_two_level(bb, gop, ops_k, M, Mg, weights, flat_idx, *, W, maxiter,
                            tol, inner, restart, use_patches: bool = True):
    """Two-level (coarse FDM + PoU-ORAS patches) preconditioned FGMRES on the
    global operator."""

    def two_level(r):
        r2d = r.reshape(gop.shape)
        z1 = Mg(r2d)
        if not use_patches:
            # adaptive second level (TiledSolver probe): the coarse level
            # alone is the same preconditioner at roughly half the price
            return z1
        r2 = r2d - gop.apply(z1)
        z2 = _oras_apply(r2, gop, ops_k, M, weights, flat_idx, W=W, inner=inner)
        alpha, _ = _residual_min_step(r2, z2, gop)
        return z1 + alpha * z2

    return fgmres(gop.apply, bb, two_level, restart=restart, maxiter=maxiter, tol=tol)


def _probe_patch_benefit(bb, gop, ops_k, M, Mg, weights, flat_idx, *, W, inner):
    """One application of each preconditioner level on r = bb: returns the
    residual contractions (||r - A z_coarse||/||r||, ||r - A z_two||/||r||)
    as device scalars."""
    rn = torch.linalg.vector_norm(bb)
    z1 = Mg(bb)
    r2 = bb - gop.apply(z1)
    c_coarse = torch.linalg.vector_norm(r2) / rn
    z2 = _oras_apply(r2, gop, ops_k, M, weights, flat_idx, W=W, inner=inner)
    alpha, az2 = _residual_min_step(r2, z2, gop)
    c_two = torch.linalg.vector_norm(r2 - alpha * az2) / rn
    return c_coarse, c_two


class TiledSolver:
    """Build-once / solve-many two-level tiled FDFD solver for one scene
    (the JAX package's ``TiledSolver``, whose docstring records the measured
    reasons for the coarse FDM level, the local-PML ORAS patches, the
    partition of unity and the residual-minimizing step).

    Construction does the host-side set-up and the transfers (scene fields,
    FDM eigenfactors, partition-of-unity weights, the complex128 residual
    operator); :meth:`solve` then runs on the device. ``outer_iterations``
    holds the global FGMRES iterations of each refinement round of the last
    solve.
    """

    def __init__(self, eps, mu, dx, dy, omega, *, patch_size: int = 100,
                 padding: int = 30, pml_thickness: int = 10,
                 global_pml_thickness: int = 40, dtype=torch.complex64,
                 inner_iters: int = 2, outer_restart: int | None = None,
                 _prebuilt=None, device="cuda"):
        eps = np.asarray(eps)
        mu = np.asarray(mu)
        self.shape = eps.shape
        Nx, Ny = self.shape
        self.W = W = patch_size + 2 * padding
        self.dtype = dtype
        self.omega = float(omega)
        self.inner_iters = inner_iters
        # the JAX package's memory rule: FGMRES keeps (2 restart + 1) fields,
        # so the default restart is min(60, ~6 GB of basis) (a 16 GB TPU's
        # HBM at 4096^2). It sets the iteration count, so the port keeps it.
        cells = int(np.prod(self.shape))
        if outer_restart is None:
            outer_restart = min(60, max(4, int(6e9 / (2 * cells * 8))))
        self.outer_restart = outer_restart
        real = _real_dtype(dtype)

        if _prebuilt is not None:
            origins, ops_stacked, M = _prebuilt
        else:
            origins = generate_patches(Nx, Ny, patch_size, padding)
            ops_stacked = stack_patch_operators(eps, mu, origins, W, dx, dy, self.omega,
                                                pml_thickness, dtype, device)
            M = fdm_preconditioner(W, W, dx, dy, self.omega, pml_thickness,
                                   eps_ref=float(np.mean(eps)),
                                   mu_ref=1.0 / float(np.mean(1.0 / mu)),
                                   dtype=dtype, device=device)
        self.origins = origins
        self.ops_stacked = ops_stacked
        self.M = M
        self.gop = make_operator(eps, mu, dx, dy, self.omega,
                                 pml_thickness=global_pml_thickness, dtype=dtype, device=device)
        self.Mg = fdm_preconditioner_for(self.gop)
        self.weights = torch.as_tensor(
            pou_weights(origins, W, Nx, Ny, pml_thickness, padding)).to(device, real)
        self.flat_idx = torch.as_tensor(patch_flat_indices(origins, W, Ny), device=device)
        self.op64 = make_operator(torch.as_tensor(eps, dtype=torch.float64),
                                  torch.as_tensor(mu, dtype=torch.float64), dx, dy, self.omega,
                                  pml_thickness=global_pml_thickness, dtype=torch.complex128,
                                  device=device)
        self._patch_decision: bool | None = None  # adaptive probe cache
        self.outer_iterations: list = []

    @property
    def device(self) -> torch.device:
        return self.gop.device

    def _probe_use_patches(self, b) -> bool:
        """Scene-level adaptive second level: apply each preconditioner
        level once and keep the patch corrections only when they buy a
        materially better contraction. The decision is cached: it depends on
        the scene (operator + patches), not on the right-hand side."""
        if self._patch_decision is None:
            cc, ct = _probe_patch_benefit(
                b, self.gop, self.ops_stacked, self.M, self.Mg, self.weights,
                self.flat_idx, W=self.W, inner=self.inner_iters)
            cc, ct = float(cc), float(ct)
            # skip patches only when the coarse level is already strong
            # (contraction < 0.5) AND the patch level improves it < 30%
            self._patch_decision = not (cc < 0.5 and ct > 0.7 * cc)
            self._patch_probe = (cc, ct)
        return self._patch_decision

    def _global_solve(self, rhs, *, maxiter, tol, use_patches):
        out = _solve_global_two_level(
            rhs, self.gop, self.ops_stacked, self.M, self.Mg, self.weights, self.flat_idx,
            W=self.W, maxiter=maxiter, tol=tol, inner=self.inner_iters,
            restart=self.outer_restart, use_patches=use_patches)
        self.outer_iterations.append(out.iterations)
        return out

    def solve(self, source, *, rhs_scale=None, solver_tol: float = 1e-4,
              solver_maxiter: int = 300, refine_target: float | None = 1e-6,
              max_refine_rounds: int = 8, return_split: bool = False,
              adaptive: bool = True, verbose: bool = False):
        """Solve for one source. Returns ``(field, residual_trace)``; the RHS
        is ``rhs_scale * source`` (default ``-1j*omega``, the reference tiled
        convention, tiled_solver.py:57).

        With ``refine_target`` set the trace holds the complex128 iterate's
        true residual per refinement round, plus a final entry: the true
        residual of the returned downcast field. ``return_split=True``
        returns the complex128 solution itself, with no downcast entry.
        Without refinement the trace is the raw solve's relative residual.

        ``adaptive``: probe (once per scene) whether the ORAS patch level
        improves on the coarse FDM contraction; if not, solve with the coarse
        level alone. Pass False to force the full two-level application.
        """
        scale = (-1j * self.omega) if rhs_scale is None else complex(rhs_scale)
        b64 = torch.as_tensor(np.asarray(source), device=self.device).to(torch.complex128) * scale
        b = b64.to(self.dtype)
        use_patches = self._probe_use_patches(b) if adaptive else True
        if verbose and adaptive:
            cc, ct = self._patch_probe
            print(f"patch probe: coarse {cc:.3f} two-level {ct:.3f} -> "
                  f"{'two-level' if use_patches else 'coarse-only'}")
        self.outer_iterations = []
        kw = dict(maxiter=solver_maxiter, tol=solver_tol, use_patches=use_patches)

        if refine_target is not None:
            out = refine(self.op64, b64, lambda rhs: self._global_solve(rhs, **kw).x,
                         target=refine_target, max_rounds=max_refine_rounds,
                         inner_dtype=self.dtype)
            if verbose:
                print(f"krylov tiled (refined): true res={out.relative_residual:.3e} "
                      f"rounds={out.rounds} trace={out.trace}")
            if return_split:
                return out.x, out.trace
            xc = out.x.to(self.dtype)
            # the last entry describes the ARRAY returned (the downcast), not
            # the complex128 iterate it was cut from
            return xc, list(out.trace) + [true_relative_residual(self.op64, b64, xc)]

        out = self._global_solve(b, **kw)
        if verbose:
            print(f"krylov tiled: res={out.relative_residual:.3e} iters={out.iterations}")
        return out.x, [out.relative_residual]


def run_fdfd_tiled(eps, mu, dx, dy, omega, source, *,
                   patch_size: int = 100, padding: int = 30,
                   pml_thickness: int = 10, n_passes: int = 3,
                   relax: float = 0.5, tol: float = 1e-2,
                   mode: str = "krylov", solver_tol: float = 1e-4,
                   solver_maxiter: int = 300, global_pml_thickness: int = 40,
                   inner_iters: int = 2, outer_restart: int | None = None,
                   dtype=torch.complex64, refine_target: float | None = 1e-6,
                   max_refine_rounds: int = 8, verbose: bool = False, device="cuda"):
    """Multi-pass tiled FDFD solve. Returns (field, convergence_trace).

    Parameters mirror the reference driver (tiled_solver.py:117-125); the RHS
    convention is b = -1j*omega*source (tiled_solver.py:57).

    Modes:
    - "krylov" (default): :class:`TiledSolver`; with ``refine_target`` the
      trace is the per-round true residual of the complex128 iterate plus a
      final entry for the returned array; ``refine_target=None`` gives the
      raw single-precision solve.
    - "additive": damped RAS fixed-point iteration (all patches concurrent);
      the trace is each sweep's max |delta|.
    - "multiplicative": the reference's sequential source-outward sweep.
    """
    eps = np.asarray(eps)
    mu = np.asarray(mu)
    source = np.asarray(source)
    Nx, Ny = eps.shape
    W = patch_size + 2 * padding
    halo = pml_thickness

    origins = generate_patches(Nx, Ny, patch_size, padding)
    ops_stacked = stack_patch_operators(eps, mu, origins, W, dx, dy, float(omega),
                                        pml_thickness, dtype, device)
    M = fdm_preconditioner(W, W, dx, dy, float(omega), pml_thickness,
                           eps_ref=float(np.mean(eps)),
                           mu_ref=1.0 / float(np.mean(1.0 / mu)), dtype=dtype, device=device)

    if mode == "krylov":
        solver = TiledSolver(
            eps, mu, dx, dy, omega, patch_size=patch_size, padding=padding,
            pml_thickness=pml_thickness, global_pml_thickness=global_pml_thickness,
            dtype=dtype, inner_iters=inner_iters, outer_restart=outer_restart,
            _prebuilt=(origins, ops_stacked, M), device=device)
        return solver.solve(source, solver_tol=solver_tol, solver_maxiter=solver_maxiter,
                            refine_target=refine_target, max_refine_rounds=max_refine_rounds,
                            verbose=verbose)
    if mode not in ("additive", "multiplicative"):
        raise ValueError(f"unknown mode {mode!r}")

    # ------- stationary-mode-only setup (the reference's own algorithm) -----
    dists = bfs_order(origins, W, source, halo)
    order = np.argsort(dists, kind="stable")
    ring = torch.as_tensor(_ring_mask(W, halo), device=device)
    inner = slice(halo + RING_WIDTH, W - halo - RING_WIDTH)
    flat_idx = torch.as_tensor(patch_flat_indices(origins, W, Ny), device=device)
    b_full = torch.as_tensor(source, device=device).to(torch.complex128) * (-1j * omega)
    rhs = _windows(b_full, flat_idx, W).to(dtype)
    solution = torch.zeros((Nx, Ny), dtype=dtype, device=device)

    # RAS ownership: each cell belongs to the patch (among those whose
    # interior covers it) with the nearest window center.
    owner = np.full((Nx, Ny), -1, np.int32)
    best = np.full((Nx, Ny), np.inf)
    gx, gy = np.mgrid[0:Nx, 0:Ny]
    for p, (x0, y0) in enumerate(origins):
        cx, cy = x0 + W / 2, y0 + W / 2
        d2 = (gx - cx) ** 2 + (gy - cy) ** 2
        h2 = halo + RING_WIDTH  # exclude the clamped ring from ownership
        covers = ((gx >= x0 + h2) & (gx < x0 + W - h2)
                  & (gy >= y0 + h2) & (gy < y0 + W - h2))
        better = covers & (d2 < best)
        owner[better] = p
        best[better] = d2[better]
    valid = owner >= 0
    owner_valid = torch.as_tensor(valid, device=device)
    ox = origins[:, 0][np.maximum(owner, 0)]
    oy = origins[:, 1][np.maximum(owner, 0)]
    # cells no patch owns read window cell (0, 0) of patch 0 (JAX clamps the
    # out-of-range gather); ``owner_valid`` discards them
    owner_idx = torch.as_tensor(np.maximum(owner, 0), dtype=torch.int64, device=device)
    owner_lx = torch.as_tensor(np.where(valid, gx - ox, 0), device=device)
    owner_ly = torch.as_tensor(np.where(valid, gy - oy, 0), device=device)

    deltas = []
    for sweep in range(n_passes):
        if mode == "additive":
            bvals = _windows(solution, flat_idx, W)
            sols = _solve_patches_batched(ops_stacked, M, ring, bvals, rhs, solver_tol,
                                          solver_maxiter)
            # Restricted Additive Schwarz write-back: each cell is owned by
            # exactly one patch (nearest window center)
            new = torch.where(owner_valid, sols[owner_idx, owner_lx, owner_ly], solution)
            max_delta = float((new - solution).abs().max())
            solution = (1.0 - relax) * solution + relax * new
        else:  # multiplicative: reference's sequential source-outward order
            max_delta = 0.0
            h2 = halo + RING_WIDTH
            for p in order:
                x0, y0 = origins[p]
                bc = solution[x0 : x0 + W, y0 : y0 + W]
                sol = _solve_patches_batched(_patch(ops_stacked, p), M, ring[None], bc[None],
                                             rhs[p : p + 1], solver_tol, solver_maxiter)[0]
                tgt = solution[x0 + h2 : x0 + W - h2, y0 + h2 : y0 + W - h2]
                new = sol[inner, inner]
                max_delta = max(max_delta, float((new - tgt).abs().max()))
                solution[x0 + h2 : x0 + W - h2, y0 + h2 : y0 + W - h2] = (
                    (1.0 - relax) * tgt + relax * new)
        deltas.append(max_delta)
        if verbose:
            print(f"sweep {sweep + 1}: max_delta={max_delta:.3e}")
        if max_delta < tol:
            break
    return solution, deltas
