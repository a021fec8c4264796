"""Mesh-sharded tiled FDFD: the Schwarz patches distributed over devices.

Counterpart of ``fdtd2d_tpu/parallel/tiled_sharded.py``. The patch axis of
the two-level solve (fdfd/tiled.py, mode "krylov") is split over a 1D mesh:
the patch count is padded to a multiple of the entries with zero-weight
copies of patch 0 (:func:`_pad_patches`), and each entry holds its block of
the stacked patch operators, partition-of-unity weights and flat window
indices, and a copy of the shared local FDM inverse.

Each application of the patch level:

1. the residual is copied to every entry (JAX: the all_gather of its row
   shards);
2. each entry runs one batched FGMRES(``inner_iters``) over its patches and
   ``index_add_``\\ s the weighted corrections into its own flat buffer
   (``fdfd/tiled.py::_oras_apply``);
3. the buffers are summed on the first entry (JAX: the psum_scatter).

The outer level runs on the first entry: the global operator, the coarse
FDM inverse, the residual-minimizing combination and the outer FGMRES
(restart 30, as JAX's ``solve_global``). Composing it with the block
operator of ``parallel/sharded.py`` would cut the global FDM into gathers
too (its four dense matmuls act on the whole grid), for no saving where one
card holds the grid, so it is not done. Refinement is fdfd/refine.py's
complex128 loop, with the trace convention of ``TiledSolver.solve``.
"""

from __future__ import annotations

import numpy as np
import torch

from fdtd2d_tpu_torch.fdfd.refine import refine, true_relative_residual
from fdtd2d_tpu_torch.fdfd.tiled import (_oras_apply, _residual_min_step, generate_patches,
                                         patch_flat_indices, pou_weights, stack_patch_operators)
from fdtd2d_tpu_torch.ops.fdm import fdm_preconditioner, fdm_preconditioner_for
from fdtd2d_tpu_torch.ops.helmholtz import _real_dtype, make_operator
from fdtd2d_tpu_torch.ops.krylov import fgmres
from fdtd2d_tpu_torch.parallel.mesh import Mesh

# Patch-level applications since the counter was last set to zero.
applications = 0


def _pad_patches(origins: np.ndarray, weights: np.ndarray, D: int):
    """Pad the patch axis to a multiple of D with zero-weight copies of
    patch 0 (solved redundantly, contributing nothing)."""
    Pn = len(origins)
    pad = (-Pn) % D
    if pad:
        origins = np.concatenate([origins, np.repeat(origins[:1], pad, 0)])
        weights = np.concatenate([weights, np.zeros((pad,) + weights.shape[1:],
                                                    weights.dtype)])
    return origins, weights


def run_fdfd_tiled_sharded(
    eps, mu, dx, dy, omega, source, mesh: Mesh, *,
    patch_size: int = 100, padding: int = 30, pml_thickness: int = 10,
    global_pml_thickness: int = 40, solver_tol: float = 1e-4,
    solver_maxiter: int = 120, inner_iters: int = 8,
    dtype=torch.complex64, refine_target: float | None = 1e-6,
    max_refine_rounds: int = 8, verbose: bool = False,
):
    """Two-level (FDM coarse + PoU-ORAS local) tiled solve, the patches split
    over the entries of a 1D ``mesh``. Returns ``(field, trace)`` like
    :func:`~fdtd2d_tpu_torch.fdfd.tiled.run_fdfd_tiled` mode "krylov": with
    ``refine_target`` the complex128 iterate's true residual a round plus
    that of the returned ``dtype`` field, else ``[the raw solve's
    residual]``. The field lives on the mesh's first entry."""
    if mesh.devices.ndim != 1:
        raise ValueError("use a 1D mesh (patch axis) for the tiled solve")
    eps = np.asarray(eps)
    mu = np.asarray(mu)
    source = np.asarray(source)
    Nx, Ny = eps.shape
    W = patch_size + 2 * padding
    devices = [torch.device(d) for d in mesh.devices]
    first, D = devices[0], len(devices)
    real = _real_dtype(dtype)

    origins = generate_patches(Nx, Ny, patch_size, padding)
    weights_np = pou_weights(origins, W, Nx, Ny, pml_thickness, padding)
    origins, weights_np = _pad_patches(origins, weights_np, D)
    per = len(origins) // D

    gop = make_operator(eps, mu, dx, dy, float(omega), pml_thickness=global_pml_thickness,
                        dtype=dtype, device=first)
    Mg = fdm_preconditioner_for(gop)
    flat_all = patch_flat_indices(origins, W, Ny).reshape(len(origins), W * W)
    entries = []
    for d, dev in enumerate(devices):
        part = slice(d * per, (d + 1) * per)
        entries.append(dict(
            dev=dev,
            ops=stack_patch_operators(eps, mu, origins[part], W, dx, dy, float(omega),
                                      pml_thickness, dtype, dev),
            M=fdm_preconditioner(W, W, dx, dy, float(omega), pml_thickness,
                                 eps_ref=float(np.mean(eps)),
                                 mu_ref=1.0 / float(np.mean(1.0 / mu)), dtype=dtype, device=dev),
            weights=torch.as_tensor(weights_np[part]).to(dev, real),
            flat=torch.as_tensor(flat_all[part].reshape(-1), device=dev)))

    def oras_sharded(r2):
        """The patch level: the residual to every entry, each entry's batched
        patch solves and write-back into its own buffer, the buffers summed
        on the first entry."""
        global applications
        parts = []
        for e in entries:
            r_e = r2 if e["dev"] == first else r2.to(e["dev"])
            parts.append(_oras_apply(r_e, gop, e["ops"], e["M"], e["weights"], e["flat"],
                                     W=W, inner=inner_iters).to(first))
        applications += 1
        return sum(parts[1:], parts[0])

    def two_level(r):
        r2d = r.reshape(Nx, Ny)
        z1 = Mg(r2d)
        r2 = r2d - gop.apply(z1)
        z2 = oras_sharded(r2)
        alpha, _ = _residual_min_step(r2, z2, gop)
        return z1 + alpha * z2

    def inner_solve(rhs):
        return fgmres(gop.apply, rhs.to(first), two_level, restart=30, maxiter=solver_maxiter,
                      tol=solver_tol)

    b64 = torch.as_tensor(source, device=first).to(torch.complex128) * (-1j * float(omega))
    if refine_target is not None:
        op64 = make_operator(torch.as_tensor(eps, dtype=torch.float64),
                             torch.as_tensor(mu, dtype=torch.float64), dx, dy, float(omega),
                             pml_thickness=global_pml_thickness, dtype=torch.complex128,
                             device=first)
        out = refine(op64, b64, lambda rhs: inner_solve(rhs).x, target=refine_target,
                     max_rounds=max_refine_rounds, inner_dtype=dtype)
        if verbose:
            print(f"sharded tiled (refined): true res={out.relative_residual:.3e} "
                  f"rounds={out.rounds}")
        xc = out.x.to(dtype)
        # final trace entry: the true residual of the RETURNED downcast array
        return xc, list(out.trace) + [true_relative_residual(op64, b64, xc)]

    out = inner_solve(b64.to(dtype))
    if verbose:
        print(f"sharded tiled: res={out.relative_residual:.3e} iters={out.iterations}")
    return out.x, [out.relative_residual]
