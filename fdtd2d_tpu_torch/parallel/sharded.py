"""Sharded solvers: the FDTD rollout and the FDFD Krylov solve over a device
mesh.

Counterpart of ``fdtd2d_tpu/parallel/sharded.py``. The JAX package places
its arrays with ``NamedSharding`` and lets GSPMD partition the single-device
program (the halo collective-permutes of the stencil, the all-reduces of the
Krylov dots), and writes the matvec's halo exchange out by hand with
``shard_map`` + ``ppermute``. The port is one process holding a mesh of
``torch.device`` entries, so both forms are the same one here:

- :func:`shard_operator` cuts the Helmholtz operator into the mesh's blocks
  (``BlockLayout``): eps and 1/mu a block, the row stretch a row segment,
  the column stretch a column segment, the scalars on every entry;
- its ``apply`` is the matvec on block fields: each central difference
  takes a one-column (or one-row) halo from each neighbouring block by a
  strip copy (:func:`~fdtd2d_tpu_torch.parallel.fdtd_sharded._copy_strip`,
  ordered with events between two cards) and none at the domain's edge,
  which is the operator's zero-truncated boundary (JAX: ppermute's zero
  fill). No full field is gathered;
- :func:`solve_fdfd_sharded` runs the Krylov loop of ``solve_fdfd`` on block
  fields (:class:`BlockVectors`): dots and norms are sums of per-block
  partials, reduced on the first entry, where every scalar of the
  recurrences lives. The FDM and DST preconditioners are global (dense
  matmuls or transforms over both axes): the residual is gathered on the
  first entry, preconditioned there and scattered back, the form of XLA's
  all-gathers under GSPMD; ``fdm_gathers`` counts them. Jacobi is applied
  on the blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fdtd2d_tpu_torch.fdfd.solver import (SolveResult, jacobi_preconditioner, krylov_solve,
                                          resolve_preconditioner,
                                          shifted_laplacian_preconditioner, METHODS)
from fdtd2d_tpu_torch.fdtd.simulate import BACKENDS
from fdtd2d_tpu_torch.ops.helmholtz import HelmholtzOperator
from fdtd2d_tpu_torch.ops.krylov import Vectors
from fdtd2d_tpu_torch.parallel.fdtd_sharded import (
    _copy_strip, plan_sharded_ttiled_2d, simulate_sharded_plain, simulate_sharded_ttiled)
from fdtd2d_tpu_torch.parallel.mesh import BlockLayout, Mesh

# Halo strips copied by the sharded matvecs, and residuals gathered for a
# global preconditioner (with their bytes, both ways), since the counters were
# last set to zero: a run reads them beside its iterations.
strip_copies = 0
fdm_gathers = 0
fdm_gather_bytes = 0


def _to_staggered(state, N, M):
    """Normalize an (Ez, Hx, Hy) state to the staggered single-device
    shapes (Hx (N, M-1), Hy (N-1, M)). Padded arrays' extra column/row feed
    only zero-coefficient updates, so truncation is lossless."""
    Ez, Hx, Hy = state
    if Hx.shape[1] == M:
        Hx = Hx[:, : M - 1]
    if Hy.shape[0] == N:
        Hy = Hy[: N - 1, :]
    return Ez, Hx, Hy


def simulate_sharded(eps, mu, config, mesh: Mesh, state=None):
    """FDTD rollout sharded over the mesh, on the mesh's devices
    (``config.device`` is not read).

    Contract matches single-device :func:`~fdtd2d_tpu_torch.fdtd.simulate` on
    every dispatch path: returns ``(Ez, Hx, Hy), snapshots`` with the
    staggered shapes (Hx (N, M-1), Hy (N-1, M)), on the mesh's first device;
    ``state`` is accepted in either the staggered or the padded (N, M)
    convention (a round-tripped result from any prior call works).

    Backend resolution (``config.backend``), as in the JAX package:
    - "auto"/"ttiled" on a mesh whose decomposition the temporally tiled
      kernel admits (a 2D mesh only without frames): a halo exchange around
      K2's block mode (``parallel/fdtd_sharded.py``); frames land on sweep
      multiples. "ttiled" raises ``ValueError`` when the plan does not admit
      the grid. "auto" takes this path for float32 only (the kernels take no
      other dtype) and raises where it has no kernel path on CUDA blocks:
      it never steps float32 blocks on the card with the plain step.
    - anything else ("torch", "fused", "auto" in another dtype or on CPU
      blocks of an inadmissible shape): the same decomposition and exchange
      with the plain step as each block's engine, in any dtype — the port's
      form of the JAX package's GSPMD path; frames are ``simulate``'s.
    """
    if config.backend not in BACKENDS:
        raise ValueError(f"unknown backend {config.backend!r}; expected one of {BACKENDS}")
    N, M = torch.as_tensor(eps).shape
    if state is not None:
        state = _to_staggered(state, N, M)
    Dr, Dc = mesh.grid_shape
    on_card = any(d.type == "cuda" for d in mesh.devices.flat)
    kernel_dtype = config.dtype == torch.float32 or config.backend == "ttiled"
    if config.backend in ("auto", "ttiled") and kernel_dtype:
        frames_ok = mesh.devices.ndim == 1 or config.nframes == 0
        if frames_ok and plan_sharded_ttiled_2d(N, M, Dr, Dc) is not None:
            return simulate_sharded_ttiled(eps, mu, config, mesh, state=state)
        if config.backend == "ttiled" or on_card:
            raise ValueError(f"grid {(N, M)} over a {Dr}x{Dc} mesh admits no ttiled "
                             f"decomposition (or nframes > 0 on a 2D mesh)")
    return simulate_sharded_plain(eps, mu, config, mesh, state=state)


# ---------------------------------------------------------------------------
# The FDFD operator on blocks
# ---------------------------------------------------------------------------


class BlockVectors(Vectors):
    """The Krylov loops' vector operations on block fields (lists of
    tensors, one a block, :class:`~fdtd2d_tpu_torch.parallel.mesh.
    BlockLayout`): elementwise operations block by block on each block's
    device; a dot or a norm is the sum of the blocks' partials, reduced on
    the first entry, where the scalars of the recurrences live (the port's
    form of the ``psum``)."""

    def __init__(self, layout: BlockLayout):
        super().__init__(batched=False)
        self.layout = layout

    def scalar_like(self, b):
        return b[0].dtype, self.layout.first

    def numel(self, b) -> int:
        return sum(t.numel() for t in b)

    def zeros_like(self, a):
        return [torch.zeros_like(t) for t in a]

    def add(self, a, c):
        return [u + v for u, v in zip(a, c)]

    def sub(self, a, c):
        return [u - v for u, v in zip(a, c)]

    def div(self, a, s):
        return [t / s.to(t.device) for t in a]

    def scale(self, a, s):
        return [t * s.to(t.device) for t in a]

    def add_scaled(self, a, s, v, sign: int = 1):
        return [torch.addcmul(u, s.to(w.device), w, value=sign) for u, w in zip(a, v)]

    def _reduce(self, parts):
        first = self.layout.first
        parts = [p.to(first) for p in parts]
        return sum(parts[1:], parts[0])

    def dot(self, a, c):
        return self._reduce([torch.vdot(u.reshape(-1), v.reshape(-1)) for u, v in zip(a, c)])

    def norm(self, a):
        first = self.layout.first
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t).to(first) for t in a]))

    def combine(self, x, y, Z):
        out = []
        for i, t in enumerate(x):
            out.append(t + torch.tensordot(y.to(t.device), torch.stack([z[i] for z in Z]),
                                           dims=1))
        return out

    def where(self, keep, a, c):
        return [torch.where(keep.to(u.device), u, v) for u, v in zip(a, c)]


@dataclasses.dataclass(frozen=True)
class ShardedOperator:
    """A Helmholtz operator cut into the blocks of ``layout``: eps and 1/mu
    (rows, cols) a block, 1/s_row (rows, 1) and 1/s_col (1, cols) segments,
    and omega^2 and the spacings on each block's device. ``op`` is the whole
    operator it was cut from. ``apply`` is the matvec on block fields."""

    op: HelmholtzOperator
    layout: BlockLayout
    eps: list
    inv_mu: list
    isr: list
    isc: list
    scalars: list          # (omega^2, 1/(2 dx), 1/(2 dy)) on each block's device

    def _halo_diff(self, f: list, axis: int) -> list:
        """Central differences of a block field along ``axis`` (-1 columns,
        -2 rows), zero-truncated at the domain's edge: each block's own
        difference plus its neighbours' edge lines, copied as one-line
        strips. The spacing factor is applied by the caller."""
        global strip_copies
        L = self.layout
        Dr, Dc = L.grid
        out = []
        for r, c, _, _ in L.slices():
            t = f[L.index(r, c)]
            n = t.shape[axis]
            d = t.narrow(axis, 1, n - 1) if n > 1 else None
            lo = torch.zeros_like(t)
            if d is not None:
                lo.narrow(axis, 0, n - 1).copy_(d)
                lo.narrow(axis, 1, n - 1).sub_(t.narrow(axis, 0, n - 1))
            # the line after the block's last one, and the line before its first
            for step, edge in ((1, n - 1), (-1, 0)):
                rr, cc = (r + step, c) if axis == -2 else (r, c + step)
                if not (0 <= rr < Dr and 0 <= cc < Dc):
                    continue
                src = f[L.index(rr, cc)]
                line = src.narrow(axis, 0 if step > 0 else src.shape[axis] - 1, 1)
                halo = torch.empty_like(line, device=t.device)
                _copy_strip(halo, line)
                strip_copies += 1
                target = lo.narrow(axis, edge, 1)
                if step > 0:
                    target.add_(halo)
                else:
                    target.sub_(halo)
            out.append(lo)
        return out

    def apply(self, x: list) -> list:
        """A x for a block field ``x``; the same operations as
        ``HelmholtzOperator.apply`` block by block, with the halos of its
        four central differences exchanged between neighbouring blocks."""
        k = range(len(x))
        u = [x[i] * self.isc[i] for i in k]
        tc = [d * self.scalars[i][1] * self.inv_mu[i]
              for i, d in enumerate(self._halo_diff(u, -1))]
        tc = [d * self.scalars[i][1] * self.isc[i] for i, d in enumerate(self._halo_diff(tc, -1))]
        u = [x[i] * self.isr[i] for i in k]
        tr = [d * self.scalars[i][2] * self.inv_mu[i]
              for i, d in enumerate(self._halo_diff(u, -2))]
        tr = [d * self.scalars[i][2] * self.isr[i] for i, d in enumerate(self._halo_diff(tr, -2))]
        return [-(tc[i] + tr[i]) - self.scalars[i][0] * self.eps[i] * x[i] for i in k]

    __call__ = apply


def shard_operator(op: HelmholtzOperator, mesh: Mesh) -> ShardedOperator:
    """The operator on the mesh's blocks (JAX: eps and 1/mu over ('x', 'y'),
    the stretch vectors along their axis, the scalars replicated). One
    operator, not a stacked one."""
    if op.batch_shape:
        raise ValueError("shard_operator takes one operator, not a stacked one")
    L = BlockLayout.of(mesh, op.shape)
    eps, inv_mu, isr, isc, scalars = [], [], [], [], []
    for _, _, (rs, cs), dev in L.slices():
        eps.append(op.eps[rs, cs].to(dev, copy=True).contiguous())
        inv_mu.append(op.inv_mu[rs, cs].to(dev, copy=True).contiguous())
        isr.append(op.inv_s_row[rs, None].to(dev, copy=True).contiguous())
        isc.append(op.inv_s_col[None, cs].to(dev, copy=True).contiguous())
        scalars.append(tuple(a.to(dev) for a in (op.omega**2, op.inv_2dx, op.inv_2dy)))
    return ShardedOperator(op, L, eps, inv_mu, isr, isc, scalars)


def sharded_matvec_shardmap(op: HelmholtzOperator, mesh: Mesh):
    """``x -> A x`` on block fields of the mesh (``shard_operator(op,
    mesh).apply``; its ``.layout`` scatters a field and gathers one). With a
    1D mesh the blocks are row blocks and only the row differences exchange
    halos, as in the JAX package."""
    return shard_operator(op, mesh).apply


def _block_preconditioner(op: HelmholtzOperator, sop: ShardedOperator, preconditioner):
    """The preconditioner of ``solve_fdfd`` on block fields: Jacobi on the
    blocks; a global one (FDM, DST, a callable) applied to the residual
    gathered on the first entry, and scattered back."""
    M, builtin = resolve_preconditioner(op, preconditioner)
    L = sop.layout
    if builtin is None and M is None:
        return None
    if builtin == "jacobi":
        diag = L.scatter(op.diagonal())
        return lambda r: [(t / d).to(op.dtype) for t, d in zip(r, diag)]
    if builtin == "dst":
        M = shifted_laplacian_preconditioner(op)

    def minv(r):
        global fdm_gathers, fdm_gather_bytes
        full = L.gather(r).to(op.device)
        fdm_gathers += 1
        fdm_gather_bytes += 2 * full.numel() * full.element_size()
        return L.scatter(M(full))

    return minv


def solve_fdfd_sharded(op: HelmholtzOperator, b, mesh: Mesh, *, method: str = "fgmres",
                       preconditioner="fdm", tol: float = 1e-6, maxiter: int = 2000,
                       restart: int = 40, x0: Optional[torch.Tensor] = None) -> SolveResult:
    """FDFD solve with the grid cut into the mesh's blocks; the arguments of
    :func:`~fdtd2d_tpu_torch.fdfd.solver.solve_fdfd`. The Krylov loop runs on
    block fields (see the module docstring); the result's ``x`` is the full
    (Nx, Ny) field on the mesh's first entry, its residual the true one in
    the solve's precision, computed on the blocks."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    sop = shard_operator(op, mesh)
    L = sop.layout
    M = _block_preconditioner(op, sop, preconditioner)
    bb = L.scatter(torch.as_tensor(b).reshape(op.shape).to(op.device, op.dtype))
    if x0 is not None:
        x0 = L.scatter(torch.as_tensor(x0).reshape(op.shape).to(op.device, op.dtype))
    out = krylov_solve(sop.apply, bb, M, BlockVectors(L), method=method, tol=tol,
                       maxiter=maxiter, restart=restart, x0=x0)
    return dataclasses.replace(out, x=L.gather(out.x))
