"""Sharded solvers: the FDTD rollout over a device mesh.

Counterpart of ``fdtd2d_tpu/parallel/sharded.py``'s ``simulate_sharded`` and
``_to_staggered``. The FDFD legs of that module (``shard_operator``,
``solve_fdfd_sharded``, ``sharded_matvec_shardmap``) are not ported yet.
"""

from __future__ import annotations

import torch

from fdtd2d_tpu_torch.fdtd.simulate import BACKENDS
from fdtd2d_tpu_torch.parallel.fdtd_sharded import (
    plan_sharded_ttiled_2d, simulate_sharded_plain, simulate_sharded_ttiled)
from fdtd2d_tpu_torch.parallel.mesh import Mesh


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
