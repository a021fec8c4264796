"""Multi-device legs of the port: a mesh of ``torch.device`` entries and a
layout of block fields over it, the sharded FDTD rollout (one process, one
block of the grid a mesh entry), the sharded FDFD Krylov solve, the
patch-sharded tiled Schwarz solve, the sharded time domain, the
sublattice-sharded direct solve, the data-parallel train step (one
``torch.distributed`` rank a mesh entry) and the dry run of every leg."""

from fdtd2d_tpu_torch.parallel.mesh import BlockLayout, Mesh, block_bounds, make_mesh
from fdtd2d_tpu_torch.parallel.direct_sharded import factor_sharded, solve_factored_sharded
from fdtd2d_tpu_torch.parallel.fdtd_sharded import (
    mesh_blocks,
    plan_sharded_ttiled,
    plan_sharded_ttiled_2d,
    simulate_sharded_ttiled,
    simulate_sharded_ttiled_2d,
)
from fdtd2d_tpu_torch.parallel.sharded import (
    shard_operator,
    sharded_matvec_shardmap,
    simulate_sharded,
    solve_fdfd_sharded,
)
from fdtd2d_tpu_torch.parallel.tiled_sharded import run_fdfd_tiled_sharded
from fdtd2d_tpu_torch.parallel.timedomain_sharded import (
    TimeDomainSolverSharded,
    shard_wave_bundle,
)

__all__ = [
    "BlockLayout",
    "Mesh",
    "TimeDomainSolverSharded",
    "block_bounds",
    "factor_sharded",
    "make_mesh",
    "mesh_blocks",
    "plan_sharded_ttiled",
    "plan_sharded_ttiled_2d",
    "run_fdfd_tiled_sharded",
    "shard_wave_bundle",
    "shard_operator",
    "sharded_matvec_shardmap",
    "simulate_sharded",
    "simulate_sharded_ttiled",
    "simulate_sharded_ttiled_2d",
    "solve_factored_sharded",
    "solve_fdfd_sharded",
]
