"""Multi-device legs of the port: a mesh of ``torch.device`` entries, the
sharded FDTD rollout (one process, one block of the grid a mesh entry) and
the sublattice-sharded direct solve. The other FDFD multi-device legs are
not ported yet."""

from fdtd2d_tpu_torch.parallel.mesh import Mesh, make_mesh
from fdtd2d_tpu_torch.parallel.direct_sharded import factor_sharded, solve_factored_sharded
from fdtd2d_tpu_torch.parallel.fdtd_sharded import (
    mesh_blocks,
    plan_sharded_ttiled,
    plan_sharded_ttiled_2d,
    simulate_sharded_ttiled,
    simulate_sharded_ttiled_2d,
)
from fdtd2d_tpu_torch.parallel.sharded import simulate_sharded

__all__ = [
    "Mesh",
    "factor_sharded",
    "make_mesh",
    "mesh_blocks",
    "plan_sharded_ttiled",
    "plan_sharded_ttiled_2d",
    "simulate_sharded",
    "simulate_sharded_ttiled",
    "simulate_sharded_ttiled_2d",
    "solve_factored_sharded",
]
