"""2-D domain decomposition over device meshes.

The reference is single-GPU (SURVEY.md §2.10); this package is the
scale-out layer the north star requires (BASELINE.json): fields
block-decomposed over a `jax.sharding.Mesh`, radius-r stencils fed by
`ppermute` halo exchanges (NCCL over NVLink), transport solved by payload
exchanges, and the global flow-graph ops running GSPMD-partitioned.

    from soillib_tpu import parallel as par
    mesh  = par.make_mesh()                 # all visible devices, 2-D
    state = par.shard_state(state, mesh)
    step  = par.make_sharded_erode_fn(mesh, scale, param)
    state = step(state, key)

Multi-host: `jax.distributed.initialize()` first; nothing else changes.
"""

from soillib_tpu.parallel.mesh import (
    AXES,
    check_divisible,
    factor2,
    grid_sharding,
    grid_spec,
    leaf_spec,
    make_mesh,
    shard_field,
    shard_field_global,
    shard_state,
    shard_state_global,
)
from soillib_tpu.parallel.halo import ShardHalo, exchange_axis
from soillib_tpu.parallel.erosion import make_sharded_erode_fn, sharded_erode
from soillib_tpu.parallel.particles import (
    debris_particles_sharded,
    fluvial_particles_sharded,
    solve_particles_sharded,
)
from soillib_tpu.parallel import graph, ops

__all__ = [
    "AXES",
    "ShardHalo",
    "check_divisible",
    "exchange_axis",
    "factor2",
    "grid_sharding",
    "grid_spec",
    "make_mesh",
    "make_sharded_erode_fn",
    "graph",
    "ops",
    "debris_particles_sharded",
    "fluvial_particles_sharded",
    "shard_field",
    "shard_state",
    "sharded_erode",
    "solve_particles_sharded",
]
