"""Parallelism of the port: device meshes, sharding rules, the GPipe
pipeline and the process-group bootstrap (port of ``ray_tpu/parallel/``).

``torch.distributed`` takes the place of XLA's collectives: a
``DeviceMesh`` with the JAX package's six named axes, parameters placed as
DTensors by the same regex rules, and the named-axis collectives of
``collective/mesh_ops.py`` (NCCL on the card, gloo on the CPU).
"""

from .distributed import (initialize_process_group, process_group_barrier,
                          spawn_ranks)
from .mesh import (AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP,
                   MESH_AXES, MeshConfig, batch_spec, current_mesh,
                   local_batch_size, make_mesh, mesh_axis_size, set_mesh)
from .pipeline import (make_pp_loss, pp_sharding_spec, stack_layers,
                       unstack_layers)
from .sharding import (P, ShardingRules, Spmd, placements, shard_module,
                       shard_pytree, spec_of)

__all__ = [
    "AXIS_DP", "AXIS_FSDP", "AXIS_TP", "AXIS_SP", "AXIS_EP", "AXIS_PP",
    "MESH_AXES", "MeshConfig", "make_mesh", "set_mesh", "current_mesh",
    "batch_spec", "mesh_axis_size", "local_batch_size",
    "make_pp_loss", "pp_sharding_spec", "stack_layers", "unstack_layers",
    "P", "ShardingRules", "Spmd", "placements",
    "shard_module", "shard_pytree", "spec_of",
    "initialize_process_group", "process_group_barrier", "spawn_ranks",
]
