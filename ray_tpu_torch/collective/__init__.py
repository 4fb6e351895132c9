"""Collective communication (port of ``ray_tpu/collective/``).

Two planes, as in the JAX package:

- **Device plane**: ``mesh_ops``, named-axis collectives over the ambient
  ``DeviceMesh`` (the counterpart of ``xla_ops``), differentiable where
  JAX's are; NCCL between cards, gloo on the CPU.

- **Host plane**: named groups of framework workers/actors exchanging host
  numpy arrays through the cluster KV + object store — rendezvous and
  small-tensor control traffic (reference:
  util/collective/collective_group/gloo_collective_group.py:66 uses Ray's
  KV the same way).  Tensors are copied to the host first.
"""

from .collective import (
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_rank,
    get_world_size,
    init_collective_group,
    op_stats,
    op_totals,
    recv,
    reducescatter,
    send,
)
from . import mesh_ops

__all__ = [
    "init_collective_group", "create_collective_group",
    "destroy_collective_group", "allreduce", "allgather", "reducescatter",
    "broadcast", "barrier", "send", "recv", "get_rank", "get_world_size",
    "op_totals", "op_stats", "mesh_ops",
]
