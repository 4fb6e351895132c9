"""Device mesh construction for dp/fsdp/tp/sp/ep/pp parallelism (port of
``ray_tpu/parallel/mesh.py``).

A ``torch.distributed.device_mesh.DeviceMesh`` over the process group's
ranks takes the place of the JAX ``Mesh``: one rank per mesh position, six
named dims in ``MESH_AXES`` order (dp outermost), every one present even at
size 1 so that code can name any axis.  ``set_mesh`` makes a mesh the
ambient one, which the named-axis collectives of ``collective/mesh_ops.py``
read, as ``shard_map`` binds axis names in JAX.

Axis convention (outer -> inner):
- dp:    pure data parallel (gradients summed over it)
- fsdp:  sharded data parallel (params sharded, all-gathered on use)
- tp:    tensor parallel (megatron-style: heads and d_ff sharded)
- sp:    sequence/context parallel (ring attention neighbours)
- ep:    expert parallel (MoE expert dim)
- pp:    pipeline stages (``parallel/pipeline.py``)
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Iterator, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"

MESH_AXES = (AXIS_DP, AXIS_FSDP, AXIS_TP, AXIS_SP, AXIS_EP, AXIS_PP)

_AMBIENT: contextvars.ContextVar[Optional[DeviceMesh]] = \
    contextvars.ContextVar("ray_tpu_torch_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape.  -1 for at most one axis means "all remaining
    devices"."""

    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp,
                 "sp": self.sp, "ep": self.ep, "pp": self.pp}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}"
                )
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} does not cover {n_devices} devices"
            )
        return sizes


def make_mesh(config: Optional[MeshConfig] = None, *,
              axis_sizes: Optional[Dict[str, int]] = None,
              device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the default process group, dims
    named ``MESH_AXES``; rank r sits at the row-major position r, so the
    innermost axes join neighbouring ranks.  Runs on the card unless
    ``device="cpu"``.  With no process group and a mesh of one position, a
    one-rank gloo group is made in memory (the single-process case JAX
    needs no group for)."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = axis_sizes or (config or MeshConfig()).resolve(world)
    shape = tuple(sizes.get(a, 1) for a in MESH_AXES)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(MESH_AXES, shape))} does not "
                         f"cover {world} ranks")
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(dev.type, shape, mesh_dim_names=MESH_AXES)


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the ambient mesh inside the ``with`` block: the
    named-axis collectives and ``ring_attention`` read their axes from
    it."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_mesh() -> Optional[DeviceMesh]:
    """The ambient mesh (``set_mesh``), or None."""
    return _AMBIENT.get()


def batch_spec(sp_shard_seq: bool = False):
    """Spec for a [batch, seq, ...] input batch: batch over dp+fsdp,
    optionally sequence over sp (context parallelism)."""
    from .sharding import P

    return P((AXIS_DP, AXIS_FSDP), AXIS_SP if sp_shard_seq else None)


def mesh_axis_size(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def local_batch_size(mesh: DeviceMesh, global_batch: int) -> int:
    n = mesh_axis_size(mesh, AXIS_DP) * mesh_axis_size(mesh, AXIS_FSDP)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n}")
    return global_batch // n


__all__ = ["AXIS_DP", "AXIS_FSDP", "AXIS_TP", "AXIS_SP", "AXIS_EP",
           "AXIS_PP", "MESH_AXES", "MeshConfig", "make_mesh", "set_mesh",
           "current_mesh", "batch_spec", "mesh_axis_size",
           "local_batch_size"]
