"""Sharding rules: map parameter paths to specs, and place tensors on a mesh
as DTensors (port of ``ray_tpu/parallel/sharding.py``).

``P`` stands in for JAX's ``PartitionSpec``: one entry per tensor dim, an
axis name, a tuple of names (one dim split over several mesh dims, the
first outermost) or None.  ``placements`` turns a spec into DTensor
placements over a ``DeviceMesh``: a name on dim i is ``Shard(i)`` on that
mesh dim, every other mesh dim ``Replicate()``.  Paths are
``named_parameters()`` names with ``.`` read as ``/`` (``layers/0/attn/wq``),
so the JAX package's rule strings match unchanged.

``Spmd`` is the explicit boundary between the DTensors and the local
tensors a rank computes on (the port has no partitioner to do it, and the
hand-written kernels are not DTensor ops): a step whose batch is a DTensor
runs the model on local shards, all-gathers a weight over the data axes it
is sharded on when it is used (FSDP), keeps its tensor-parallel shard, and
sums gradients over the data axes, all through ``collective/mesh_ops``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..collective import mesh_ops


class P(tuple):
    """A partition spec: ``P("fsdp", "tp")``, ``P(("dp", "fsdp"), None)``,
    ``P()`` (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


class ShardingRules:
    """Ordered (regex -> P) table.  First match wins; default is full
    replication."""

    def __init__(self, rules: Sequence[Tuple[str, P]], default: P = P()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.default = default

    def spec_for(self, path: str, ndim: int) -> P:
        for pat, spec in self.rules:
            if pat.search(path):
                return _clip_spec(spec, ndim)
        return _clip_spec(self.default, ndim)

    def tree_specs(self, tree: Any) -> Any:
        """Specs matching ``tree``: ``{name: P}`` over a module's
        parameters, or a nested dict/list of tensors mapped leaf for
        leaf."""
        if isinstance(tree, nn.Module):
            return {name: self.spec_for(name.replace(".", "/"), p.ndim)
                    for name, p in tree.named_parameters()}
        return _map_tree(lambda path, t: self.spec_for(path, t.ndim), tree)


def _clip_spec(spec: P, ndim: int) -> P:
    if len(spec) <= ndim:
        return spec
    return P(*spec[:ndim])


def _map_tree(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict/list/tuple of tensors (or of
    specs: a ``P`` is a leaf)."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_tree(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def placements(spec: P, mesh: DeviceMesh) -> List[Placement]:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh dim."""
    names = tuple(mesh.mesh_dim_names or ())
    out: List[Placement] = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{names}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            idx.append(names.index(a))
            out[idx[-1]] = Shard(dim)
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} splits over {axes}, "
                             f"which is not the mesh's order {names}")
    return out


def spec_of(t: DTensor) -> P:
    """The spec of a DTensor's placements (trailing replicated dims
    dropped), the inverse of ``placements``."""
    parts: List[List[str]] = [[] for _ in range(t.ndim)]
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard):
            parts[pl.dim].append(name)
    entries = [None if not p else p[0] if len(p) == 1 else tuple(p)
               for p in parts]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _distribute(t: torch.Tensor, mesh: DeviceMesh, spec: P) -> DTensor:
    """Every rank holds the whole ``t`` (the same on each, built from one
    seed) and keeps its own shard: no communication."""
    d = distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                          src_data_rank=None)
    return d.requires_grad_(t.requires_grad)


def shard_pytree(tree: Any, mesh: DeviceMesh, specs: Any) -> Any:
    """Place a nested dict/list of tensors onto the mesh as DTensors:
    ``specs`` is a ``ShardingRules`` or a tree of ``P`` matching
    ``tree``."""
    if isinstance(specs, ShardingRules):
        specs = specs.tree_specs(tree)
    flat: Dict[str, P] = {}
    _map_tree(lambda path, s: flat.__setitem__(path, s), specs)
    return _map_tree(lambda path, t: _distribute(t, mesh, flat[path]), tree)


@torch.no_grad()
def shard_module(module: nn.Module, mesh: DeviceMesh,
                 rules: ShardingRules) -> nn.Module:
    """Replace every parameter of ``module`` by a DTensor parameter placed
    by the rules (in place; ``requires_grad`` kept)."""
    specs = rules.tree_specs(module)
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        d = _distribute(p, mesh, specs[name])
        sub._parameters[leaf] = nn.Parameter(d, requires_grad=p.requires_grad)
    return module


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself otherwise)."""
    return t.to_local() if isinstance(t, DTensor) else t


@dataclasses.dataclass(frozen=True)
class Spmd:
    """How this rank runs its part of a step whose batch is a DTensor: the
    mesh, the data axes (size > 1) that split the batch's rows or its
    sequence, and the axis that splits the sequence, if one does."""

    mesh: DeviceMesh
    data_axes: Tuple[str, ...]
    seq_axis: Optional[str]

    @staticmethod
    def of(batch: torch.Tensor) -> Optional["Spmd"]:
        """The split of a [B, S] DTensor batch, or None for a plain
        tensor (the unsharded path)."""
        if not isinstance(batch, DTensor):
            return None
        mesh = batch.device_mesh
        data, seq = [], None
        for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names,
                                           batch.placements)):
            if isinstance(pl, Shard) and mesh.size(i) > 1:
                data.append(name)
                if pl.dim == 1:
                    seq = name
        return Spmd(mesh, tuple(data), seq)

    def size(self, axis: str) -> int:
        return mesh_ops.axis_size(axis, mesh=self.mesh)

    def rank(self, axis: str) -> int:
        return mesh_ops.axis_index(axis, mesh=self.mesh)

    def weight(self, p: torch.Tensor, **keep: int) -> torch.Tensor:
        """The local tensor a rank computes with for parameter ``p``.  A
        dim sharded over a data axis is all-gathered (its gradient
        reduce-scattered: summed over the ranks' data); a data axis ``p``
        is replicated over sums the gradient (``pvary``).  ``keep`` names
        the axes this use takes sharded, each on its dim (``tp=1``: a
        column-parallel product); ``p`` must be sharded on exactly those
        (a size-1 axis is never sharded).  Nothing else may shard it: no
        weight is all-gathered over tp or ep."""
        if not isinstance(p, DTensor):
            return mesh_ops.pvary(p, self.data_axes, mesh=self.mesh)
        x = p.to_local()
        gathers = []
        seen = {}
        for i, (name, pl) in enumerate(zip(self.mesh.mesh_dim_names,
                                           p.placements)):
            if self.mesh.size(i) == 1:
                continue
            if isinstance(pl, Shard):
                if name in self.data_axes:
                    gathers.append((name, pl.dim))
                else:
                    seen[name] = pl.dim
            elif name in self.data_axes:
                x = mesh_ops.pvary(x, name, mesh=self.mesh)
        want = {a: d for a, d in keep.items() if self.size(a) > 1}
        if seen != want:
            raise ValueError(
                f"a parameter of shape {tuple(p.shape)} placed "
                f"{p.placements} is sharded on {seen} outside the data "
                f"axes {self.data_axes}; this use takes {want}")
        for name, dim in reversed(gathers):
            x = mesh_ops.allgather(x, name, gather_axis=dim, mesh=self.mesh)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data axes (a loss's total and count)."""
        return mesh_ops.allreduce(x, self.data_axes, mesh=self.mesh)


__all__ = ["P", "ShardingRules", "placements",
           "spec_of", "shard_pytree", "shard_module", "local", "Spmd"]
