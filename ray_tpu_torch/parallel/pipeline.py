"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp``
mesh axis (port of ``ray_tpu/parallel/pipeline.py``).

Per-layer parameters are stacked on a leading [L] dim (``stack_layers``)
and placed ``P("pp")`` (``pp_sharding_spec``): each stage holds L/pp
consecutive layers.  Every rank runs the same schedule, as one
``shard_map`` program does in JAX: the batch splits into M microbatches;
at step t rank 0 takes embedded microbatch t (t < M), every stage runs its
layers and hands the output to rank + 1 through ``ppermute``, and the
last stage's outputs on the diagonal t = m + pp - 1 are the completed
microbatches.  The last stage's loss, zeroed on the other ranks, is summed
over pp, so every rank returns it.

Gradients: ``ppermute``'s backward sends each gradient back one stage, and
the all-reduce's leaves each rank's seed as it is, so a ``backward()`` on
every rank gives each stage its own layers' true gradient.  ``embed``,
``final_norm`` and ``lm_head`` sit on every stage but only rank 0's graph
uses ``embed`` and only the last stage's the other two, so their gradients
are summed over pp (``pvary``).  Rank-dependent choices are
``torch.where`` on a tensor, not Python branches, so every rank's autograd
graph has the same shape and meets the same sends in the same order.

The schedule wastes the classic GPipe bubble (pp - 1 of M + pp - 1
steps); M >= 4 pp keeps it small.
"""

from __future__ import annotations

import types
from typing import Any, Dict

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..collective import mesh_ops
from .mesh import AXIS_PP, mesh_axis_size
from .sharding import P, local

Params = Dict[str, Any]


def _nest(flat: Dict[str, torch.Tensor]) -> Params:
    """``{"attn.wq": t}`` -> ``{"attn": {"wq": t}}``."""
    out: Params = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


@torch.no_grad()
def stack_layers(params: nn.Module) -> Params:
    """The model's tensors as a tree whose ``layers`` entry stacks every
    per-layer tensor on a leading [L] dim (JAX's stacked pytree), so the
    layer dim can be placed over pp.  Each stacked tensor is a new leaf
    that requires grad as the model's parameters do."""
    top: Dict[str, torch.Tensor] = {}
    per_layer: Dict[str, list] = {}
    for name, p in params.named_parameters():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            per_layer.setdefault(rest, []).append(p)
        else:
            top[name] = p.detach().clone().requires_grad_(p.requires_grad)
    layers = {rest: torch.stack(ps).requires_grad_(ps[0].requires_grad)
              for rest, ps in per_layer.items()}
    return {**_nest(top), "layers": _nest(layers)}


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(params: Params, n_layers: int) -> Params:
    """The inverse of ``stack_layers``: ``layers`` as a list of per-layer
    trees (views of the stacked tensors)."""
    return {**{k: v for k, v in params.items() if k != "layers"},
            "layers": [_map(lambda t, i=i: t[i], params["layers"])
                       for i in range(n_layers)]}


def pp_sharding_spec(stacked: Params) -> Params:
    """P("pp") on the stacked layer dim; everything else replicated."""
    return {**{k: P() for k in stacked if k != "layers"},
            "layers": _map(lambda _: P(AXIS_PP), stacked["layers"])}


def _namespace(tree):
    """Nested dicts as attribute objects (``layer.attn.wq``), as the
    model's block reads a layer."""
    if isinstance(tree, dict):
        return types.SimpleNamespace(
            **{k: _namespace(v) for k, v in tree.items()})
    return tree


def make_pp_loss(config, mesh: DeviceMesh, n_micro: int = 4,
                 ignore_index: int = -100):
    """Build ``loss(stacked, tokens, targets) -> scalar`` running the GPipe
    schedule over the mesh's pp axis, on every rank of the mesh.
    ``stacked`` comes from ``stack_layers`` placed by
    ``shard_pytree(stacked, mesh, pp_sharding_spec(stacked))``; tokens and
    targets are the whole batch, the same on every rank.
    ``config.n_layers`` must divide by the pp size and the batch by
    ``n_micro``.  ``config`` is a ``models.llama.LlamaConfig``."""
    from ..models.llama import _block, _chunked_nll
    from ..ops.norms import rms_norm
    from ..ops.rotary import rope_frequencies

    pp = mesh_axis_size(mesh, AXIS_PP)
    if config.n_layers % pp != 0:
        raise ValueError(
            f"n_layers={config.n_layers} not divisible by pp={pp}"
        )

    def replicated(t):
        # Used by one stage's graph only: summed over pp.
        return mesh_ops.pvary(local(t), AXIS_PP, mesh=mesh)

    def loss(stacked: Params, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        rank = mesh_ops.axis_index(AXIS_PP, mesh=mesh)
        tokens, targets = local(tokens), local(targets)
        B, S = tokens.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro="
                             f"{n_micro}")
        mb = B // n_micro
        layers = _map(local, stacked["layers"])
        n_local = layers["attn"]["wq"].shape[0]
        if n_local * pp != config.n_layers:
            raise ValueError(
                f"{n_local} local layers on each of {pp} stages for "
                f"{config.n_layers}: place the stacked params with "
                f"shard_pytree(stacked, mesh, pp_sharding_spec(stacked))")
        stage = [_namespace(_map(lambda t, i=i: t[i], layers))
                 for i in range(n_local)]
        embed = replicated(stacked["embed"])
        final_norm = replicated(stacked["final_norm"])
        lm_head = replicated(stacked["lm_head"])
        cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                    config.rope_theta, device=tokens.device)
        # Every rank embeds every microbatch; only rank 0's is consumed.
        inputs = embed[tokens].to(config.dtype).view(n_micro, mb, S, -1)
        first = torch.tensor(rank == 0, device=tokens.device)
        last = torch.tensor(rank == pp - 1, device=tokens.device)
        state = torch.zeros_like(inputs[0])
        fwd = [(i, (i + 1) % pp) for i in range(pp)]
        steps = n_micro + pp - 1
        collected = []
        for t in range(steps):
            x = torch.where(first, inputs[t], state) if t < n_micro \
                else state
            for layer in stage:
                x = _block(config, x, layer, cos, sin)
            collected.append(x)
            if t < steps - 1:  # the last step's hand-off is never read
                state = mesh_ops.ppermute(x, AXIS_PP, fwd, mesh=mesh)
        # Completed microbatch m = the last stage's output at m + pp - 1.
        outs = torch.stack([collected[m + pp - 1] for m in range(n_micro)])
        hidden = rms_norm(outs, final_norm, config.norm_eps)
        total, count = _chunked_nll(config, hidden.reshape(B, S, -1),
                                    lm_head, targets, ignore_index)
        nll = torch.where(last, total / count.clamp_min(1),
                          torch.zeros_like(total))
        return mesh_ops.allreduce(nll, AXIS_PP, mesh=mesh)

    return loss


__all__ = ["stack_layers", "unstack_layers", "pp_sharding_spec",
           "make_pp_loss"]
