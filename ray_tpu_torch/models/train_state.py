"""Train state and train-step factory (port of
``ray_tpu/models/train_state.py``).

``default_optimizer`` is the JAX package's optax chain,
``clip_by_global_norm`` then ``adamw``, with optax's semantics:
gradients are scaled by ``max_norm / norm`` only when their global norm is
not below ``max_norm`` (no ``+1e-6`` as in ``clip_grad_norm_``), Adam's
moments stay in the parameter dtype, and the learning rate follows the
warmup-cosine schedule when one is asked for.  The update runs through
``torch.optim.AdamW`` one tensor at a time (``fused=True`` on the card,
``foreach=False`` on the CPU): the default multi-tensor path allocates
temporaries over all parameters at once, which an 8B model cannot afford.

Unlike the JAX package's pure step, ``step(state, batch)`` updates the
parameters, moments and gradients in place and returns the same state:
an 8B model has no room for a second copy.

Sharded steps (``make_train_step(mesh=, rules=)``): the parameters and
AdamW's moments are DTensors placed by the rules (``shard_train_state``),
the batch is placed over (dp, fsdp) and, with ``sp_shard_seq``, its
sequence over sp, and the model runs on each rank's local shards
(``parallel.sharding.Spmd``), which leaves every parameter's gradient a
DTensor of its own placement, summed over the data axes.  The global
gradient norm is over the whole tensors (each shard's squares summed over
the axes it is split on), the clip follows on the local shards, then one
fused AdamW step on the DTensors, which needs no communication (the
single-tensor path's per-op sharding propagation over a six-dim mesh costs
seconds a shape on the CPU, so DTensor parameters take the fused path on
the CPU too).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from ..collective import mesh_ops
from ..parallel.mesh import batch_spec, set_mesh
from ..parallel.sharding import (ShardingRules, _clip_spec, _distribute,
                                 local, shard_module)


def _trainable(params: nn.Module) -> List[nn.Parameter]:
    return [p for p in params.parameters() if p.requires_grad]


@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(lr_schedule, b1,
    b2, eps, weight_decay))``: the transformation ``default_optimizer``
    returns.  ``init`` builds the optimizer state over a model's trainable
    parameters; ``update`` applies one step to their ``.grad``."""

    lr: float
    weight_decay: float
    warmup_steps: int
    total_steps: int
    b1: float
    b2: float
    grad_clip: float
    eps: float = 1e-8  # optax.adamw's default

    def learning_rate(self, count: int) -> float:
        """optax's ``warmup_cosine_decay_schedule(0, lr, warmup_steps,
        max(total_steps, warmup_steps + 1))`` at update ``count`` (0 for
        the first), or the constant ``lr``."""
        if not (self.warmup_steps and self.total_steps):
            return self.lr
        if count < self.warmup_steps:
            return self.lr * count / self.warmup_steps
        decay = max(self.total_steps, self.warmup_steps + 1) - \
            self.warmup_steps
        t = min(count - self.warmup_steps, decay)
        return self.lr * 0.5 * (1 + math.cos(math.pi * t / decay))

    def init(self, params: nn.Module) -> torch.optim.AdamW:
        trainable = _trainable(params)
        if not trainable:
            raise ValueError("no parameter requires grad: build the model "
                             "with trainable=True")
        return _adamw(trainable, lr=self.learning_rate(0),
                      betas=(self.b1, self.b2), eps=self.eps,
                      weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.AdamW, count: int,
               grad_norm: torch.Tensor) -> None:
        """Clip the gradients by their global norm ``grad_norm`` (optax:
        unchanged below ``grad_clip``, else times ``grad_clip / norm``),
        then one AdamW step at ``learning_rate(count)``."""
        scale = torch.where(grad_norm < self.grad_clip,
                            torch.ones_like(grad_norm),
                            self.grad_clip / grad_norm)
        for group in opt.param_groups:
            group["lr"] = self.learning_rate(count)
            for p in group["params"]:
                if p.grad is not None:
                    local(p.grad).mul_(scale)
        opt.step()


def _adamw(trainable: List[nn.Parameter], **hyper) -> torch.optim.AdamW:
    """AdamW one tensor at a time: fused on the card and for DTensors,
    the single-tensor loop for plain CPU tensors."""
    p = trainable[0]
    per_tensor = ({"fused": True} if p.is_cuda or isinstance(p, DTensor)
                  else {"foreach": False})
    return torch.optim.AdamW(trainable, **hyper, **per_tensor)


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.0,
                      warmup_steps: int = 0, total_steps: int = 0,
                      b1: float = 0.9, b2: float = 0.95,
                      grad_clip: float = 1.0) -> ClippedAdamW:
    return ClippedAdamW(lr=lr, weight_decay=weight_decay,
                        warmup_steps=warmup_steps, total_steps=total_steps,
                        b1=b1, b2=b2, grad_clip=grad_clip)


@dataclasses.dataclass
class TrainState:
    params: nn.Module
    opt_state: torch.optim.AdamW
    step: int = 0

    @staticmethod
    def create(params: nn.Module, tx: ClippedAdamW) -> "TrainState":
        return TrainState(params=params, opt_state=tx.init(params), step=0)


def _split_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes (size > 1) a DTensor is split over."""
    mesh = t.device_mesh
    return tuple(name for i, (name, pl) in enumerate(
        zip(mesh.mesh_dim_names, t.placements))
        if isinstance(pl, Shard) and mesh.size(i) > 1)


def _global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """fp32 L2 norm over every element of ``tensors``; for DTensors, of
    the whole tensors: each local shard's squares, summed over the axes
    its tensor is split on (grouped by those axes, one all-reduce each)."""
    if not any(isinstance(t, DTensor) for t in tensors):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t, dtype=torch.float32)
             for t in tensors]))
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for t in tensors:
        sq = torch.linalg.vector_norm(local(t), dtype=torch.float32) ** 2
        key = _split_axes(t)
        groups[key] = groups[key] + sq if key in groups else sq
    mesh = tensors[0].device_mesh
    return torch.sqrt(sum(mesh_ops.allreduce(v, key, mesh=mesh)
                          for key, v in groups.items()))


def _set_grad(p: nn.Parameter, g: torch.Tensor) -> None:
    """``p.grad = g``, a local tensor, as a DTensor of ``p``'s placement
    when ``p`` is one."""
    if isinstance(p, DTensor):
        g = DTensor.from_local(g, p.device_mesh, p.placements,
                               run_check=False, shape=p.shape,
                               stride=p.stride())
    p.grad = g


def make_train_step(loss_fn: Callable[[nn.Module, Any], torch.Tensor],
                    tx: ClippedAdamW, mesh: Optional[Any] = None,
                    rules: Optional[ShardingRules] = None, *,
                    sp_shard_seq: bool = False, grad_accum: int = 1,
                    accum_dtype: Optional[torch.dtype] = None):
    """Build ``step(state, batch) -> (state, metrics)`` with metrics
    ``{"loss", "grad_norm", "step"}`` (loss and grad_norm fp32 tensors,
    grad_norm before clipping).

    ``loss_fn(params, batch)`` returns a scalar loss; ``batch`` is a dict of
    tensors with a leading batch dim.  ``grad_accum > 1`` splits that dim
    into as many equal microbatches, each run forward and backward in turn,
    with one optimizer update: the microbatch losses and gradients are
    averaged with equal weight (as in the JAX package).  ``accum_dtype``
    sets the dtype the gradients are summed in (None: the parameter dtype,
    summed in ``.grad`` itself).

    With ``mesh`` (a ``DeviceMesh`` from ``make_mesh``) and ``rules``,
    every rank of the mesh calls ``step`` with the same global batch; a
    state not placed yet is placed by ``shard_train_state`` on the first
    call, and each (micro)batch is placed over (dp, fsdp), its sequence
    over sp with ``sp_shard_seq``, before ``loss_fn`` sees it (module
    docstring).  The metrics are the global ones on every rank.
    """
    if (mesh is None) != (rules is None):
        raise ValueError("a sharded step takes both mesh and rules")

    def place(batch):
        if mesh is None:
            return batch
        spec = batch_spec(sp_shard_seq)
        return {k: v if isinstance(v, DTensor) else
                _distribute(v, mesh, _clip_spec(spec, v.ndim))
                for k, v in batch.items()}

    def grads_and_loss(params: nn.Module, batch) -> torch.Tensor:
        if grad_accum == 1:
            loss = loss_fn(params, place(batch))
            loss.backward()
            return loss.detach()
        trainable = _trainable(params)
        acc = (None if accum_dtype is None else
               [torch.zeros_like(local(p), dtype=accum_dtype)
                for p in trainable])
        micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                              *v.shape[1:]) for k, v in batch.items()}
        loss_sum = 0.0
        for i in range(grad_accum):
            loss = loss_fn(params, place({k: v[i] for k, v in micro.items()}))
            loss.backward()
            loss_sum = loss_sum + loss.detach().float()
            if acc is not None:
                for a, p in zip(acc, trainable):
                    a.add_(local(p.grad))
                    p.grad = None
        scale = 1.0 / grad_accum
        for i, p in enumerate(trainable):
            if acc is None:
                local(p.grad).mul_(scale)
            else:
                _set_grad(p, (acc[i] * scale).to(p.dtype))
        return loss_sum * scale

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        if mesh is not None and not any(
                isinstance(p, DTensor) for p in state.params.parameters()):
            state = shard_train_state(state, mesh, rules)
        with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            loss = grads_and_loss(state.params, batch)
            gnorm = _global_norm([p.grad for p in _trainable(state.params)
                                  if p.grad is not None])
        tx.update(state.opt_state, state.step, gnorm)
        state.opt_state.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss, "grad_norm": gnorm, "step": state.step}

    return step


def shard_train_state(state: TrainState, mesh: Any,
                      rules: ShardingRules) -> TrainState:
    """Place a train state onto the mesh: the parameters become DTensors
    placed by the rules (in place, as ``shard_module``), AdamW is built
    anew over them with its hyper-parameters, and any moments it already
    holds follow their parameter's placement.  The step count stays a
    plain int, the same on every rank."""
    opt = state.opt_state
    names = {id(p): n for n, p in state.params.named_parameters()}
    held = {names[id(p)]: st for p, st in opt.state.items()}
    group = {k: opt.param_groups[0][k]
             for k in ("lr", "betas", "eps", "weight_decay")}
    shard_module(state.params, mesh, rules)
    params = dict(state.params.named_parameters())
    new = _adamw(_trainable(state.params), **group)
    for name, st in held.items():
        p = params[name]
        spec = rules.spec_for(name.replace(".", "/"), p.ndim)
        new.state[p] = {k: _distribute(v, mesh, spec)
                        if torch.is_tensor(v) and v.shape == p.shape else v
                        for k, v in st.items()}
    return TrainState(params=state.params, opt_state=new, step=state.step)
