"""Mixture-of-Experts decoder, Mixtral family (port of
``ray_tpu/models/moe.py``): Llama attention and a token-choice top-k
expert FFN with capacity in every layer.

- router: fp32 logits [G, E] of an fp32 upcast of the normed hidden state;
  the top-k experts of each token, their probabilities renormalised.
- capacity: each expert has C slots (``MoEConfig.capacity``).  Slots are
  claimed k-choice-major, every token's first choice before any token's
  second, then in token order; a claim past C is dropped and the token
  keeps only its residual for that choice (Switch).
- dispatch and combine: one-hot masks [G, E, C] cast to the model dtype;
  the expert inputs are one product ``[E, C, G] @ [G, d]``, the experts a
  batched SwiGLU over E, the output one weighted product back to [G, d].
  These are plain products, as the JAX package leaves them to XLA; the
  dense form (a [G, k, E, C] fp32 mask) is kept so the port rounds at the
  JAX package's places.
- aux loss: Switch load balancing, E x sum_e f_e P_e, with f_e the share of
  tokens whose first choice is e (no gradient) and P_e the mean router
  probability of e.

Attention goes through the port's ``llama._attention`` (kernel K1, and
K2/K3 for gradients on the card) and the norms through ``rms_norm`` (K4).
Parameters keep the JAX tree's names (``layers.0.moe.w1`` is
``params["layers"][0]["moe"]["w1"]``); the router stays fp32 whatever the
dtype.  ``n_experts=1, top_k=1`` with ample capacity is the dense SwiGLU.

Sharding: ``moe_sharding_rules`` puts the expert dim over ep and, within
an expert, the FFN megatron-style over fsdp/tp.  With a DTensor batch
(``make_train_step(mesh=, rules=)``) each rank routes every token of its
rows (the router is replicated), runs its E/ep experts on its tp slice of
d_ff, and the combined outputs are summed over tp and ep; attention, the
norms, the embedding and the loss shard as Llama's do.  With the batch's
rows or sequence split over data axes, capacity and claims stay the
global batch's: each rank's claims are offset by the counts of the claims
before them in the global order (one all-gather of per-row counts), the
aux loss's statistics are summed over the data axes, and each rank runs
the experts on its own kept claims only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..collective import mesh_ops
from ..device import DeviceLike, resolve_device
from ..ops.losses import masked_cross_entropy, masked_nll
from ..ops.norms import rms_norm
from ..ops.rotary import rope_frequencies
from ..parallel.mesh import AXIS_EP, AXIS_FSDP, AXIS_TP
from ..parallel.sharding import P, ShardingRules, Spmd
from .llama import (Attention, LlamaConfig, _attention, _embed, _generator,
                    _into_tp, _load_tree, _normal_, _param, _w,
                    llama_sharding_rules)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixtral-style: Llama attention + MoE FFN every layer.  Same fields
    and defaults as the JAX ``MoEConfig`` (``rope_theta`` 1e4 and
    ``max_seq`` 4096, where the published Mixtral-8x7B config has 1e6 and
    32768), with a torch dtype."""

    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    max_seq: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    aux_loss_coeff: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def capacity(self, n_tokens: int) -> int:
        """Per-expert slot count for a group of ``n_tokens``."""
        c = math.ceil(n_tokens * self.top_k * self.capacity_factor
                      / self.n_experts)
        return max(4, int(c))

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        kv = self.n_kv_heads * self.head_dim
        per_layer = (
            d * d + 2 * d * kv + d * d          # attention
            + d * self.n_experts                 # router
            + self.n_experts * 3 * d * f         # experts
            + 2 * d
        )
        return v * d + self.n_layers * per_layer + d + d * v

    def as_llama(self) -> LlamaConfig:
        """Attention-config view (reuses the Llama attention path)."""
        return LlamaConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_ff=self.d_ff,
            max_seq=self.max_seq, rope_theta=self.rope_theta,
            norm_eps=self.norm_eps, dtype=self.dtype,
        )

    # ---- stock sizes ------------------------------------------------------

    @staticmethod
    def mixtral_8x7b(**kw) -> "MoEConfig":
        return MoEConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "MoEConfig":
        kw.setdefault("vocab_size", 512)
        return MoEConfig(d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                         d_ff=256, n_experts=4, top_k=2, max_seq=256, **kw)


class Experts(nn.Module):
    def __init__(self, config: MoEConfig, device):
        super().__init__()
        d, f, E, dt = (config.d_model, config.d_ff, config.n_experts,
                       config.dtype)
        # fp32 whatever the dtype: tiny, and the top-k boundaries are
        # precision sensitive.
        self.router = _param((d, E), torch.float32, device)
        self.w1 = _param((E, d, f), dt, device)  # gate
        self.w3 = _param((E, d, f), dt, device)  # up
        self.w2 = _param((E, f, d), dt, device)  # down


class MoEBlock(nn.Module):
    def __init__(self, config: MoEConfig, device):
        super().__init__()
        self.attn_norm = _param((config.d_model,), config.dtype, device)
        self.attn = Attention(config.as_llama(), device)
        self.moe_norm = _param((config.d_model,), config.dtype, device)
        self.moe = Experts(config, device)


class MoE(nn.Module):
    """Weights of one MoE model.  ``forward(tokens)`` is ``moe_apply``."""

    def __init__(self, config: MoEConfig, device: torch.device):
        super().__init__()
        self.config = config
        d, v, dt = config.d_model, config.vocab_size, config.dtype
        self.embed = _param((v, d), dt, device)
        self.final_norm = _param((d,), dt, device)
        self.lm_head = _param((d, v), dt, device)
        self.layers = nn.ModuleList(
            MoEBlock(config, device) for _ in range(config.n_layers))

    def forward(self, tokens: torch.Tensor):
        return moe_apply(self.config, self, tokens)


@torch.no_grad()
def moe_init(config: MoEConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None, *, trainable: bool = False) -> MoE:
    """Random weights with the JAX package's distributions: N(0, 1) embed,
    N(0, d^-1/2) projections, router and expert gate/up, N(0, d_ff^-1/2)
    expert down projection, ones for the norms; drawn in fp32 from
    ``generator`` (seed 0 when omitted, on the target device) and cast to
    ``config.dtype``, the router kept in fp32.  Runs on the card unless
    ``device="cpu"``; ``trainable`` makes every parameter require grad."""
    dev = resolve_device(device)
    generator = _generator(generator, dev)
    model = MoE(config, dev)
    std = config.d_model ** -0.5
    _normal_(model.embed, 1.0, generator)
    model.final_norm.fill_(1.0)
    _normal_(model.lm_head, std, generator)
    for layer in model.layers:
        layer.attn_norm.fill_(1.0)
        layer.moe_norm.fill_(1.0)
        a, m = layer.attn, layer.moe
        for w in (a.wq, a.wk, a.wv, a.wo, m.router, m.w1, m.w3):
            _normal_(w, std, generator)
        _normal_(m.w2, config.d_ff ** -0.5, generator)
    return model.requires_grad_(trainable)


@torch.no_grad()
def moe_params_from_jax(config: MoEConfig, np_tree: Mapping[str, Any],
                        device: DeviceLike = None, *,
                        trainable: bool = False) -> MoE:
    """Build the port's model from ``jax.tree.map(np.asarray, params)`` of
    the JAX package's ``moe_init`` (numpy arrays only); the router stays
    fp32."""
    if len(np_tree["layers"]) != config.n_layers:
        raise ValueError(f"{len(np_tree['layers'])} layers for a "
                         f"{config.n_layers}-layer config")
    model = MoE(config, resolve_device(device))
    _load_tree(model, np_tree)
    return model.requires_grad_(trainable)


def moe_sharding_rules() -> ShardingRules:
    """Llama rules + expert weights sharded over (ep, fsdp, tp): each ep
    shard owns E/ep experts; within an expert the FFN shards like megatron.
    The router is tiny and replicated."""
    base = llama_sharding_rules().rules
    return ShardingRules([
        (r"moe/router", P()),
        (r"moe/(w1|w3)", P(AXIS_EP, AXIS_FSDP, AXIS_TP)),
        (r"moe/w2", P(AXIS_EP, AXIS_TP, AXIS_FSDP)),
        *[(pat.pattern, spec) for pat, spec in base],
    ])


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest probabilities of each row.  A
    stable descending sort puts the lower expert first among equal
    probabilities, as lax.top_k does (torch.topk promises no order)."""
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[:, :k], top_e[:, :k]


def _split(spmd: Optional[Spmd]) -> int:
    """How many ranks split the batch (1 when it is whole)."""
    n = 1
    for a in (spmd.data_axes if spmd is not None else ()):
        n *= spmd.size(a)
    return n


def _exclusive(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def _claims_before(spmd: Spmd, onehot: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """What to add to this rank's claim indices [k * G, E] (its local
    exclusive cumsum in claim order) to make them the global batch's.  The
    global order is choice-major, then token order: batch row, then
    sequence.  A rank holds ``rows`` rows of one sequence chunk (a
    segment each); every rank's per-row claim counts are all-gathered."""
    G, k, E = onehot.shape
    per_row = onehot.view(rows, G // rows, k, E).sum(1)          # [R, k, E]
    every = mesh_ops.allgather(per_row[None], spmd.data_axes,
                               mesh=spmd.mesh)                 # [n, R, k, E]
    n_seq = spmd.size(spmd.seq_axis) if spmd.seq_axis else 1
    # Data ranks in mesh order: (dp, fsdp) batch blocks, then sp chunks.
    segs = every.view(-1, n_seq, rows, k, E).transpose(1, 2)
    segs = segs.reshape(-1, k, E)           # [(batch block, row, chunk)]
    batch_block, chunk = divmod(
        mesh_ops.axis_index(spmd.data_axes, mesh=spmd.mesh), n_seq)
    mine = (batch_block * rows + torch.arange(rows, device=onehot.device)) \
        * n_seq + chunk
    total, local_total = segs.sum(0), per_row.sum(0)             # [k, E]
    corr = (_exclusive(total - local_total, 0)[None]
            + _exclusive(segs, 0)[mine] - _exclusive(per_row, 0))
    # [R, k, E] -> the flat claim order [k, R, S, E].
    return corr.transpose(0, 1)[:, :, None].expand(
        k, rows, G // rows, E).reshape(k * G, E)


def _route(config: MoEConfig, router: torch.Tensor, xf: torch.Tensor,
           spmd: Optional[Spmd] = None, rows: int = 1):
    """Router and capacity assignment of tokens [G, d]: ``(probs [G, E],
    top_p [G, k], top_e [G, k], slot_oh [G, k, E, C])``; ``slot_oh`` is the
    fp32 one-hot of each kept claim's slot, all zero for a dropped one.
    With the batch split over ``spmd``'s data axes (``xf`` this rank's
    ``rows`` rows), capacity and claims are the global batch's, and the
    slots of this rank's kept claims are numbered in claim order, C their
    largest count on any expert."""
    G = xf.shape[0]
    E, k = config.n_experts, config.top_k
    n = _split(spmd)
    C = config.capacity(G * n)
    probs = torch.softmax(xf.float() @ router, dim=-1)          # [G, E]
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # Claim index of each (token, choice) among its expert's claimants:
    # every token's first choice before any second, then token order.
    onehot = F.one_hot(top_e, E).float()                        # [G, k, E]
    flat = onehot.transpose(0, 1).reshape(k * G, E)
    pos = torch.cumsum(flat, dim=0) - flat
    if n > 1:
        pos = pos + _claims_before(spmd, onehot, rows)
    keep = (pos < C) * flat
    if n > 1:
        pos = _exclusive(keep, 0)
        C = max(int(keep.sum(0).max()), 1)
    slot = pos.reshape(k, G, E).transpose(0, 1)                 # [G, k, E]
    keep = keep.reshape(k, G, E).transpose(0, 1)
    # jax.nn.one_hot gives zeros at slot >= C, where F.one_hot raises: the
    # clamped slot is multiplied by keep, which is 0 there.
    slot_oh = (F.one_hot(slot.long().clamp_max(C - 1), C).float()
               * keep[..., None])
    return probs, top_p, top_e, slot_oh


def _experts(moe: Experts, expert_in: torch.Tensor,
             spmd: Optional[Spmd] = None) -> torch.Tensor:
    """Batched SwiGLU over the expert dim: [E, C, d] -> [E, C, d] (under
    ``spmd``: this rank's experts, the tp partial sums of the output)."""
    w1 = _w(spmd, moe.w1, ep=0, tp=2)
    w3 = _w(spmd, moe.w3, ep=0, tp=2)
    w2 = _w(spmd, moe.w2, ep=0, tp=1)
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, w1))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, w3)
    return torch.einsum("ecf,efd->ecd", h, w2)


def _expert_axes(spmd: Optional[Spmd], x: torch.Tensor,
                 into: bool) -> torch.Tensor:
    """Entering (``into``) the experts' region, where tp and ep ranks each
    compute a share, the gradient of x sums their shares; leaving it, the
    shares of the output are summed."""
    if spmd is None:
        return x
    op = mesh_ops.pvary if into else mesh_ops.allreduce
    return op(x, (AXIS_TP, AXIS_EP), mesh=spmd.mesh)


def _moe_ffn(config: MoEConfig, moe: Experts, x: torch.Tensor,
             spmd: Optional[Spmd] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k expert FFN over [B, S, d].  Returns (out, aux_loss)."""
    B, S, d = x.shape
    E = config.n_experts
    xf = x.reshape(B * S, d)
    probs, top_p, top_e, slot_oh = _route(config, _w(spmd, moe.router), xf,
                                          spmd, B)
    # The aux loss reads probs on every rank alike; the combine weights
    # serve this rank's experts only.
    top_p = _expert_axes(spmd, top_p, True)
    dispatch = slot_oh.sum(1)                                   # [G, E, C]
    combine = torch.einsum("gk,gkec->gec", top_p, slot_oh)
    if spmd is not None:  # this rank's experts
        n = E // spmd.size(AXIS_EP)
        lo = spmd.rank(AXIS_EP) * n
        dispatch, combine = dispatch[:, lo:lo + n], combine[:, lo:lo + n]
    expert_in = torch.einsum("gec,gd->ecd", dispatch.to(config.dtype),
                             _expert_axes(spmd, xf, True))
    expert_out = _experts(moe, expert_in, spmd)
    out = _expert_axes(spmd, torch.einsum(
        "gec,ecd->gd", combine.to(config.dtype), expert_out), False)

    first = F.one_hot(top_e[:, 0], E).float()
    if _split(spmd) > 1:  # the global batch's shares
        G = B * S * _split(spmd)
        frac_tokens = spmd.sum(first.sum(0)) / G
        frac_prob = spmd.sum(probs.sum(0)) / G
    else:
        frac_tokens = first.mean(0)
        frac_prob = probs.mean(0)
    aux = E * torch.sum(frac_tokens * frac_prob)
    return out.reshape(B, S, d), aux


def _moe_block(config: MoEConfig, x: torch.Tensor, layer: MoEBlock,
               cos: torch.Tensor, sin: torch.Tensor,
               spmd: Optional[Spmd] = None):
    h = rms_norm(x, _w(spmd, layer.attn_norm), config.norm_eps)
    x = x + _attention(config.as_llama(), h, layer, cos, sin, None, spmd)
    h = rms_norm(x, _w(spmd, layer.moe_norm), config.norm_eps)
    ffn, aux = _moe_ffn(config, layer.moe, h, spmd)
    return x + ffn, aux


def _moe_hidden(config: MoEConfig, params: MoE, tokens: torch.Tensor,
                spmd: Optional[Spmd]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final-norm hidden states, mean aux loss over the layers)."""
    x = _embed(config, params, tokens, spmd)
    cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                config.rope_theta, device=x.device)
    remat = config.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        if remat:
            x, aux = checkpoint(_moe_block, config, x, layer, cos, sin,
                                spmd, use_reentrant=False)
        else:
            x, aux = _moe_block(config, x, layer, cos, sin, spmd)
        aux_total = aux_total + aux
    x = rms_norm(x, _w(spmd, params.final_norm), config.norm_eps)
    return x, aux_total / max(config.n_layers, 1)


def moe_apply(config: MoEConfig, params: MoE, tokens: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, S, vocab] fp32, aux_loss scalar).  Under
    autograd with ``config.remat`` every block is checkpointed in full
    (the JAX package's MoE has no other policy).  With ``tokens`` a
    DTensor the logits are this rank's rows and tp slice of the
    vocabulary."""
    spmd = Spmd.of(tokens)
    x, aux = _moe_hidden(config, params, tokens, spmd)
    logits = (_into_tp(spmd, x) @ _w(spmd, params.lm_head, tp=1)).float()
    return logits, aux


def moe_loss(config: MoEConfig, params: MoE, tokens: torch.Tensor,
             targets: torch.Tensor, ignore_index: int = -100
             ) -> torch.Tensor:
    """LM cross entropy + weighted load-balancing aux loss."""
    logits, aux = moe_apply(config, params, tokens)
    spmd = Spmd.of(tokens)
    if spmd is None:
        nll = masked_cross_entropy(logits, targets, ignore_index)
    else:
        total, count = masked_nll(logits, targets.to_local(), ignore_index,
                                  vocab_axis=AXIS_TP, mesh=spmd.mesh)
        nll = spmd.sum(total) / spmd.sum(count).clamp_min(1)
    return nll + config.aux_loss_coeff * aux
