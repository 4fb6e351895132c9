"""Llama-family decoder-only transformer (port of
``ray_tpu/models/llama.py``): forward, loss and LoRA.

``Llama`` is an ``nn.Module`` holding the weights in the JAX package's
``[d_in, d_out]`` layout (``x @ w``) under the JAX tree's names
(``layers.0.attn.wq`` is ``params["layers"][0]["attn"]["wq"]``), so
``params_from_jax`` copies arrays without transposing and the two packages
compare like with like.  Parameters are frozen unless built with
``trainable=True``; serving callers run under ``torch.no_grad()``.
``llama_hidden`` is differentiable: with ``config.remat`` each block is
wrapped as ``config.remat_policy`` says (``_REMAT``), which decides what
the backward keeps and what it computes again, kernel K1 included.
Attention goes through ``flash_attention``
(kernels K1 and, for gradients, K2/K3 on the card) and every norm through
``rms_norm`` (kernel K4 on the card, and for gradients K4's backward); the
projections and the MLP stay plain ``torch.matmul``, as the JAX package
left them to XLA.

Sharding: ``llama_sharding_rules`` (megatron TP x FSDP) places the weights
as DTensors (``parallel.sharding.shard_module``).  A batch that is a
DTensor (``make_train_step(mesh=, rules=)`` places it over dp x fsdp, and
its sequence over sp with ``sp_shard_seq``) makes every function here run
on this rank's local shards (``parallel.sharding.Spmd``): a weight is
all-gathered over fsdp when used and keeps its tp shard, the projections
are megatron column/row products with the partial sums all-reduced over
tp, the embedding and the loss split the vocabulary over tp, and a
sequence split over sp runs attention through ``ring_attention`` with RoPE
at global positions.  The hand-written kernels stay local: K1 (K2/K3
under autograd) sees this rank's heads, rows and sequence chunk, K4 its
rows.  The values are the unsharded ones whatever ``sp_ring`` says; JAX's
``sp_ring`` engages the ring only inside ``shard_map``, and with no sp
axis bound it is plain flash attention, as here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..collective import mesh_ops
from ..device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.losses import masked_nll
from ..ops.norms import rms_norm
from ..ops.ring_attention import ring_attention
from ..ops.rotary import apply_rotary, rope_frequencies
from ..parallel.mesh import AXIS_FSDP, AXIS_TP
from ..parallel.sharding import P, ShardingRules, Spmd


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Same fields and stock sizes as the JAX ``LlamaConfig``, with a torch
    dtype.  ``flash_block_q/k`` are TPU tiling knobs the port does not read
    (the CUDA kernels' tiles are fixed, see ``ops/attention.py``);
    ``remat_policy`` is one of the JAX package's six (``_REMAT``);
    ``sp_ring`` changes nothing on the port: a sequence split over sp
    always runs the ring, an unsplit one K1 (module docstring)."""

    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    d_ff: int = 11008
    max_seq: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"
    sp_ring: bool = False
    flash_block_q: int = 512
    flash_block_k: int = 512
    loss_chunk: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        per_layer = (
            d * d
            + 2 * d * self.n_kv_heads * self.head_dim
            + d * d
            + 3 * d * f
            + 2 * d
        )
        return v * d + self.n_layers * per_layer + d + d * v

    # ---- stock sizes ------------------------------------------------------

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        return LlamaConfig(d_model=5120, n_layers=40, n_heads=40,
                           n_kv_heads=40, d_ff=13824, **kw)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(vocab_size=128256, d_model=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, d_ff=14336,
                           rope_theta=500000.0, **kw)

    @staticmethod
    def b1(**kw) -> "LlamaConfig":
        return LlamaConfig(d_model=2048, n_layers=20, n_heads=16,
                           n_kv_heads=16, d_ff=5632, **kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        kw.setdefault("vocab_size", 512)
        return LlamaConfig(d_model=128, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_ff=256, max_seq=256, **kw)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        d, kv_out, dt = (config.d_model, config.n_kv_heads * config.head_dim,
                         config.dtype)
        self.wq = _param((d, d), dt, device)
        self.wk = _param((d, kv_out), dt, device)
        self.wv = _param((d, kv_out), dt, device)
        self.wo = _param((d, d), dt, device)


class MLP(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        d, f, dt = config.d_model, config.d_ff, config.dtype
        self.w1 = _param((d, f), dt, device)  # gate
        self.w3 = _param((d, f), dt, device)  # up
        self.w2 = _param((f, d), dt, device)  # down


class Block(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        self.attn_norm = _param((config.d_model,), config.dtype, device)
        self.attn = Attention(config, device)
        self.mlp_norm = _param((config.d_model,), config.dtype, device)
        self.mlp = MLP(config, device)


class Llama(nn.Module):
    """Weights of one Llama model.  ``forward(tokens)`` is
    ``llama_apply``."""

    def __init__(self, config: LlamaConfig, device: torch.device):
        super().__init__()
        self.config = config
        d, v, dt = config.d_model, config.vocab_size, config.dtype
        self.embed = _param((v, d), dt, device)
        self.final_norm = _param((d,), dt, device)
        self.lm_head = _param((d, v), dt, device)
        self.layers = nn.ModuleList(
            Block(config, device) for _ in range(config.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return llama_apply(self.config, self, tokens)


def _normal_(p: nn.Parameter, scale: float, generator: torch.Generator
             ) -> None:
    p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=p.device) * scale)


def _generator(generator: Optional[torch.Generator], dev: torch.device
               ) -> torch.Generator:
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return generator


@torch.no_grad()
def llama_init(config: LlamaConfig,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None, *, trainable: bool = False
               ) -> Llama:
    """Random weights with the JAX package's distributions: N(0, 1) embed,
    N(0, d^-1/2) projections, N(0, d_ff^-1/2) down projection, ones for the
    norms; drawn in fp32 from ``generator`` (seed 0 when omitted, on the
    target device) and cast to ``config.dtype``.  The numbers differ from
    ``jax.random``'s for the same seed: tests hand both packages one set of
    numpy weights through ``params_from_jax``.  ``trainable`` makes every
    parameter require grad."""
    dev = resolve_device(device)
    generator = _generator(generator, dev)
    model = Llama(config, dev)
    std = config.d_model ** -0.5
    _normal_(model.embed, 1.0, generator)
    model.final_norm.fill_(1.0)
    _normal_(model.lm_head, std, generator)
    for layer in model.layers:
        layer.attn_norm.fill_(1.0)
        layer.mlp_norm.fill_(1.0)
        for w in (layer.attn.wq, layer.attn.wk, layer.attn.wv, layer.attn.wo,
                  layer.mlp.w1, layer.mlp.w3):
            _normal_(w, std, generator)
        _normal_(layer.mlp.w2, config.d_ff ** -0.5, generator)
    return model.requires_grad_(trainable)


def _to_tensor(a: Any, dtype: torch.dtype, device: torch.device
               ) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no torch bridge
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(device=device, dtype=dtype)


def _load_tree(model: nn.Module, np_tree: Mapping[str, Any]) -> None:
    """Copy every parameter from the numpy tree at its own name's path
    (``layers.0.attn.wq`` -> ``np_tree["layers"][0]["attn"]["wq"]``), cast
    to the parameter's dtype."""
    for name, p in model.named_parameters():
        node = np_tree
        for key in name.split("."):
            node = node[int(key)] if key.isdigit() else node[key]
        t = _to_tensor(node, p.dtype, p.device)
        if t.shape != p.shape:
            raise ValueError(f"{name}: weight shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(t)


@torch.no_grad()
def params_from_jax(config: LlamaConfig, np_tree: Mapping[str, Any],
                    device: DeviceLike = None, *, trainable: bool = False
                    ) -> Llama:
    """Build the port's model from ``jax.tree.map(np.asarray, params)`` of
    the JAX package's ``llama_init`` (numpy arrays only)."""
    if len(np_tree["layers"]) != config.n_layers:
        raise ValueError(f"{len(np_tree['layers'])} layers for a "
                         f"{config.n_layers}-layer config")
    model = Llama(config, resolve_device(device))
    _load_tree(model, np_tree)
    return model.requires_grad_(trainable)


def llama_sharding_rules() -> ShardingRules:
    """Megatron TP x FSDP rules (2D); norms replicated."""
    return ShardingRules([
        (r"embed", P(AXIS_TP, AXIS_FSDP)),
        (r"lm_head", P(AXIS_FSDP, AXIS_TP)),
        (r"attn/(wq|wk|wv)", P(AXIS_FSDP, AXIS_TP)),
        (r"attn/wo", P(AXIS_TP, AXIS_FSDP)),
        (r"mlp/(w1|w3)", P(AXIS_FSDP, AXIS_TP)),
        (r"mlp/w2", P(AXIS_TP, AXIS_FSDP)),
        (r"norm", P()),
        (r"lora_(a|b)", P()),  # adapters are tiny: replicate
    ])


# ------------------------------------------------ the sharded step's pieces
# With ``spmd`` None (an unsharded batch) each of these is the identity or
# the parameter itself: the unsharded path runs no op of its own here.


def _w(spmd: Optional[Spmd], p: torch.Tensor, **keep: int) -> torch.Tensor:
    """Parameter ``p`` as this rank computes with it (``Spmd.weight``)."""
    return p if spmd is None else spmd.weight(p, **keep)


def _into_tp(spmd: Optional[Spmd], x: torch.Tensor) -> torch.Tensor:
    """Megatron's f before a column-parallel product: x is the same on
    every tp rank, and its gradient is the sum of the ranks' shares."""
    if spmd is None:
        return x
    return mesh_ops.pvary(x, AXIS_TP, mesh=spmd.mesh)


def _out_of_tp(spmd: Optional[Spmd], x: torch.Tensor) -> torch.Tensor:
    """Megatron's g after a row-parallel product: the partial sums of the
    tp ranks added."""
    if spmd is None:
        return x
    return mesh_ops.allreduce(x, AXIS_TP, mesh=spmd.mesh)


def _lora(spmd: Optional[Spmd], x: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor, scale: torch.Tensor, width: int) -> torch.Tensor:
    """LoRA's delta x @ A @ B * scale for the ``width`` output columns this
    rank computes (its tp shard of the heads)."""
    a, b, scale = (_w(spmd, t) for t in (a, b, scale))
    if spmd is not None and spmd.size(AXIS_TP) > 1:
        # The replicated adapter serves only this rank's heads: its
        # gradient is the sum of the tp ranks' shares.
        a, b, scale = (mesh_ops.pvary(t, AXIS_TP, mesh=spmd.mesh)
                       for t in (a, b, scale))
        lo = spmd.rank(AXIS_TP) * width
        b = b[:, lo:lo + width]
    return ((x @ a) @ b) * scale


def _positions(spmd: Optional[Spmd], seq: int) -> int:
    """Global position of this rank's first row: RoPE must see global
    positions when the sequence is split."""
    if spmd is None or spmd.seq_axis is None:
        return 0
    return spmd.rank(spmd.seq_axis) * seq


def _attend(spmd: Optional[Spmd], q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor) -> torch.Tensor:
    """K1 (K2/K3 under autograd) on local tensors: this rank's heads (tp
    splits them), rows (dp/fsdp) and, with the sequence split over sp, its
    chunk of the sequence through the ring."""
    if spmd is not None and spmd.seq_axis is not None:
        return ring_attention(q, k, v, axis_name=spmd.seq_axis, causal=True,
                              mesh=spmd.mesh)
    return flash_attention(q, k, v, causal=True)


def _qkv(config: LlamaConfig, x: torch.Tensor, layer: Block,
         cos: torch.Tensor, sin: torch.Tensor,
         lora_layer: Optional["LoraLayer"] = None,
         spmd: Optional[Spmd] = None):
    """The rotated q [B, H, S, D], k and v [B, Hkv, S, D] of normed x (this
    rank's heads and rows under ``spmd``)."""
    B, S, d = x.shape
    hd = config.head_dim
    a = layer.attn
    x = _into_tp(spmd, x)
    q = x @ _w(spmd, a.wq, tp=1)
    k = x @ _w(spmd, a.wk, tp=1)
    v = x @ _w(spmd, a.wv, tp=1)
    if lora_layer is not None:
        # LoRA on wq/wv (standard recipe): delta = x @ A @ B * (alpha/r).
        ll = lora_layer
        q = q + _lora(spmd, x, ll.wq_lora_a, ll.wq_lora_b, ll.scale,
                      q.shape[-1])
        v = v + _lora(spmd, x, ll.wv_lora_a, ll.wv_lora_b, ll.scale,
                      v.shape[-1])
    q = q.view(B, S, -1, hd).transpose(1, 2)
    k = k.view(B, S, -1, hd).transpose(1, 2)
    v = v.view(B, S, -1, hd).transpose(1, 2)
    pos = _positions(spmd, S)
    return (apply_rotary(q, cos, sin, pos), apply_rotary(k, cos, sin, pos),
            v)


def _attention(config: LlamaConfig, x: torch.Tensor, layer: Block,
               cos: torch.Tensor, sin: torch.Tensor,
               lora_layer: Optional["LoraLayer"] = None,
               spmd: Optional[Spmd] = None) -> torch.Tensor:
    out = _attend(spmd, *_qkv(config, x, layer, cos, sin, lora_layer, spmd))
    return _out_of_tp(spmd, _merge_heads(out) @ _w(spmd, layer.attn.wo,
                                                   tp=0))


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H * D]."""
    B, H, S, D = out.shape
    return out.transpose(1, 2).reshape(B, S, H * D)


def _mlp(layer: Block, x: torch.Tensor,
         spmd: Optional[Spmd] = None) -> torch.Tensor:
    m = layer.mlp
    x = _into_tp(spmd, x)
    h = (torch.nn.functional.silu(x @ _w(spmd, m.w1, tp=1))
         * (x @ _w(spmd, m.w3, tp=1)))
    return _out_of_tp(spmd, h @ _w(spmd, m.w2, tp=0))


def _pre_attention(config: LlamaConfig, x: torch.Tensor, layer: Block,
                   cos: torch.Tensor, sin: torch.Tensor,
                   lora_layer: Optional["LoraLayer"] = None,
                   spmd: Optional[Spmd] = None):
    """A block up to attention: the norm, projections, LoRA and RoPE."""
    h = rms_norm(x, _w(spmd, layer.attn_norm), config.norm_eps)
    return _qkv(config, h, layer, cos, sin, lora_layer, spmd)


def _post_attention(config: LlamaConfig, x: torch.Tensor,
                    out: torch.Tensor, layer: Block,
                    spmd: Optional[Spmd] = None) -> torch.Tensor:
    """A block after attention: ``wo``, the residual and the MLP half."""
    x = x + _out_of_tp(spmd, _merge_heads(out) @ _w(spmd, layer.attn.wo,
                                                    tp=0))
    h = rms_norm(x, _w(spmd, layer.mlp_norm), config.norm_eps)
    return x + _mlp(layer, h, spmd)


def _block(config: LlamaConfig, x: torch.Tensor, layer: Block,
           cos: torch.Tensor, sin: torch.Tensor,
           lora_layer: Optional["LoraLayer"] = None,
           spmd: Optional[Spmd] = None) -> torch.Tensor:
    out = _attend(spmd, *_pre_attention(config, x, layer, cos, sin,
                                        lora_layer, spmd))
    return _post_attention(config, x, out, layer, spmd)


def _block_full(*args) -> torch.Tensor:
    return checkpoint(_block, *args, use_reentrant=False)


def _block_save_attn(config, x, layer, cos, sin, lora_layer, spmd=None):
    """JAX's ``save_only_these_names("flash_res")``: the attention
    Function runs between two checkpointed segments, so what it saves (the
    rotated q, k, v, its output and lse, JAX's ``flash_res``) is kept and
    K1 does not run again in the backward; the rest is recomputed."""
    q, k, v = checkpoint(_pre_attention, config, x, layer, cos, sin,
                         lora_layer, spmd, use_reentrant=False)
    out = _attend(spmd, q, k, v)
    return checkpoint(_post_attention, config, x, out, layer, spmd,
                      use_reentrant=False)


#: The products a 3-D ``x @ w`` (a view, then ``aten.mm``) and an einsum
#: (``aten.bmm``: a product with batch dimensions) reach under a selective
#: checkpoint.
_MM, _BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default


def _block_saving(ops):
    """A checkpointed block that keeps the outputs of ``ops`` and
    recomputes everything else (K1 included: a ctypes call, not a
    product, as the Pallas kernel's outputs are not dots in JAX)."""
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   ops)

    def block(*args) -> torch.Tensor:
        return checkpoint(_block, *args, use_reentrant=False,
                          context_fn=context_fn)

    return block


#: ``remat_policy`` -> the block as the forward runs it under autograd.
#: ``full``: nothing kept, the whole block recomputed.  ``save_attn``:
#: the attention Function's residuals kept.  ``save_dots`` (JAX's
#: ``checkpoint_dots``): every product kept.  ``save_dots_no_batch``
#: (``checkpoint_dots_with_no_batch_dims``): products without batch
#: dimensions kept; on Llama the same tensors as ``save_dots`` on the card,
#: where the attention products live inside K1.  ``xla_cse`` and
#: ``cse_save_attn`` set ``prevent_cse=False`` in JAX, which lets XLA merge
#: the recompute with the forward and keeps every layer's activations
#: live: their counterpart is no checkpoint at all.
_REMAT = {
    "full": _block_full,
    "save_attn": _block_save_attn,
    "save_dots": _block_saving([_MM, _BMM]),
    "save_dots_no_batch": _block_saving([_MM]),
    "xla_cse": _block,
    "cse_save_attn": _block,
}


def llama_hidden(config: LlamaConfig, params: Llama, tokens: torch.Tensor,
                 lora_params: Optional["Lora"] = None) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] (logits = hidden @ lm_head).
    Under autograd with ``config.remat`` each block runs as
    ``config.remat_policy`` says (``_REMAT``): every policy gives the same
    values and gradients, and differs only in what the backward keeps and
    what it runs again.  With ``tokens`` a DTensor: this rank's rows of
    the hidden states (module docstring)."""
    if config.remat_policy not in _REMAT:
        raise ValueError(f"remat_policy {config.remat_policy!r} is not one "
                         f"of {sorted(_REMAT)}")
    block = _block
    if config.remat and torch.is_grad_enabled():
        block = _REMAT[config.remat_policy]
    spmd = Spmd.of(tokens)
    x = _embed(config, params, tokens, spmd)
    cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                config.rope_theta, device=x.device)
    for i, layer in enumerate(params.layers):
        ll = lora_params.layers[i] if lora_params is not None else None
        x = block(config, x, layer, cos, sin, ll, spmd)
    return rms_norm(x, _w(spmd, params.final_norm), config.norm_eps)


def _embed(config: LlamaConfig, params: nn.Module, tokens: torch.Tensor,
           spmd: Optional[Spmd]) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``config.dtype``.  Under
    ``spmd`` this rank's tokens, with the vocabulary split over tp: each
    rank fills the rows its slice holds and the tp sum completes them."""
    if spmd is None:
        return params.embed[tokens].to(config.dtype)
    tokens = tokens.to_local()
    table = spmd.weight(params.embed, tp=0)
    if spmd.size(AXIS_TP) == 1:
        return table[tokens].to(config.dtype)
    n = table.shape[0]
    lo = spmd.rank(AXIS_TP) * n
    here = (tokens >= lo) & (tokens < lo + n)
    rows = table[(tokens - lo).clamp(0, n - 1)] * here[..., None]
    return _out_of_tp(spmd, rows.to(config.dtype))


def llama_apply(config: LlamaConfig, params: Llama, tokens: torch.Tensor,
                lora_params: Optional["Lora"] = None) -> torch.Tensor:
    """Returns fp32 logits [B, S, vocab] for int tokens [B, S] (with
    ``tokens`` a DTensor: this rank's rows, its tp slice of the
    vocabulary)."""
    spmd = Spmd.of(tokens)
    x = llama_hidden(config, params, tokens, lora_params)
    return (_into_tp(spmd, x) @ _w(spmd, params.lm_head, tp=1)).float()


def llama_loss(config: LlamaConfig, params: Llama, tokens: torch.Tensor,
               targets: torch.Tensor, lora_params: Optional["Lora"] = None,
               ignore_index: int = -100) -> torch.Tensor:
    """Causal-LM cross entropy (fp32 scalar) with a sequence-chunked vocab
    projection: the full fp32 logits ([B, S, vocab], 1 GB at B=1, S=2048,
    vocab 128256, plus its gradient) never materialise.  Each
    ``config.loss_chunk`` slice of the sequence is checkpointed, so its
    logits are recomputed in the backward; when the chunk does not divide
    S the loss takes one unchunked pass.  With ``tokens`` and ``targets``
    DTensors each rank computes its rows' logits for its tp slice of the
    vocabulary, and the sums are taken over the data axes: every rank
    returns the global loss."""
    spmd = Spmd.of(tokens)
    hidden = llama_hidden(config, params, tokens, lora_params)
    if spmd is None:
        w, vocab = params.lm_head, {}
    else:
        hidden = _into_tp(spmd, hidden)
        w = spmd.weight(params.lm_head, tp=1)
        targets = targets.to_local()
        vocab = {"vocab_axis": AXIS_TP, "mesh": spmd.mesh}

    total, count = _chunked_nll(config, hidden, w, targets, ignore_index,
                                **vocab)
    if spmd is not None:
        total, count = spmd.sum(total), spmd.sum(count)
    return total / count.clamp_min(1)


def _chunked_nll(config: LlamaConfig, hidden: torch.Tensor,
                 w: torch.Tensor, targets: torch.Tensor, ignore_index: int,
                 **vocab) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll sum, count) of ``hidden @ w`` against ``targets``, one
    checkpointed ``config.loss_chunk`` slice of the sequence at a time (one
    pass when the chunk does not divide S)."""
    def chunk_nll(h_c, tgt_c):
        return masked_nll((h_c @ w).float(), tgt_c, ignore_index, **vocab)

    S, chunk = hidden.shape[1], config.loss_chunk
    if S % chunk:
        return chunk_nll(hidden, targets)
    total, count = 0.0, 0
    for c in range(0, S, chunk):
        nll, cnt = checkpoint(chunk_nll, hidden[:, c:c + chunk],
                              targets[:, c:c + chunk], use_reentrant=False)
        total, count = total + nll, count + cnt
    return total, count


# --------------------------------------------------------------------- LoRA


class LoraLayer(nn.Module):
    def __init__(self, config: LlamaConfig, rank: int, device):
        super().__init__()
        d, kv_out, dt = (config.d_model, config.n_kv_heads * config.head_dim,
                         config.dtype)
        self.wq_lora_a = _param((d, rank), dt, device)
        self.wq_lora_b = _param((rank, d), dt, device)
        self.wv_lora_a = _param((d, rank), dt, device)
        self.wv_lora_b = _param((rank, kv_out), dt, device)
        self.scale = _param((), dt, device)  # alpha / rank; a leaf, trained


class Lora(nn.Module):
    """Adapters for wq/wv in every layer, under the JAX tree's names
    (``layers.0.wq_lora_a``).  They are the trained part of a LoRA
    fine-tune: every parameter requires grad, ``scale`` included (a leaf
    of the JAX tree, so optax updates it too)."""

    def __init__(self, config: LlamaConfig, rank: int, device):
        super().__init__()
        self.layers = nn.ModuleList(
            LoraLayer(config, rank, device) for _ in range(config.n_layers))


@torch.no_grad()
def lora_init(config: LlamaConfig,
              generator: Optional[torch.Generator] = None, rank: int = 16,
              alpha: float = 32.0, device: DeviceLike = None) -> Lora:
    """Adapters for frozen-base fine-tuning: A ~ N(0, d^-1/2), B = 0 (the
    adapted model starts equal to the base), scale = alpha / rank."""
    dev = resolve_device(device)
    generator = _generator(generator, dev)
    lora = Lora(config, rank, dev)
    for ll in lora.layers:
        _normal_(ll.wq_lora_a, config.d_model ** -0.5, generator)
        ll.wq_lora_b.zero_()
        _normal_(ll.wv_lora_a, config.d_model ** -0.5, generator)
        ll.wv_lora_b.zero_()
        ll.scale.fill_(alpha / rank)
    return lora.requires_grad_(True)


@torch.no_grad()
def lora_from_jax(config: LlamaConfig, np_tree: Mapping[str, Any],
                  device: DeviceLike = None) -> Lora:
    """The port's adapters from ``jax.tree.map(np.asarray, lora)`` of the
    JAX package's ``lora_init``."""
    if len(np_tree["layers"]) != config.n_layers:
        raise ValueError(f"{len(np_tree['layers'])} adapter layers for a "
                         f"{config.n_layers}-layer config")
    rank = np.asarray(np_tree["layers"][0]["wq_lora_a"]).shape[1]
    lora = Lora(config, rank, resolve_device(device))
    _load_tree(lora, np_tree)
    return lora.requires_grad_(True)


def lora_sharding_rules() -> ShardingRules:
    return ShardingRules([(r"lora", P())])


@torch.no_grad()
def lora_merge(config: LlamaConfig, params: Llama, lora: Lora) -> Llama:
    """Fold adapters into base weights (for export/serving): a new frozen
    model that shares every tensor of ``params`` but wq and wv."""
    merged = Llama(config, torch.device("meta"))
    merged.load_state_dict(params.state_dict(), assign=True)
    for layer, ll in zip(merged.layers, lora.layers):
        a = layer.attn
        scale = ll.scale.float()
        for name, la, lb in (("wq", ll.wq_lora_a, ll.wq_lora_b),
                             ("wv", ll.wv_lora_a, ll.wv_lora_b)):
            w = getattr(a, name).float() + la.float() @ lb.float() * scale
            setattr(a, name, nn.Parameter(w.to(config.dtype),
                                          requires_grad=False))
    return merged
