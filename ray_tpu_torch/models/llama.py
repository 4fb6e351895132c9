"""Llama-family decoder-only transformer (port of
``ray_tpu/models/llama.py``): forward, loss and LoRA.

``Llama`` is an ``nn.Module`` holding the weights in the JAX package's
``[d_in, d_out]`` layout (``x @ w``) under the JAX tree's names
(``layers.0.attn.wq`` is ``params["layers"][0]["attn"]["wq"]``), so
``params_from_jax`` copies arrays without transposing and the two packages
compare like with like.  Parameters are frozen unless built with
``trainable=True``; serving callers run under ``torch.no_grad()``.
``llama_hidden`` is differentiable: with ``config.remat`` each block is
checkpointed (``remat_policy="full"``), so its forward, kernel K1 included,
runs again in the backward.  Attention goes through ``flash_attention``
(kernels K1 and, for gradients, K2/K3 on the card) and every norm through
``rms_norm`` (kernel K4 on the card when no gradient is needed); the
projections and the MLP stay plain ``torch.matmul``, as the JAX package
left them to XLA.  Ring attention (``sp_ring``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.losses import masked_nll
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Same fields and stock sizes as the JAX ``LlamaConfig``, with a torch
    dtype.  ``flash_block_q/k`` are TPU tiling knobs the port does not read
    (the CUDA kernels' tiles are fixed, see ``ops/attention.py``);
    ``remat_policy`` other than ``"full"`` and ``sp_ring=True`` raise until
    they are ported (ROADMAP.md)."""

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


def _load_tree(model: nn.Module, np_tree: Mapping[str, Any],
               dtype: torch.dtype) -> None:
    """Copy every parameter from the numpy tree at its own name's path
    (``layers.0.attn.wq`` -> ``np_tree["layers"][0]["attn"]["wq"]``)."""
    for name, p in model.named_parameters():
        node = np_tree
        for key in name.split("."):
            node = node[int(key)] if key.isdigit() else node[key]
        t = _to_tensor(node, dtype, p.device)
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
    _load_tree(model, np_tree, config.dtype)
    return model.requires_grad_(trainable)


def _attention(config: LlamaConfig, x: torch.Tensor, layer: Block,
               cos: torch.Tensor, sin: torch.Tensor,
               lora_layer: Optional["LoraLayer"] = None) -> torch.Tensor:
    B, S, d = x.shape
    hd = config.head_dim
    a = layer.attn
    q = x @ a.wq
    k = x @ a.wk
    v = x @ a.wv
    if lora_layer is not None:
        # LoRA on wq/wv (standard recipe): delta = x @ A @ B * (alpha/r).
        scale = lora_layer.scale
        q = q + ((x @ lora_layer.wq_lora_a) @ lora_layer.wq_lora_b) * scale
        v = v + ((x @ lora_layer.wv_lora_a) @ lora_layer.wv_lora_b) * scale
    q = q.view(B, S, config.n_heads, hd).transpose(1, 2)
    k = k.view(B, S, config.n_kv_heads, hd).transpose(1, 2)
    v = v.view(B, S, config.n_kv_heads, hd).transpose(1, 2)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    out = flash_attention(q, k, v, causal=True)
    return out.transpose(1, 2).reshape(B, S, d) @ a.wo


def _mlp(layer: Block, x: torch.Tensor) -> torch.Tensor:
    m = layer.mlp
    return (torch.nn.functional.silu(x @ m.w1) * (x @ m.w3)) @ m.w2


def _block(config: LlamaConfig, x: torch.Tensor, layer: Block,
           cos: torch.Tensor, sin: torch.Tensor,
           lora_layer: Optional["LoraLayer"] = None) -> torch.Tensor:
    h = rms_norm(x, layer.attn_norm, config.norm_eps)
    x = x + _attention(config, h, layer, cos, sin, lora_layer)
    h = rms_norm(x, layer.mlp_norm, config.norm_eps)
    return x + _mlp(layer, h)


def llama_hidden(config: LlamaConfig, params: Llama, tokens: torch.Tensor,
                 lora_params: Optional["Lora"] = None) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] (logits = hidden @ lm_head).
    Under autograd with ``config.remat`` each block is checkpointed: its
    activations are recomputed in the backward instead of kept."""
    if config.sp_ring:
        raise NotImplementedError(
            "ring attention is not ported yet; see ROADMAP.md, PyTorch/CUDA "
            "port")
    remat = config.remat and torch.is_grad_enabled()
    if remat and config.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={config.remat_policy!r} is not ported yet (only "
            f"'full'); see ROADMAP.md, PyTorch/CUDA port: training")
    x = params.embed[tokens].to(config.dtype)
    cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                config.rope_theta, device=x.device)
    for i, layer in enumerate(params.layers):
        ll = lora_params.layers[i] if lora_params is not None else None
        if remat:
            x = checkpoint(_block, config, x, layer, cos, sin, ll,
                           use_reentrant=False)
        else:
            x = _block(config, x, layer, cos, sin, ll)
    return rms_norm(x, params.final_norm, config.norm_eps)


def llama_apply(config: LlamaConfig, params: Llama, tokens: torch.Tensor,
                lora_params: Optional["Lora"] = None) -> torch.Tensor:
    """Returns fp32 logits [B, S, vocab] for int tokens [B, S]."""
    x = llama_hidden(config, params, tokens, lora_params)
    return (x @ params.lm_head).float()


def llama_loss(config: LlamaConfig, params: Llama, tokens: torch.Tensor,
               targets: torch.Tensor, lora_params: Optional["Lora"] = None,
               ignore_index: int = -100) -> torch.Tensor:
    """Causal-LM cross entropy (fp32 scalar) with a sequence-chunked vocab
    projection: the full fp32 logits ([B, S, vocab], 1 GB at B=1, S=2048,
    vocab 128256, plus its gradient) never materialise.  Each
    ``config.loss_chunk`` slice of the sequence is checkpointed, so its
    logits are recomputed in the backward; when the chunk does not divide
    S the loss takes one unchunked pass."""
    hidden = llama_hidden(config, params, tokens, lora_params)
    S = hidden.shape[1]
    w = params.lm_head

    def chunk_nll(h_c, tgt_c):
        return masked_nll((h_c @ w).float(), tgt_c, ignore_index)

    chunk = config.loss_chunk
    if S % chunk:
        total, count = chunk_nll(hidden, targets)
        return total / count.clamp_min(1)
    total, count = 0.0, 0
    for c in range(0, S, chunk):
        nll, cnt = checkpoint(chunk_nll, hidden[:, c:c + chunk],
                              targets[:, c:c + chunk], use_reentrant=False)
        total, count = total + nll, count + cnt
    return total / count.clamp_min(1)


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
    _load_tree(lora, np_tree, config.dtype)
    return lora.requires_grad_(True)


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
