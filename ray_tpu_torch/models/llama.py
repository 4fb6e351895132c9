"""Llama-family decoder-only transformer, forward pass (port of
``ray_tpu/models/llama.py``).

``Llama`` is an ``nn.Module`` holding the weights in the JAX package's
``[d_in, d_out]`` layout (``x @ w``), so ``params_from_jax`` copies arrays
without transposing and the two packages compare like with like.
``llama_hidden`` / ``llama_apply`` are forward only: no remat, no ring
attention, no loss (the training slice of the port).  Attention goes through
``flash_attention`` (kernel K1 on the card) and every norm through
``rms_norm`` (kernel K4 on the card); the projections and the MLP stay plain
``torch.matmul``, as the JAX package left them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Same fields and stock sizes as the JAX ``LlamaConfig``, with a torch
    dtype.  ``remat``, ``remat_policy``, ``flash_block_q/k`` and
    ``loss_chunk`` are training / TPU-tiling knobs the forward-only port
    does not read (the CUDA kernel's tiles are fixed, see
    ``ops/attention.py``); ``sp_ring=True`` raises until ring attention is
    ported."""

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
    """Weights of one Llama model (frozen: serving only needs the forward
    pass).  ``forward(tokens)`` is ``llama_apply``."""

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


@torch.no_grad()
def llama_init(config: LlamaConfig,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Llama:
    """Random weights with the JAX package's distributions: N(0, 1) embed,
    N(0, d^-1/2) projections, N(0, d_ff^-1/2) down projection, ones for the
    norms; drawn in fp32 from ``generator`` (seed 0 when omitted, on the
    target device) and cast to ``config.dtype``.  The numbers differ from
    ``jax.random``'s for the same seed: tests hand both packages one set of
    numpy weights through ``params_from_jax``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Llama(config, dev)
    std = config.d_model ** -0.5

    def dense(p: nn.Parameter, scale: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=dev) * scale)

    dense(model.embed, 1.0)
    model.final_norm.fill_(1.0)
    dense(model.lm_head, std)
    for layer in model.layers:
        layer.attn_norm.fill_(1.0)
        layer.mlp_norm.fill_(1.0)
        for w in (layer.attn.wq, layer.attn.wk, layer.attn.wv, layer.attn.wo,
                  layer.mlp.w1, layer.mlp.w3):
            dense(w, std)
        dense(layer.mlp.w2, config.d_ff ** -0.5)
    return model


def _to_tensor(a: Any, dtype: torch.dtype, device: torch.device
               ) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no torch bridge
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(device=device, dtype=dtype)


@torch.no_grad()
def params_from_jax(config: LlamaConfig, np_tree: Mapping[str, Any],
                    device: DeviceLike = None) -> Llama:
    """Build the port's model from ``jax.tree.map(np.asarray, params)`` of
    the JAX package's ``llama_init`` (numpy arrays only)."""
    dev = resolve_device(device)
    model = Llama(config, dev)

    def put(p: nn.Parameter, a: Any) -> None:
        t = _to_tensor(a, config.dtype, dev)
        if t.shape != p.shape:
            raise ValueError(f"weight shape {tuple(t.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(t)

    put(model.embed, np_tree["embed"])
    put(model.final_norm, np_tree["final_norm"])
    put(model.lm_head, np_tree["lm_head"])
    if len(np_tree["layers"]) != config.n_layers:
        raise ValueError(f"{len(np_tree['layers'])} layers for a "
                         f"{config.n_layers}-layer config")
    for layer, src in zip(model.layers, np_tree["layers"]):
        put(layer.attn_norm, src["attn_norm"])
        put(layer.mlp_norm, src["mlp_norm"])
        for name in ("wq", "wk", "wv", "wo"):
            put(getattr(layer.attn, name), src["attn"][name])
        for name in ("w1", "w3", "w2"):
            put(getattr(layer.mlp, name), src["mlp"][name])
    return model


def _attention(config: LlamaConfig, x: torch.Tensor, layer: Block,
               cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    B, S, d = x.shape
    hd = config.head_dim
    a = layer.attn
    q = (x @ a.wq).view(B, S, config.n_heads, hd).transpose(1, 2)
    k = (x @ a.wk).view(B, S, config.n_kv_heads, hd).transpose(1, 2)
    v = (x @ a.wv).view(B, S, config.n_kv_heads, hd).transpose(1, 2)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    out = flash_attention(q, k, v, causal=True)
    return out.transpose(1, 2).reshape(B, S, d) @ a.wo


def _mlp(layer: Block, x: torch.Tensor) -> torch.Tensor:
    m = layer.mlp
    return (torch.nn.functional.silu(x @ m.w1) * (x @ m.w3)) @ m.w2


def _block(config: LlamaConfig, x: torch.Tensor, layer: Block,
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, layer.attn_norm, config.norm_eps)
    x = x + _attention(config, h, layer, cos, sin)
    h = rms_norm(x, layer.mlp_norm, config.norm_eps)
    return x + _mlp(layer, h)


@torch.no_grad()
def llama_hidden(config: LlamaConfig, params: Llama,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Final-norm hidden states [B, S, d] (logits = hidden @ lm_head)."""
    if config.sp_ring:
        raise NotImplementedError(
            "ring attention is not ported yet; see ROADMAP.md, PyTorch/CUDA "
            "port")
    x = params.embed[tokens].to(config.dtype)
    cos, sin = rope_frequencies(config.head_dim, config.max_seq,
                                config.rope_theta, device=x.device)
    for layer in params.layers:
        x = _block(config, x, layer, cos, sin)
    return rms_norm(x, params.final_norm, config.norm_eps)


@torch.no_grad()
def llama_apply(config: LlamaConfig, params: Llama,
                tokens: torch.Tensor) -> torch.Tensor:
    """Returns fp32 logits [B, S, vocab] for int tokens [B, S]."""
    x = llama_hidden(config, params, tokens)
    return (x @ params.lm_head).float()
