"""Autoregressive decoding with a KV cache (port of
``ray_tpu/models/generate.py``).

Same cache layout, one ``[L, B, H_kv, S, D]`` buffer each for K and V, and
the same decode attention order (fp32 scores, softmax, probabilities cast
to the cache dtype before the product with V).  PyTorch runs eagerly, so
there is no jit: where the JAX package donates the cache and returns a new
one, the port writes rotated K/V into the cache in place (``copy_``) and
returns the same buffers.  The prompt's own attention (prefill, ``start ==
0``) goes through ``flash_attention`` (kernel K1 on the card), the same call
the paged engine's prefill makes; decode steps attend the cache with the
plain masked softmax.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..ops.attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from .llama import Llama, LlamaConfig, _mlp

KVCache = Dict[str, torch.Tensor]  # {"k": [L, B, H_kv, S, D], "v": ...}


def init_kv_cache(config: LlamaConfig, batch: int,
                  max_seq: Optional[int] = None,
                  device: Optional[torch.device] = None) -> KVCache:
    s = max_seq or config.max_seq
    shape = (config.n_layers, batch, config.n_kv_heads, s, config.head_dim)
    return {"k": torch.zeros(shape, dtype=config.dtype, device=device),
            "v": torch.zeros(shape, dtype=config.dtype, device=device)}


def _qkv(config: LlamaConfig, layer, x: torch.Tensor):
    B, S, _ = x.shape
    a = layer.attn
    q = (x @ a.wq).view(B, S, config.n_heads, config.head_dim).transpose(1, 2)
    k = (x @ a.wk).view(B, S, config.n_kv_heads,
                        config.head_dim).transpose(1, 2)
    v = (x @ a.wv).view(B, S, config.n_kv_heads,
                        config.head_dim).transpose(1, 2)
    return q, k, v


def _cached_attention(config: LlamaConfig, q: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      length: Union[int, torch.Tensor]) -> torch.Tensor:
    """Attend q [B, H, S_q, D] over the first ``length`` cached positions
    (the whole cache is scored and the unwritten tail masked)."""
    B, H, Sq, D = q.shape
    n_rep = config.n_heads // config.n_kv_heads
    if n_rep > 1:
        k_cache = k_cache.repeat_interleave(n_rep, dim=1)
        v_cache = v_cache.repeat_interleave(n_rep, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k_cache.float()) * (D ** -0.5)
    pos = torch.arange(k_cache.shape[2], device=q.device)[None, None, None, :]
    row = torch.arange(Sq, device=q.device)[None, None, :, None]
    limit = length - Sq + row
    scores = torch.where(pos <= limit, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v_cache)


def _forward_cached(config: LlamaConfig, params: Llama, tokens: torch.Tensor,
                    cache: KVCache, start: int):
    """Run ``tokens`` (at absolute positions start..start+S) through every
    layer, writing rotated K/V into the cache in place; returns (logits of
    the LAST position [B, vocab], cache)."""
    B, S = tokens.shape
    x = params.embed[tokens].to(config.dtype)
    cos, sin = rope_frequencies(config.head_dim, cache["k"].shape[3],
                                config.rope_theta, device=x.device)
    length = start + S
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.attn_norm, config.norm_eps)
        q, k, v = _qkv(config, layer, h)
        q = apply_rotary(q, cos, sin, position_offset=start)
        k = apply_rotary(k, cos, sin, position_offset=start)
        cache["k"][i, :, :, start:length].copy_(k)
        cache["v"][i, :, :, start:length].copy_(v)
        if start == 0:
            out = flash_attention(q, k, v, causal=True)
        else:
            out = _cached_attention(config, q, cache["k"][i], cache["v"][i],
                                    length)
        out = out.transpose(1, 2).reshape(B, S, -1)
        x = x + out @ layer.attn.wo
        h = rms_norm(x, layer.mlp_norm, config.norm_eps)
        x = x + _mlp(layer, h)
    x = rms_norm(x, params.final_norm, config.norm_eps)
    logits = (x[:, -1] @ params.lm_head).float()
    return logits, cache


@torch.no_grad()
def llama_prefill(config: LlamaConfig, params: Llama, tokens: torch.Tensor,
                  cache: KVCache):
    """The whole prompt in one pass; cache filled for positions [0, S)."""
    return _forward_cached(config, params, tokens, cache, 0)


@torch.no_grad()
def llama_decode_step(config: LlamaConfig, params: Llama,
                      token: torch.Tensor, cache: KVCache, pos: int):
    """One token ([B, 1]) at position ``pos``; the cache is updated in
    place (the JAX version donates it)."""
    return _forward_cached(config, params, token, cache, pos)


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0.0 or generator is None:
        return logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def generate(config: LlamaConfig, params: Llama, prompt_tokens, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             seed: int = 0, stop_token: Optional[int] = None,
             stream: Optional[Callable[[np.ndarray], None]] = None
             ) -> torch.Tensor:
    """Greedy/temperature decoding on the model's device; returns
    [B, S_prompt + new] int32 tokens.  ``stream`` receives each new token
    batch (numpy) as it decodes.  Temperature sampling draws from a
    ``torch.Generator`` seeded with ``seed``: the same distribution as the
    JAX version, not the same draws."""
    dev = params.device
    prompt = torch.as_tensor(np.asarray(prompt_tokens, np.int32),
                             device=dev).long()
    B, s_prompt = prompt.shape
    cache = init_kv_cache(config, B, s_prompt + max_new_tokens, device=dev)
    logits, cache = llama_prefill(config, params, prompt, cache)
    gen = (torch.Generator(device=dev).manual_seed(seed)
           if temperature > 0 else None)
    out = [prompt.to(torch.int32)]
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for step in range(max_new_tokens):
        token = _sample(logits, temperature, gen)  # [B]
        if stop_token is not None:
            done |= token == stop_token
        out.append(token[:, None])
        if stream is not None:
            stream(token.cpu().numpy())
        if stop_token is not None and bool(done.all()):
            break
        if step + 1 < max_new_tokens:
            logits, cache = llama_decode_step(
                config, params, token[:, None].long(), cache, s_prompt + step)
    return torch.cat(out, dim=1)
