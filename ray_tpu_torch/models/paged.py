"""Paged KV cache and the decode/prefill programs of the serve engine
(port of ``ray_tpu/models/paged.py``).

Same layout and contracts as the JAX package:

- ONE KV pool per engine: ``[L, P+1, H_kv, page, D]`` per k/v; page ``P``
  is a scratch page that absorbs writes from inactive batch slots and
  padded prompt tail positions, so slot occupancy, page placement and
  lengths are all data.
- A host-side refcounted free-list allocator (``PageAllocator``, a copy of
  the JAX one) hands pages to sequences; page tables are ``[MAXP]`` int32,
  scratch-filled past the allocated prefix.
- The decode step gathers each slot's pages into a linear view and masks by
  sequence length (plain tensor ops, as in the JAX package).  The prefill
  attends the prompt's own fresh K/V, which is causal attention over one
  sequence: it goes through ``flash_attention`` (kernel K1 on the card).
  Every norm goes through ``rms_norm`` (kernel K4 on the card).

PyTorch runs eagerly: where JAX donates the pools, the port writes K/V into
them in place (``index_put_`` through a per-layer view) and returns the same
tensors.  The PRNG key becomes a ``torch.Generator`` on the pools' device,
advanced in place by each sampling call and returned in the key's place.
``trace_count(name)`` counts the distinct signatures a program has run with
(the shapes, dtypes and devices of its tensor arguments and its static
config): the port's counterpart of a jit specialization, so it stays flat
after warmup as the JAX package's does.  ``call_count(name)`` counts
calls.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Set, Tuple

import torch

from ..ops.attention import flash_attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from .llama import Llama, LlamaConfig, _mlp

PagedPools = Dict[str, torch.Tensor]  # {"k": [L, P+1, H_kv, page, D], "v"}
#: {"qa": [A+1, L, d, r], "qb": [A+1, L, r, d], "va": [A+1, L, d, r],
#:  "vb": [A+1, L, r, kv_out], "scale": [A+1]}: slot A is the zero adapter.
AdapterArrays = Dict[str, torch.Tensor]

#: The paged programs whose signatures and calls are counted.
#: ``prefill_prefix`` stays at 0 until ``paged_prefill_prefix`` is ported.
PAGED_PROGRAMS = ("decode", "prefill", "prefill_prefix")
_signatures: Dict[str, Set[Hashable]] = {n: set() for n in PAGED_PROGRAMS}
_calls: Dict[str, int] = {n: 0 for n in PAGED_PROGRAMS}
_count_lock = threading.Lock()


def _record(name: str, config: LlamaConfig, *tensors: torch.Tensor) -> None:
    """One call of program ``name``: count it, and its signature (what a
    jit specialization keys on) if new."""
    sig = (config, tuple((tuple(t.shape), t.dtype, str(t.device))
                         for t in tensors))
    with _count_lock:
        _calls[name] += 1
        _signatures[name].add(sig)


def trace_count(name: str) -> int:
    """Distinct signatures the named program (``"decode"`` /
    ``"prefill"`` / ``"prefill_prefix"``) has run with."""
    return len(_signatures[name])


def trace_counts() -> Dict[str, int]:
    """Snapshot of every program's trace count."""
    with _count_lock:
        return {n: len(s) for n, s in _signatures.items()}


def call_count(name: str) -> int:
    """Times the named program ran."""
    return _calls[name]


def call_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(_calls)


def init_paged_pools(config: LlamaConfig, num_pages: int, page_size: int,
                     device: Optional[torch.device] = None) -> PagedPools:
    """One pool pair for the whole engine; index ``num_pages`` is the
    scratch page (writes routed there are never read)."""
    shape = (config.n_layers, num_pages + 1, config.n_kv_heads, page_size,
             config.head_dim)
    return {"k": torch.zeros(shape, dtype=config.dtype, device=device),
            "v": torch.zeros(shape, dtype=config.dtype, device=device)}


def init_adapter_pool(config: LlamaConfig, max_adapters: int, rank: int,
                      device: Optional[torch.device] = None
                      ) -> AdapterArrays:
    """``max_adapters`` LoRA slots plus the zero slot at index
    ``max_adapters``, all zeros.  Until the adapter pool is ported the
    engine builds it with ``max_adapters=0``: only the zero slot, which the
    programs take as data like the JAX ones."""
    d = config.d_model
    kv_out = config.n_kv_heads * config.head_dim
    A, L, dt = max_adapters + 1, config.n_layers, config.dtype
    return {
        "qa": torch.zeros((A, L, d, rank), dtype=dt, device=device),
        "qb": torch.zeros((A, L, rank, d), dtype=dt, device=device),
        "va": torch.zeros((A, L, d, rank), dtype=dt, device=device),
        "vb": torch.zeros((A, L, rank, kv_out), dtype=dt, device=device),
        "scale": torch.zeros((A,), dtype=torch.float32, device=device),
    }


def _lora_delta_batched(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Per-slot low-rank delta: h [B, d], a [B, d, r], b [B, r, out],
    scale [B] -> [B, out]."""
    t = torch.einsum("bd,bdr->br", h, a)
    return torch.einsum("br,bro->bo", t, b) * scale[:, None].to(h.dtype)


def _lora_delta_seq(h: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """One adapter over a sequence: h [S, d], a [d, r], b [r, out]."""
    return ((h @ a) @ b) * scale.to(h.dtype)


class PageAllocator:
    """Refcounted free-list page allocator (host side; the engine
    serializes access).  A copy of the JAX package's allocator.

    All-or-nothing ``alloc``: a sequence is admitted only when its whole
    worst-case footprint fits, so decode can never die of page exhaustion
    mid-flight.  ``share`` grows a page's refcount; ``free`` releases one
    ref and only returns the page to the free list at zero.  Releasing a
    page nobody holds fails loudly (a page on two sequences corrupts
    both)."""

    def __init__(self, num_pages: int):
        self.total = num_pages
        self._free: List[int] = list(range(num_pages))
        self._refs: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.total - len(self._free)

    @property
    def shared_count(self) -> int:
        """Pages currently held by more than one owner."""
        return sum(1 for n in self._refs.values() if n > 1)

    def refs(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, or None when the pool can't cover them
        (caller queues or sheds, never partial)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: List[int]) -> None:
        """One more owner per page (must be live)."""
        for p in pages:
            if p not in self._refs:
                raise AssertionError(f"share of unallocated KV page {p}")
            self._refs[p] += 1

    def free(self, pages: List[int]) -> None:
        """Release one ref per page; the page returns to the free list
        only when its last owner lets go."""
        for p in pages:
            n = self._refs.get(p)
            if n is None:
                raise AssertionError(f"double free of KV page {p}")
            if n == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = n - 1


def _rotary_single(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """RoPE for one position per batch slot: x [B, H, D], pos [B]."""
    c = cos[pos][:, None, :]
    s = sin[pos][:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                   key: torch.Generator) -> torch.Tensor:
    """Per-slot greedy/temperature sampling: logits [B, V], temps [B]
    (<= 0 means greedy).  Temperature slots take the Gumbel-max draw, a
    categorical sample from softmax(logits / t), on the logits' device."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    u = torch.rand(logits.shape, generator=key, device=logits.device)
    gumbel = -torch.log(-torch.log(u))
    sampled = (logits / safe_t + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _write_kv(pool: torch.Tensor, layer: int, page_idx: torch.Tensor,
              off: torch.Tensor, kv: torch.Tensor) -> None:
    """pool[layer, page_idx[n], :, off[n], :] = kv[n] in place (kv [N,
    H_kv, D]).  Duplicate indices only ever target the scratch page."""
    pool[layer][page_idx, :, off, :] = kv.to(pool.dtype)


@torch.no_grad()
def paged_decode_step(config: LlamaConfig, params: Llama,
                      pools: PagedPools, adapters: AdapterArrays,
                      tokens: torch.Tensor, page_tables: torch.Tensor,
                      seq_lens: torch.Tensor, active: torch.Tensor,
                      temps: torch.Tensor, adapter_ids: torch.Tensor,
                      key: torch.Generator):
    """One decode step for every batch slot at once.

    tokens [B] int (last sampled token per slot), page_tables [B, MAXP]
    int (scratch index past each sequence's allocated prefix), seq_lens [B]
    int = tokens already cached (the new token is WRITTEN at position
    seq_lens and attends positions <= seq_lens), active [B] bool, temps [B]
    float32, adapter_ids [B] int adapter-pool slots.  Inactive slots pass
    seq_lens=0 and an all-scratch page table.  The pools are updated in
    place.  Returns (next_tokens [B] int32, new_seq_lens [B], key, pools),
    all on the pools' device: the caller's one readback per step is the
    tokens."""
    _record("decode", config, pools["k"], adapters["qa"], tokens,
            page_tables, seq_lens, active, temps, adapter_ids)
    B = tokens.shape[0]
    maxp = page_tables.shape[1]
    ps = pools["k"].shape[3]
    n_rep = config.n_heads // config.n_kv_heads
    tokens, page_tables = tokens.long(), page_tables.long()
    seq_lens, adapter_ids = seq_lens.long(), adapter_ids.long()
    x = params.embed[tokens].to(config.dtype)  # [B, d]
    cos, sin = rope_frequencies(config.head_dim, maxp * ps,
                                config.rope_theta, device=x.device)
    b_idx = torch.arange(B, device=x.device)
    page_idx = page_tables[b_idx, seq_lens // ps]  # [B]
    off = seq_lens % ps
    pos_grid = torch.arange(maxp * ps, device=x.device)[None, None, :]
    qa_g, qb_g = adapters["qa"][adapter_ids], adapters["qb"][adapter_ids]
    va_g, vb_g = adapters["va"][adapter_ids], adapters["vb"][adapter_ids]
    lscale = adapters["scale"][adapter_ids]  # [B]
    hkv, hd = config.n_kv_heads, config.head_dim
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.attn_norm, config.norm_eps)
        a = layer.attn
        q_flat = h @ a.wq + _lora_delta_batched(h, qa_g[:, i], qb_g[:, i],
                                                lscale)
        v_flat = h @ a.wv + _lora_delta_batched(h, va_g[:, i], vb_g[:, i],
                                                lscale)
        q = _rotary_single(q_flat.view(B, config.n_heads, hd), cos, sin,
                           seq_lens)
        k = _rotary_single((h @ a.wk).view(B, hkv, hd), cos, sin, seq_lens)
        v = v_flat.view(B, hkv, hd)
        _write_kv(pools["k"], i, page_idx, off, k)
        _write_kv(pools["v"], i, page_idx, off, v)
        # Each slot's pages as one linear [B, H_kv, MAXP*ps, D] view; the
        # length mask removes scratch / unwritten positions.
        k_seq = pools["k"][i][page_tables].permute(0, 2, 1, 3, 4).reshape(
            B, hkv, maxp * ps, hd)
        v_seq = pools["v"][i][page_tables].permute(0, 2, 1, 3, 4).reshape(
            B, hkv, maxp * ps, hd)
        if n_rep > 1:
            k_seq = k_seq.repeat_interleave(n_rep, dim=1)
            v_seq = v_seq.repeat_interleave(n_rep, dim=1)
        scores = torch.einsum("bhd,bhkd->bhk", q.float(),
                              k_seq.float()) * (hd ** -0.5)
        scores = torch.where(pos_grid <= seq_lens[:, None, None], scores,
                             torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(v_seq.dtype)
        out = torch.einsum("bhk,bhkd->bhd", probs, v_seq)
        x = x + out.reshape(B, -1) @ a.wo
        h = rms_norm(x, layer.mlp_norm, config.norm_eps)
        x = x + _mlp(layer, h)
    x = rms_norm(x, params.final_norm, config.norm_eps)
    logits = (x @ params.lm_head).float()
    toks = _sample_tokens(logits, temps, key)
    new_lens = torch.where(active, seq_lens + 1,
                           torch.zeros_like(seq_lens)).to(torch.int32)
    return toks, new_lens, key, pools


@torch.no_grad()
def paged_prefill(config: LlamaConfig, params: Llama, pools: PagedPools,
                  adapters: AdapterArrays, tokens: torch.Tensor, length: int,
                  page_table: torch.Tensor, adapter_id: int,
                  temp: torch.Tensor, key: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Generator, PagedPools]:
    """Prefill ONE sequence's prompt into its pages and sample the first
    token.

    tokens [1, S_pad] int (prompt padded to a bucket length), length = real
    prompt length, page_table [MAXP], adapter_id adapter-pool slot, temp
    0-d float32.  Padded tail positions write through the page table like
    real ones (their K/V is masked by length until decode overwrites it).
    The pools are updated in place.  Returns (first_token 0-d int32, key,
    pools)."""
    _record("prefill", config, pools["k"], adapters["qa"], tokens,
            page_table, temp)
    _, s_pad = tokens.shape
    ps = pools["k"].shape[3]
    hkv, hd = config.n_kv_heads, config.head_dim
    x = params.embed[tokens[0].long()].to(config.dtype)  # [S_pad, d]
    cos, sin = rope_frequencies(hd, s_pad, config.rope_theta,
                                device=x.device)
    positions = torch.arange(s_pad, device=x.device)
    page_idx = page_table.long()[positions // ps]  # [S_pad]
    off = positions % ps
    qa_g, qb_g = adapters["qa"][adapter_id], adapters["qb"][adapter_id]
    va_g, vb_g = adapters["va"][adapter_id], adapters["vb"][adapter_id]
    lscale = adapters["scale"][adapter_id]
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.attn_norm, config.norm_eps)
        a = layer.attn
        q = (h @ a.wq + _lora_delta_seq(h, qa_g[i], qb_g[i], lscale)
             ).view(s_pad, config.n_heads, hd).transpose(0, 1)  # [H, S, D]
        k = (h @ a.wk).view(s_pad, hkv, hd).transpose(0, 1)
        v = (h @ a.wv + _lora_delta_seq(h, va_g[i], vb_g[i], lscale)
             ).view(s_pad, hkv, hd).transpose(0, 1)
        q = apply_rotary(q[None], cos, sin)
        k = apply_rotary(k[None], cos, sin)
        _write_kv(pools["k"], i, page_idx, off, k[0].transpose(0, 1))
        _write_kv(pools["v"], i, page_idx, off, v.transpose(0, 1))
        out = flash_attention(q, k, v[None], causal=True)[0]  # [H, S, D]
        x = x + out.transpose(0, 1).reshape(s_pad, -1) @ a.wo
        h = rms_norm(x, layer.mlp_norm, config.norm_eps)
        x = x + _mlp(layer, h)
    x = rms_norm(x, params.final_norm, config.norm_eps)
    logits = (x[length - 1:length] @ params.lm_head).float()  # last REAL row
    tok = _sample_tokens(logits, temp.reshape(1), key)[0]
    return tok, key, pools
