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
- The decode step attends each slot's live pages through its page table
  with ``paged_decode_attention`` (kernel K5 on the card, which reads no
  page past the slot's length; on the CPU the JAX package's gather of the
  whole table into a linear view, masked by sequence length).  The prefill
  attends the prompt's own fresh K/V, which is causal attention over one
  sequence: it goes through ``flash_attention`` (kernel K1 on the card).
  The cached-prefix prefill (``paged_prefill_prefix``) attends its suffix
  rows over the sequence's whole gathered page table at the offset
  ``prefix_len``: K1 again, with ``q_offset = prefix_len``.  Every norm
  goes through ``rms_norm`` (kernel K4 on the card).
- ``copy_page`` (the prefix cache's copy-on-write) and ``adapter_load``
  (one LoRA slot of the adapter pool) write the pools in place; like the
  page gathers and the LoRA deltas they are plain tensor ops, as they are
  plain XLA in the JAX package.

PyTorch runs eagerly: where JAX donates the pools, the port writes K/V into
them in place (``index_put_`` through a per-layer view) and returns the same
tensors.  The PRNG key becomes a ``torch.Generator`` on the pools' device,
advanced in place by each sampling call and returned in the key's place.
The first run of a program with a new signature (the shapes, dtypes and
devices of its tensor arguments and its static config) is the port's
counterpart of a jit specialization: it bumps the program's count in the
recompile sentinel's registry (``devtools/jitguard.py``), which raises
``RecompileError`` there once armed under ``RT_DEBUG_JIT=1``.
``trace_count(name)`` / ``trace_counts()`` are aliases over that registry,
as in the JAX package, so they stay flat after warmup.  ``call_count(name)``
counts calls.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Set, Tuple

import torch

from ..device import DeviceLike
from ..devtools import jitguard as _jitguard
from ..ops.attention import flash_attention, paged_decode_attention
from ..ops.norms import rms_norm
from ..ops.rotary import apply_rotary, rope_frequencies
from .llama import Llama, LlamaConfig, Lora, _mlp, lora_from_jax

PagedPools = Dict[str, torch.Tensor]  # {"k": [L, P+1, H_kv, page, D], "v"}
#: {"qa": [A+1, L, d, r], "qb": [A+1, L, r, d], "va": [A+1, L, d, r],
#:  "vb": [A+1, L, r, kv_out], "scale": [A+1]}: slot A is the zero adapter.
AdapterArrays = Dict[str, torch.Tensor]

#: The paged programs whose signatures and calls are counted.
PAGED_PROGRAMS = ("decode", "prefill", "prefill_prefix", "page_copy",
                  "adapter_load")
for _prog in PAGED_PROGRAMS:
    _jitguard.register_program(_prog)
_signatures: Dict[str, Set[Hashable]] = {n: set() for n in PAGED_PROGRAMS}
_calls: Dict[str, int] = {n: 0 for n in PAGED_PROGRAMS}
_count_lock = threading.Lock()


def _record(name: str, config: Optional[LlamaConfig],
            **tensors: torch.Tensor) -> None:
    """One call of program ``name``: count it, and if its signature (what a
    jit specialization keys on: the tensors' shapes, dtypes and devices and
    the static config; host ints passed as data stay out) is new, bump the
    sentinel's registry, which raises ``RecompileError`` when armed (the
    signature is then not kept, so the next call raises again, as a jit
    trace that failed is traced again)."""
    sig = _jitguard.signature_of(tensors)
    key = (config, tuple(sig.items()))
    with _count_lock:
        _calls[name] += 1
        if key in _signatures[name]:
            return
        # stacklevel 3: the caller of the program that called _record.
        _jitguard.bump(name, {"config": config, **sig}, stacklevel=3)
        _signatures[name].add(key)


def trace_count(name: str) -> int:
    """Times the named program (one of ``PAGED_PROGRAMS``) met a new
    signature: its count in the sentinel's registry."""
    return _jitguard.count(name)


def trace_counts() -> Dict[str, int]:
    """Snapshot of every registered program's trace count (a nonzero delta
    between snapshots means a program met a new signature in that
    window)."""
    return _jitguard.counts()


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
    ``max_adapters``, all zeros (scale 0: the base model).  The pool's
    shapes are part of every decode/prefill signature, so loading,
    evicting or remixing adapters adds none: which slot a batch slot reads
    is data."""
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


_ADAPTER_KEYS = ("qa", "qb", "va", "vb", "scale")


def pack_lora(config: LlamaConfig, lora, device: DeviceLike = None
              ) -> AdapterArrays:
    """Stack an adapter's layers into the per-slot layout ``adapter_load``
    writes into the pool: ``{qa [L, d, r], qb [L, r, d], va [L, d, r],
    vb [L, r, kv_out]}`` in ``config.dtype`` and ``scale`` (layer 0's) as a
    0-d float32.  ``lora`` is the port's ``Lora`` (packed on its own device
    unless ``device`` is given) or a numpy tree in the JAX package's layout
    (``{"layers": [{"wq_lora_a": ..., "scale": ...}, ...]}``, as
    ``jax.tree.map(np.asarray, lora_init(...))`` gives), carried across by
    ``lora_from_jax`` onto ``device`` (the card unless ``"cpu"``)."""
    if not isinstance(lora, Lora):
        lora = lora_from_jax(config, lora, device=device)
    dev = lora.layers[0].scale.device if device is None else device
    ls = lora.layers

    def stack(name):
        return torch.stack([getattr(l, name).detach() for l in ls]).to(
            device=dev, dtype=config.dtype)

    return {"qa": stack("wq_lora_a"), "qb": stack("wq_lora_b"),
            "va": stack("wv_lora_a"), "vb": stack("wv_lora_b"),
            "scale": ls[0].scale.detach().to(device=dev,
                                             dtype=torch.float32)}


@torch.no_grad()
def adapter_load(adapters: AdapterArrays, slot: int,
                 packed: AdapterArrays) -> AdapterArrays:
    """Overwrite pool slot ``slot`` with one packed adapter, in place, and
    return the pool (the JAX version donates it).  The slot is data: one
    signature covers every slot.  A packed adapter whose shapes are not
    the pool's (another rank, model or layer count) raises instead of
    broadcasting."""
    _record("adapter_load", None, adapters=adapters["qa"],
            packed=packed["qa"], scale=packed["scale"])
    for name in _ADAPTER_KEYS:
        want = adapters[name].shape[1:]
        if packed[name].shape != want:
            raise ValueError(f"adapter {name} of shape "
                             f"{tuple(packed[name].shape)} does not fit a "
                             f"pool slot of shape {tuple(want)}")
    for name in _ADAPTER_KEYS:
        adapters[name][slot].copy_(packed[name])
    return adapters


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
    _record("decode", config, pools=pools["k"], adapters=adapters["qa"],
            tokens=tokens, page_tables=page_tables, seq_lens=seq_lens,
            active=active, temps=temps, adapter_ids=adapter_ids)
    B = tokens.shape[0]
    maxp = page_tables.shape[1]
    ps = pools["k"].shape[3]
    tables_in, lens_in = page_tables, seq_lens  # K5 reads them as given
    tokens, page_tables = tokens.long(), page_tables.long()
    seq_lens, adapter_ids = seq_lens.long(), adapter_ids.long()
    x = params.embed[tokens].to(config.dtype)  # [B, d]
    cos, sin = rope_frequencies(config.head_dim, maxp * ps,
                                config.rope_theta, device=x.device)
    b_idx = torch.arange(B, device=x.device)
    page_idx = page_tables[b_idx, seq_lens // ps]  # [B]
    off = seq_lens % ps
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
        out = paged_decode_attention(q, pools["k"][i], pools["v"][i],
                                     tables_in, lens_in, scale=hd ** -0.5)
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
    _record("prefill", config, pools=pools["k"], adapters=adapters["qa"],
            tokens=tokens, page_table=page_table, temp=temp)
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


@torch.no_grad()
def paged_prefill_prefix(config: LlamaConfig, params: Llama,
                         pools: PagedPools, adapters: AdapterArrays,
                         tokens: torch.Tensor, prefix_len: int, length: int,
                         page_table: torch.Tensor, adapter_id: int,
                         temp: torch.Tensor, key: torch.Generator
                         ) -> Tuple[torch.Tensor, torch.Generator,
                                    PagedPools]:
    """Prefill only the SUFFIX of a prompt whose first ``prefix_len``
    positions are already cached in this sequence's page table (a radix
    prefix-cache hit: shared pages were written by an earlier identical
    prefill, the copy-on-write page by ``copy_page``).

    tokens [1, S_pad] int = prompt[prefix_len:] padded to a bucket;
    ``prefix_len`` and ``length`` (the FULL prompt length) are host ints
    and data, as in the JAX package: one signature per bucket serves every
    split point, mid-page divergence included.  Each layer writes the
    suffix's K/V through the page table at global positions ``prefix_len +
    row`` (rows at or past ``length`` go to the scratch page: they may not
    own a page, and ``prefix_len + S_pad`` may pass the table's end), then
    gathers its whole table into a linear [1, H_kv, MAXP*ps, D] view and
    attends it causally at ``q_offset = prefix_len`` through
    ``flash_attention`` (kernel K1 on the card).  Every real suffix row
    sees key 0, so this equals the JAX program's masked einsum softmax.
    The pools are updated in place.  Returns (first_token 0-d int32, key,
    pools)."""
    _record("prefill_prefix", config, pools=pools["k"],
            adapters=adapters["qa"], tokens=tokens, page_table=page_table,
            temp=temp)
    _, s_pad = tokens.shape
    maxp = page_table.shape[0]
    ps = pools["k"].shape[3]
    scratch = pools["k"].shape[1] - 1
    hkv, hd = config.n_kv_heads, config.head_dim
    n_ctx = maxp * ps
    x = params.embed[tokens[0].long()].to(config.dtype)  # [S_pad, d]
    cos, sin = rope_frequencies(hd, n_ctx, config.rope_theta,
                                device=x.device)
    dev = x.device
    positions = prefix_len + torch.arange(s_pad, device=dev)  # global
    valid = positions < length
    table = page_table.long()
    # Clamped like the JAX gathers: padded rows may lie past the table.
    page_idx = torch.where(valid, table[(positions // ps).clamp(max=maxp - 1)],
                           torch.full_like(positions, scratch))
    off = torch.where(valid, positions % ps, torch.zeros_like(positions))
    rope_pos = positions.clamp(max=n_ctx - 1)
    qa_g, qb_g = adapters["qa"][adapter_id], adapters["qb"][adapter_id]
    va_g, vb_g = adapters["va"][adapter_id], adapters["vb"][adapter_id]
    lscale = adapters["scale"][adapter_id]
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.attn_norm, config.norm_eps)
        a = layer.attn
        q = (h @ a.wq + _lora_delta_seq(h, qa_g[i], qb_g[i], lscale)
             ).view(s_pad, config.n_heads, hd)
        k = (h @ a.wk).view(s_pad, hkv, hd)
        v = (h @ a.wv + _lora_delta_seq(h, va_g[i], vb_g[i], lscale)
             ).view(s_pad, hkv, hd)
        q = _rotary_single(q, cos, sin, rope_pos)  # per-row global RoPE
        k = _rotary_single(k, cos, sin, rope_pos)
        _write_kv(pools["k"], i, page_idx, off, k)  # write, then gather
        _write_kv(pools["v"], i, page_idx, off, v)
        k_seq = pools["k"][i][table].transpose(0, 1).reshape(1, hkv, n_ctx,
                                                             hd)
        v_seq = pools["v"][i][table].transpose(0, 1).reshape(1, hkv, n_ctx,
                                                             hd)
        out = flash_attention(q.transpose(0, 1)[None], k_seq, v_seq,
                              causal=True, q_offset=prefix_len)[0]
        x = x + out.transpose(0, 1).reshape(s_pad, -1) @ a.wo
        h = rms_norm(x, layer.mlp_norm, config.norm_eps)
        x = x + _mlp(layer, h)
    x = rms_norm(x, params.final_norm, config.norm_eps)
    row = length - prefix_len - 1  # the last REAL suffix row
    logits = (x[row:row + 1] @ params.lm_head).float()
    tok = _sample_tokens(logits, temp.reshape(1), key)[0]
    return tok, key, pools


@torch.no_grad()
def copy_page(pools: PagedPools, src: int, dst: int) -> PagedPools:
    """Copy one page's K/V across every layer, in place (copy-on-write
    when a request diverges mid-page from a cached prefix).  ``src`` and
    ``dst`` are data: one signature covers every divergence."""
    _record("page_copy", None, pools=pools["k"])
    for name in ("k", "v"):
        pools[name][:, dst] = pools[name][:, src]
    return pools
