"""Flash attention forward: the hand-written CUDA kernel K1 and its plain
PyTorch versions.

Port of the forward half of ``ray_tpu/ops/attention.py``.  Layout
[batch, heads, seq, head_dim]; GQA k/v may have fewer heads (kv head =
h // (H / Hkv), never materialised repeated on the kernel path).

- ``mha_reference`` / ``_mha_reference_lse``: the numerical reference,
  one-shot softmax over the whole key axis.
- ``flash_attention_ref``: the plain version of the kernel, with its tile
  semantics (see its docstring); returns ``(out, lse[B, H, Sq])``.
- ``flash_attention_fwd``: launches ``csrc/flash_fwd.cu`` (which replaces
  the Pallas ``_fwd_kernel``) for CUDA tensors and uses
  ``flash_attention_ref`` for CPU tensors.  ``flash_attention`` returns its
  output only.

The backward kernels (Pallas ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``)
belong to the training slice of the port: asking for a gradient through
the kernel raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build

NEG_INF = -1e30
#: Tile sizes of csrc/flash_fwd.cu (BQ, BK).  They only matter for rows
#: that see no key at all, whose output depends on which tiles were visited.
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_K = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_fn = None


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Plain attention, [B, H, S, D] layout, GQA-aware."""
    out, _ = _mha_reference_lse(q, k, v, causal=causal, sm_scale=sm_scale,
                                q_offset=q_offset)
    return out


def _repeat_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    group = heads // k.shape[1]
    return k if group == 1 else k.repeat_interleave(group, dim=1)


def _scores(q, k, causal, scale, q_offset):
    """fp32 scores q.k^T * scale with the causal NEG_INF mask."""
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     _repeat_kv(k, q.shape[1]).float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    return s


def _mha_reference_lse(q, k, v, *, causal, sm_scale, q_offset=0):
    D = q.shape[-1]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    s = _scores(q, k, causal, scale, q_offset)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    vr = _repeat_kv(v, q.shape[1])
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), vr)
    return out.to(q.dtype), lse


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: Optional[float] = None, q_offset: int = 0,
                        block_q: int = KERNEL_BLOCK_Q,
                        block_k: int = KERNEL_BLOCK_K
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward kernel: ``(out, lse[B, H, Sq])``.

    Equal to ``_mha_reference_lse`` on every row that sees at least one
    key.  Rows that see none follow the kernel: with ``causal`` and at least
    two key tiles, each ``block_q``-row tile visits key tiles
    ``[0, hi)``, ``hi = clip(trunc((tile_row0 + q_offset + block_q +
    block_k - 1) / block_k), 0, n_kb)``; a fully masked row averages v over
    the visited keys (every masked score is the finite NEG_INF, so
    ``exp(NEG_INF - NEG_INF) = 1``) and a row with no visited tile gets
    O = 0 and lse = NEG_INF + log(1e-30)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    s = _scores(q, k, causal, scale, q_offset)
    n_kb = -(-Sk // block_k)
    if causal and n_kb >= 2:
        rows = torch.arange(Sq, device=q.device)
        tile0 = torch.div(rows, block_q, rounding_mode="floor") * block_q
        hi = torch.div(tile0 + q_offset + block_q + block_k - 1, block_k,
                       rounding_mode="trunc").clamp(0, n_kb)
        cols = torch.arange(Sk, device=q.device)
        visited = cols[None, :] < (hi * block_k)[:, None]
        s = torch.where(visited, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1).clamp_min(NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    vr = _repeat_kv(v, H).float()
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_fwd")
        fn = lib.rt_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads rows with 16-byte loads through (batch, head, seq)
    strides: it needs a contiguous last dim and 16-byte aligned rows."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % vec == 0 for st in t.stride()[:3])):
        return t
    return t.contiguous()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: Optional[float] = None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: ``(out, lse[B, H, Sq] fp32)``.  CUDA
    tensors launch kernel K1 (bf16 or fp32, head_dim 64 or 128, any
    sequence lengths); CPU tensors take ``flash_attention_ref``."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} are not [B, H(kv), S, D] "
                         f"with H a multiple of Hkv")
    scale = sm_scale if sm_scale is not None else D ** -0.5
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=scale,
                                   q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention backward kernels (K2/K3) are not ported yet; "
            "see ROADMAP.md, PyTorch/CUDA port: training slice")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B * H * Sq == 0:
        return out, lse
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    lib, fn = _kernel()
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D,
              ctypes.addressof(strides), float(scale), int(causal),
              int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention over [batch, heads, seq, head_dim]; see
    ``flash_attention_fwd``."""
    out, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                 q_offset=q_offset)
    return out
