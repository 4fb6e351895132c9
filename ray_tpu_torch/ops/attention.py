"""Flash attention: the hand-written CUDA kernels K1 (forward), K2 (dQ) and
K3 (dK/dV), and their plain PyTorch versions.

Port of ``ray_tpu/ops/attention.py``.  Layout [batch, heads, seq,
head_dim]; GQA k/v may have fewer heads (kv head = h // (H / Hkv), never
materialised repeated on the kernel path).

- ``mha_reference`` / ``_mha_reference_lse``: the numerical reference,
  one-shot softmax over the whole key axis.
- ``flash_attention_ref``: the plain version of K1, with its tile
  semantics (see its docstring); returns ``(out, lse[B, H, Sq])``.
- ``flash_attention_bwd_ref``: the plain version of K2 + K3, with the same
  tile semantics; returns ``(dq, dk, dv)``.
- ``flash_attention_fwd``: launches ``csrc/flash_fwd.cu`` (which replaces
  the Pallas ``_fwd_kernel``) for CUDA tensors and uses
  ``flash_attention_ref`` for CPU tensors.  When q, k or v needs a
  gradient it goes through ``_FlashAttention``, the twin of the JAX
  ``_flash`` custom VJP, whose backward launches
  ``csrc/flash_bwd.cu`` (``flash_attention_bwd_dq``: Pallas
  ``_bwd_dq_kernel``; ``flash_attention_bwd_dkv``: Pallas
  ``_bwd_dkv_kernel``).  ``flash_attention`` returns the output only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from .. import _build

NEG_INF = -1e30
#: The visiting rule's tiles (q rows, keys) of csrc/flash_fwd.cu and
#: csrc/flash_bwd.cu.  K1's bf16 blocks hold 128 q rows, two such tiles,
#: each with its own cut.  The tiles only matter for rows that see no key
#: at all, whose output and gradient depend on which tiles were visited.
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_K = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The head dims the kernels are built for, per dtype.  bf16 at 64 and 128
#: runs the wgmma + TMA kernels; bf16 at 32 (a 64-byte row, which their
#: 128-byte swizzle does not fit) and fp32 run the CUDA-core kernels,
#: which compute in fp32.
_HEAD_DIMS = {torch.float32: (32, 64, 128), torch.bfloat16: (32, 64, 128)}
_fns = {}


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


def _visited(Sq, Sk, causal, q_offset, block_q, block_k, device):
    """[Sq, Sk] bool: the (row, key) pairs inside a key tile that the
    forward kernel visits for the row's q tile (None: every pair).  With
    ``causal`` and at least two key tiles, the ``block_q``-row tile at
    ``tile_row0`` visits key tiles ``[0, hi)``, ``hi = clip(trunc(
    (tile_row0 + q_offset + block_q + block_k - 1) / block_k), 0, n_kb)``."""
    n_kb = -(-Sk // block_k)
    if not (causal and n_kb >= 2):
        return None
    rows = torch.arange(Sq, device=device)
    tile0 = torch.div(rows, block_q, rounding_mode="floor") * block_q
    hi = torch.div(tile0 + q_offset + block_q + block_k - 1, block_k,
                   rounding_mode="trunc").clamp(0, n_kb)
    cols = torch.arange(Sk, device=device)
    return cols[None, :] < (hi * block_k)[:, None]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: Optional[float] = None, q_offset: int = 0,
                        block_q: int = KERNEL_BLOCK_Q,
                        block_k: int = KERNEL_BLOCK_K
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward kernel: ``(out, lse[B, H, Sq])``.

    Equal to ``_mha_reference_lse`` on every row that sees at least one
    key.  Rows that see none follow the kernel's tile visits
    (``_visited``): a fully masked row averages v over the visited keys
    (every masked score is the finite NEG_INF, so ``exp(NEG_INF - NEG_INF)
    = 1``) and a row with no visited tile gets O = 0 and lse = NEG_INF +
    log(1e-30)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    s = _scores(q, k, causal, scale, q_offset)
    visited = _visited(Sq, Sk, causal, q_offset, block_q, block_k, q.device)
    if visited is not None:
        s = torch.where(visited, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1).clamp_min(NEG_INF)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    vr = _repeat_kv(v, H).float()
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _bwd_probs(q, k, v, lse, delta, do, *, causal, sm_scale, q_offset,
               block_q=KERNEL_BLOCK_Q, block_k=KERNEL_BLOCK_K):
    """fp32 ``(p, ds)`` [B, H, Sq, Sk] of the backward, JAX's formula:
    ``p = exp(s - lse)``, ``ds = p * (dO.v^T - delta) * scale``, zero on
    pairs the forward kernel did not visit."""
    Sq, Sk = q.shape[2], k.shape[2]
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = _scores(q, k, causal, scale, q_offset)
    p = torch.exp(s - lse.float()[..., None])
    visited = _visited(Sq, Sk, causal, q_offset, block_q, block_k, q.device)
    if visited is not None:
        p = torch.where(visited, p, torch.zeros_like(p))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(),
                      _repeat_kv(v, q.shape[1]).float())
    ds = p * (dp - delta.float()[..., None]) * scale
    return p, ds


def _sum_groups(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """[B, H, S, D] -> [B, Hkv, S, D], summing each kv head's q heads."""
    B, H, S, D = x.shape
    return x.view(B, kv_heads, H // kv_heads, S, D).sum(dim=2)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            q_offset: int = 0,
                            block_q: int = KERNEL_BLOCK_Q,
                            block_k: int = KERNEL_BLOCK_K
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the backward kernels: ``(dq, dk, dv)`` in the
    dtypes of q, k and v, computed in fp32 from the forward's ``lse`` and
    ``delta = rowsum(dO * O)`` ([B, H, Sq], from the caller: ring attention
    passes global values).  A (row, key) pair contributes only if the
    forward visited it with these tiles; the GQA gradient of each kv head
    sums its q heads."""
    p, ds = _bwd_probs(q, k, v, lse, delta, do, causal=causal,
                       sm_scale=sm_scale, q_offset=q_offset, block_q=block_q,
                       block_k=block_k)
    Hkv = k.shape[1]
    dq = torch.einsum("bhqk,bhkd->bhqd", ds,
                      _repeat_kv(k, q.shape[1]).float())
    dk = _sum_groups(torch.einsum("bhqk,bhqd->bhkd", ds, q.float()), Hkv)
    dv = _sum_groups(torch.einsum("bhqk,bhqd->bhkd", p, do.float()), Hkv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------- the kernels


def _kernel(name: str, entry: str, n_ptrs: int):
    """ctypes entry ``entry`` of ``csrc/<name>.cu``: ``n_ptrs`` pointers,
    dtype, B, H, Hkv, Sq, Sk, D, a strides pointer, scale, causal,
    q_offset, stream."""
    if entry not in _fns:
        lib = _build.load(name)
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[entry] = (lib, fn)
    return _fns[entry]


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """The kernels read rows with 16-byte loads through (batch, head, seq)
    strides: they need a contiguous last dim and 16-byte aligned rows."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % vec == 0 for st in t.stride()[:3])):
        return t
    return t.contiguous()


def _check_shapes(q, k, v):
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} are not [B, H(kv), S, D] "
                         f"with H a multiple of Hkv")


def _check_kernel_args(q, k, v, *more):
    """Raise on what the CUDA kernels do not take."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    dims = _HEAD_DIMS[q.dtype]
    if q.shape[-1] not in dims:
        raise ValueError(f"flash attention kernels take head_dim {dims} for "
                         f"{q.dtype}, got head_dim {q.shape[-1]}")
    if any(t.device != q.device for t in (k, v, *more)):
        raise ValueError("flash attention tensors must be on one device")


def _strides(*ts) -> ctypes.Array:
    vals = [st for t in ts for st in t.stride()[:3]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _k1(q, k, v, causal, scale, q_offset):
    """Launch kernel K1: ``(out, lse)``."""
    _check_kernel_args(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if B * H * Sq == 0:
        return out, lse
    strides = _strides(q, k, v)
    lib, fn = _kernel("flash_fwd", "rt_flash_fwd", 5)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D,
              ctypes.addressof(strides), float(scale), int(causal),
              int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _bwd_inputs(q, k, v, lse, delta, do):
    """Check and lay out the backward kernels' inputs."""
    _check_kernel_args(q, k, v, lse, delta, do)
    B, H, Sq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match "
                         f"q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{B}, {H}, {Sq}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    q, k, v, do = (_kernel_layout(t) for t in (q, k, v, do))
    return q, k, v, lse.contiguous(), delta.contiguous(), do


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           do: torch.Tensor, *, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           q_offset: int = 0) -> torch.Tensor:
    """dQ through kernel K2 for CUDA tensors (head_dim 32, 64 or 128 in
    fp32 or bf16); CPU tensors take the plain version.  Arguments as
    ``flash_attention_bwd_ref``."""
    _check_shapes(q, k, v)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, lse, delta, do,
                                       causal=causal, sm_scale=scale,
                                       q_offset=q_offset)[0]
    q, k, v, lse, delta, do = _bwd_inputs(q, k, v, lse, delta, do)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dq = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    if B * H * Sq == 0:
        return dq
    strides = _strides(q, k, v, do)
    lib, fn = _kernel("flash_bwd", "rt_flash_bwd_dq", 7)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
              _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D,
              ctypes.addressof(strides), float(scale), int(causal),
              int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True,
                            sm_scale: Optional[float] = None,
                            q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) through kernel K3 for CUDA tensors (head_dim 32, 64 or 128
    in fp32 or bf16); CPU tensors take the plain version.  Arguments as
    ``flash_attention_bwd_ref``."""
    _check_shapes(q, k, v)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, lse, delta, do,
                                       causal=causal, sm_scale=scale,
                                       q_offset=q_offset)[1:]
    q, k, v, lse, delta, do = _bwd_inputs(q, k, v, lse, delta, do)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dk = torch.empty((B, Hkv, Sk, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Hkv, Sk, D), dtype=v.dtype, device=v.device)
    if B * Hkv * Sk == 0:
        return dk, dv
    strides = _strides(q, k, v, do)
    lib, fn = _kernel("flash_bwd", "rt_flash_bwd_dkv", 8)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              _DTYPES[q.dtype], B, H, Hkv, Sq, Sk, D,
              ctypes.addressof(strides), float(scale), int(causal),
              int(q_offset), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def _forward(q, k, v, causal, scale, q_offset):
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=scale,
                                   q_offset=q_offset)
    return _k1(q, k, v, causal, scale, q_offset)


class _FlashAttention(torch.autograd.Function):
    """The twin of the JAX ``_flash`` custom VJP.  Forward: K1 (CUDA) or
    ``flash_attention_ref`` (CPU), saving ``(q, k, v, out, lse)``.
    Backward: ``delta = rowsum(dO * O)`` in plain torch, then K2 and K3
    (CUDA) or ``flash_attention_bwd_ref`` (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset):
        out, lse = _forward(q, k, v, causal, scale, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, q_offset)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, q_offset = ctx.args
        delta = (do.float() * out.float()).sum(dim=-1)
        kw = dict(causal=causal, sm_scale=scale, q_offset=q_offset)
        if q.is_cuda:
            dq = flash_attention_bwd_dq(q, k, v, lse, delta, do, **kw)
            dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, **kw)
        else:  # the plain version, computed once for all three
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, lse, delta, do,
                                                 **kw)
        return dq, dk, dv, None, None, None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        sm_scale: Optional[float] = None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward: ``(out, lse[B, H, Sq] fp32)``.  CUDA
    tensors launch kernel K1 (head_dim 32, 64 or 128 in fp32 or bf16; any
    sequence lengths); CPU tensors take
    ``flash_attention_ref``.  Under autograd the gradient comes from K2/K3
    (CUDA) or the plain backward (CPU); lse carries no gradient."""
    _check_shapes(q, k, v)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, q_offset)
    return _forward(q, k, v, causal, scale, q_offset)


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention over [batch, heads, seq, head_dim]; see
    ``flash_attention_fwd``."""
    out, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                 q_offset=q_offset)
    return out
