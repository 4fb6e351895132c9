"""RMSNorm: the hand-written CUDA kernel K4, forward and backward, and
their plain PyTorch versions.

Port of ``ray_tpu/ops/norms.py``.  ``rms_norm_cuda`` launches K4's forward
(``csrc/rms_norm.cu`` ``rt_rms_norm``, which replaces the Pallas
``_rms_kernel``) for a CUDA tensor and uses the plain ``_rms_ref`` for a
CPU tensor.  ``rms_norm_bwd`` launches K4's backward (``rt_rms_norm_bwd``,
the counterpart of XLA's fusion of ``jax.vjp`` of the jnp form) or uses
the plain ``_rms_bwd_ref``.  ``_RMSNorm`` is the autograd Function whose
forward and backward are those two wrappers.  ``rms_norm`` is what the
model calls: without autograd (every serving call) it goes through
``rms_norm_cuda``; under autograd a CUDA tensor goes through ``_RMSNorm``,
so on the card training runs K4 both ways and never the plain form, and a
CPU tensor through the differentiable plain form.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fns = None


def _rms_ref(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _rms_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``_rms_ref`` at x, w for the output gradient dy, in
    fp32 and rounded once: with g = dy·w and r = rsqrt(mean(x²) + eps),
    dx = r·g − x·r³·mean(g·x) and dw = Σ_rows dy·x·r.  The ops follow
    torch autograd's graph of ``_rms_ref`` (bit for bit on the CPU): the
    path through r is −½·Σ(g·x)·r³ / d, added once for each factor of
    x·x."""
    d = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    g = dyf * w
    ds = (-0.5 * (g * xf).sum(dim=-1, keepdim=True) * r.pow(3)) / d
    dx = (g * r + ds * xf) + ds * xf
    dw = (dyf * (xf * r)).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _bind(lib: ctypes.CDLL):
    """(lib, rt_rms_norm, rt_rms_norm_bwd_slots, rt_rms_norm_bwd) of a
    built ``rms_norm.cu``, with their C signatures."""
    fwd = lib.rt_rms_norm
    fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    slots = lib.rt_rms_norm_bwd_slots
    slots.argtypes = [ctypes.c_int] * 4
    slots.restype = ctypes.c_int
    bwd = lib.rt_rms_norm_bwd
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return lib, fwd, slots, bwd


def _kernels():
    global _fns
    if _fns is None:
        _fns = _bind(_build.load("rms_norm"))
    return _fns


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> int:
    """d, after checking that K4 takes x and w."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{what} takes float32/bfloat16 x with w of the "
                        f"same dtype, got {x.dtype} and {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"w must be [{d}] on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    return d


def rms_norm_cuda(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim through kernel K4 (any row count).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if not x.is_cuda:
        return _rms_ref(x, w, eps)
    d = _check(x, w, "rms_norm_cuda")
    x2 = x.reshape(-1, d).contiguous()
    w = w.contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] > 0:
        lib, fn, _, _ = _kernels()
        code = fn(x2.data_ptr(), w.data_ptr(), out.data_ptr(),
                  _DTYPES[x.dtype], x2.shape[0], d, float(eps),
                  torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, code, "rms_norm")
        rms_norm_cuda.launches += 1
    return out.reshape(x.shape)


rms_norm_cuda.launches = 0


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6, *, need_dx: bool = True,
                 need_dw: bool = True
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dw) of RMSNorm through K4's backward; an unwanted gradient is
    None and not computed.  dw is summed without atomics, so it is the
    same bit for bit on every call.  A CPU tensor takes ``_rms_bwd_ref``;
    a CUDA tensor launches the kernels or raises."""
    if not x.is_cuda:
        dx, dw = _rms_bwd_ref(x, w, dy, eps)
        return dx if need_dx else None, dw if need_dw else None
    d = _check(x, w, "rms_norm_bwd")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x ({tuple(x.shape)}, {x.dtype}), "
                         f"got {tuple(dy.shape)}, {dy.dtype} on {dy.device}")
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    w = w.contiguous()
    rows = x2.shape[0]
    dx = torch.empty_like(x2) if need_dx else None
    dw = None
    if need_dw:
        dw = (torch.empty_like(w) if rows > 0 else torch.zeros_like(w))
    if rows > 0 and (need_dx or need_dw):
        lib, _, slots, fn = _kernels()
        ptrs = [t.data_ptr() for t in (x2, w, dy2, dx, dw) if t is not None]
        aligned = int(d % (16 // x.element_size()) == 0
                      and all(p % 16 == 0 for p in ptrs))
        dtype = _DTYPES[x.dtype]
        part = None
        if need_dw:
            n = slots(dtype, rows, d, aligned)
            if n <= 0:
                raise RuntimeError(f"rms_norm_bwd: no plan for rows {rows}, "
                                   f"d {d}")
            part = torch.empty(n, d, dtype=torch.float32, device=x.device)
        code = fn(x2.data_ptr(), w.data_ptr(), dy2.data_ptr(),
                  dx.data_ptr() if dx is not None else None,
                  dw.data_ptr() if need_dw else None,
                  part.data_ptr() if part is not None else None,
                  dtype, rows, d, aligned, float(eps),
                  torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, code, "rms_norm_bwd")
        rms_norm_bwd.launches += 1
    return (dx.reshape(x.shape) if dx is not None else None), dw


rms_norm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with K4 both ways on the card: the forward through
    ``rms_norm_cuda``, saving x and w (r is worked out again in the
    backward), the backward through ``rms_norm_bwd`` for the inputs that
    need a gradient.  CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rms_norm_cuda(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx, dw = rms_norm_bwd(x, w, dy, ctx.eps, need_dx=need_dx,
                              need_dw=need_dw)
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as the model calls it.  Without a gradient: through
    ``rms_norm_cuda``.  Under autograd on the card: the ``_RMSNorm``
    Function, K4's forward and backward kernels.  Under autograd on the
    CPU: the differentiable plain form, whose autograd graph is the JAX
    package's jnp form op for op (``_RMSNorm`` would add x's gradient from
    the norm to the residual's in another order, and the train-step
    parity tests compare Adam updates of gradients below Adam's eps)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if x.is_cuda:
            return _RMSNorm.apply(x, w, eps)
        return _rms_ref(x, w, eps)
    return rms_norm_cuda(x, w, eps)
