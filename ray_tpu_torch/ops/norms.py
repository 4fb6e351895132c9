"""RMSNorm: the hand-written CUDA kernel K4 and its plain PyTorch version.

Port of ``ray_tpu/ops/norms.py``.  ``rms_norm_cuda`` launches
``csrc/rms_norm.cu`` (which replaces the Pallas ``_rms_kernel``) for a CUDA
tensor and uses the plain ``_rms_ref`` for a CPU tensor.  ``rms_norm`` is
what the model calls: without autograd (every serving call) it goes through
``rms_norm_cuda``; under autograd it uses the differentiable plain form, as
the JAX package does.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _rms_ref(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("rms_norm")
        fn = lib.rt_rms_norm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def rms_norm_cuda(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim through kernel K4 (any row count).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if not x.is_cuda:
        return _rms_ref(x, w, eps)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rms_norm_cuda takes float32/bfloat16 x with w of "
                        f"the same dtype, got {x.dtype} and {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"w must be [{d}] on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    x2 = x.reshape(-1, d).contiguous()
    w = w.contiguous()
    out = torch.empty_like(x2)
    if x2.shape[0] > 0:
        lib, fn = _kernel()
        code = fn(x2.data_ptr(), w.data_ptr(), out.data_ptr(),
                  _DTYPES[x.dtype], x2.shape[0], d, float(eps),
                  torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, code, "rms_norm")
        rms_norm_cuda.launches += 1
    return out.reshape(x.shape)


rms_norm_cuda.launches = 0


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as the model calls it: kernel K4 unless a gradient is
    needed, then the differentiable plain form."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _rms_ref(x, w, eps)
    return rms_norm_cuda(x, w, eps)
