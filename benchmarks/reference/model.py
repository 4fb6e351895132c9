"""What every family's plain reference shares: the precisions, RMSNorm,
RoPE and causal attention in plain PyTorch.  A family's own block and its
``logits_at`` are in ``reference/<family>.py``.

The port's conventions where a publication leaves a choice: weights in
``[d_in, d_out]`` layout, RoPE on the ``[x1 | x2]`` halves.

Precision: every product goes through ``Precision.mm``.  ``FP32`` is the
reference (the caller turns TF32 off, ``no_tf32``); ``FP8`` rounds both
operands of every product to float8 e4m3 with a per-tensor scale, the
control that a lower precision must fail.  Attention is one sequence at a
time, a few heads at a time, so a 4096-token layer fits.  Nothing of the
program is imported.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

W = Dict[str, torch.Tensor]


class Precision:
    """fp32: the products as they are."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


class FP8(Precision):
    """Both operands of every product rounded to float8 e4m3 (per-tensor
    scale to its largest finite value, 448), the product in fp32."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        scale = t.detach().abs().amax().float().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


FP32 = Precision()


@contextlib.contextmanager
def no_tf32():
    """fp32 products in fp32: TF32 off for the reference's duration."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on [H, S, D] at positions ``pos`` [S], halves layout."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device,
                                        dtype=torch.float32) / d))
    ang = pos.float()[:, None] * inv[None]
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              prec: Precision, heads_at_once: int = 8) -> torch.Tensor:
    """Causal softmax attention of one sequence: q [H, S, D], k and v
    [Hkv, S, D] (query head h reads kv head h // (H / Hkv))."""
    H, S, D = q.shape
    rep = H // k.shape[0]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    outs = []
    for h0 in range(0, H, heads_at_once):
        hs = range(h0, min(H, h0 + heads_at_once))
        kk = torch.stack([k[h // rep] for h in hs])
        vv = torch.stack([v[h // rep] for h in hs])
        s = prec.mm(q[h0:h0 + len(hs)], kk.transpose(1, 2)) * D ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(prec.mm(p, vv))
    return torch.cat(outs)
