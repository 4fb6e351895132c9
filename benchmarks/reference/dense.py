"""The plain reference of the dense family (``families/dense.py``):
Mistral-7B's block (RMSNorm, GQA attention with RoPE, SwiGLU) in plain
PyTorch, fp32, read at the positions that a served request's tokens came
from.  Nothing of the program is imported.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from reference.model import FP32, W, Precision, attention, rms_norm, rope


def _attn_half(cfg: Dict, w: W, x: torch.Tensor, prec: Precision
               ) -> torch.Tensor:
    """x + attention(norm(x)) for rows x [B, S, d], one row at a time."""
    B, S, d = x.shape
    H, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    D = d // H
    pos = torch.arange(S, device=x.device)
    outs = []
    for b in range(B):
        h = rms_norm(x[b], w["attn_norm"], cfg["norm_eps"])
        q = prec.mm(h, w["attn.wq"]).view(S, H, D).transpose(0, 1)
        k = prec.mm(h, w["attn.wk"]).view(S, Hkv, D).transpose(0, 1)
        v = prec.mm(h, w["attn.wv"]).view(S, Hkv, D).transpose(0, 1)
        o = attention(rope(q, pos, cfg["rope_theta"]),
                      rope(k, pos, cfg["rope_theta"]), v, prec)
        outs.append(prec.mm(o.transpose(0, 1).reshape(S, d), w["attn.wo"]))
    return x + torch.stack(outs)


def _swiglu(h: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(h, w1)) * prec.mm(h, w3), w2)


def block(cfg: Dict, w: W, x: torch.Tensor, prec: Precision
          ) -> torch.Tensor:
    """One layer over rows x [B, S, d]."""
    x = _attn_half(cfg, w, x, prec)
    h = rms_norm(x, w["mlp_norm"], cfg["norm_eps"])
    return x + _swiglu(h, w["mlp.w1"], w["mlp.w3"], w["mlp.w2"], prec)


@torch.no_grad()
def logits_at(cfg: Dict, layer_w: Callable[[int], W],
              glob: W, seqs: List[torch.Tensor], rows: List[torch.Tensor],
              prec: Precision = FP32) -> List[torch.Tensor]:
    """Logits [len(rows[i]), V] of sequence ``seqs[i]`` (token ids) at
    positions ``rows[i]``, one layer at a time over every sequence
    (``layer_w(i)`` makes layer i's fp32 weights)."""
    xs = [glob["embed"][s.long()][None] for s in seqs]
    for i in range(cfg["n_layers"]):
        w = layer_w(i)
        xs = [block(cfg, w, x, prec) for x in xs]
        del w
    out = []
    for x, r in zip(xs, rows):
        h = rms_norm(x[0, r], glob["final_norm"], cfg["norm_eps"])
        out.append(prec.mm(h, glob["lm_head"]))
    return out
