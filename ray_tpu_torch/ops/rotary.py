"""Rotary position embeddings (RoPE), port of ``ray_tpu/ops/rotary.py``.

Plain tensor code by design, as in the JAX package: RoPE is a cheap
elementwise multiply next to the QK projections.  Same conventions: the
``[x1 | x2]`` halves layout of the last dim, fp32 math, and an
int-or-tensor ``position_offset``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     dtype: torch.dtype = torch.float32,
                     device: Optional[torch.device] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin) tables of shape [max_seq, head_dim // 2]."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 position_offset: Union[int, torch.Tensor] = 0
                 ) -> torch.Tensor:
    """Apply RoPE to [batch, heads, seq, head_dim] (x = [x1 | x2])."""
    seq = x.shape[2]
    if isinstance(position_offset, int) and position_offset == 0:
        c, s = cos[:seq], sin[:seq]
    else:
        idx = position_offset + torch.arange(seq, device=x.device)
        c, s = cos[idx], sin[idx]
    c = c[None, None]
    s = s[None, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
