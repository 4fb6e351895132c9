"""Shared loss primitives (port of ``ray_tpu/ops/losses.py``).

One masked-NLL implementation for every LM loss of the port (llama's
chunked-vocab cross entropy first): the ``ignore_index`` masking and the
logsumexp algebra must not drift between them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_nll(logits: torch.Tensor, targets: torch.Tensor,
               ignore_index: int = -100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed token NLL over non-ignored positions.

    ``logits`` [..., V] (use fp32 for the reduction), ``targets`` [...]
    int.  Returns (nll_sum, token_count) so callers can combine across
    chunks/microbatches before dividing.
    """
    mask = targets != ignore_index
    tgt = torch.where(mask, targets, torch.zeros_like(targets))
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tgt[..., None].long())[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_index: int = -100) -> torch.Tensor:
    """Mean token NLL (the common single-shot form of ``masked_nll``)."""
    total, count = masked_nll(logits, targets, ignore_index)
    return total / count.clamp_min(1)
