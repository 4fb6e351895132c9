"""Shared loss primitives (port of ``ray_tpu/ops/losses.py``).

One masked-NLL implementation for every LM loss of the port (llama's
chunked-vocab cross entropy, the MoE loss, the pipeline's loss): the
``ignore_index`` masking and the logsumexp algebra must not drift between
them.  With the vocabulary split over a mesh axis (tensor parallelism) the
same algebra runs over the local slice of the logits, with the max, the
exponentials' sum and the target's logit summed over the axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..collective import mesh_ops


def masked_nll(logits: torch.Tensor, targets: torch.Tensor,
               ignore_index: int = -100, *,
               vocab_axis: Optional[str] = None,
               mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed token NLL over non-ignored positions.

    ``logits`` [..., V] (use fp32 for the reduction), ``targets`` [...]
    int.  Returns (nll_sum, token_count) so callers can combine across
    chunks/microbatches before dividing.  ``vocab_axis``: ``logits`` is
    this rank's contiguous slice of the vocabulary, which that axis of the
    mesh splits in rank order; every rank of the axis returns the same
    sums.
    """
    mask = targets != ignore_index
    tgt = torch.where(mask, targets, torch.zeros_like(targets))
    if vocab_axis is None or mesh_ops.axis_size(vocab_axis, mesh=mesh) == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tgt[..., None].long())[..., 0]
    else:
        n = logits.shape[-1]
        lo = mesh_ops.axis_index(vocab_axis, mesh=mesh) * n
        m = mesh_ops.allreduce(logits.detach().amax(dim=-1), vocab_axis,
                               "max", mesh=mesh)
        logz = m + torch.log(mesh_ops.allreduce(
            torch.exp(logits - m[..., None]).sum(dim=-1), vocab_axis,
            mesh=mesh))
        here = (tgt >= lo) & (tgt < lo + n)
        pick = logits.gather(-1, (tgt - lo).clamp(0, n - 1)[..., None]
                             .long())[..., 0]
        gold = mesh_ops.allreduce(pick * here, vocab_axis, mesh=mesh)
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         ignore_index: int = -100) -> torch.Tensor:
    """Mean token NLL (the common single-shot form of ``masked_nll``)."""
    total, count = masked_nll(logits, targets, ignore_index)
    return total / count.clamp_min(1)
