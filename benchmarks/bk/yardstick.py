"""The yardstick: the card's published peaks and the operations and bytes
that a kernel's work needs at a call's input shapes, whatever implements
it.  A later kernel cannot change what it is measured against.  What a
whole model counts (its parameters, a prefill's FLOP, each layer's
attention shape) is its family's (``families/<family>.py``).

Peaks: NVIDIA H100 SXM data sheet, rates without sparsity: 989 TFLOP/s
bf16, 3.35 TB/s HBM3.  Shares are stated against them; the card's power
limit is printed beside every run.
"""

from __future__ import annotations

from typing import Optional, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def min_time(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def attention_fwd(b: int, h: int, hkv: int, s: int, d: int,
                  elem: int = 2, causal: bool = True,
                  window: Optional[int] = None) -> Tuple[float, float]:
    """(FLOP, bytes) of causal attention's forward over [b, h, s, d]
    queries and [b, hkv, s, d] keys and values: two products over the
    causal half (with a sliding ``window``, the band of that width under
    the diagonal); q, k, v read once, the output and its fp32
    log-sum-exp written once."""
    area = s * s * (0.5 if causal else 1.0)
    if causal and window is not None and s > window:
        area -= (s - window) ** 2 / 2
    flop = 2 * 2 * b * h * d * area
    nbytes = elem * b * s * d * (2 * h + 2 * hkv) + 4 * b * h * s
    return flop, nbytes
