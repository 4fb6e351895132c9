"""The yardstick: the card's published peaks and the operations and bytes
that the model's work needs at a call's input shapes, whatever implements
it.  A later kernel cannot change what it is measured against.

Peaks: NVIDIA H100 SXM data sheet, dense rates: 989 TFLOP/s bf16, 3.35
TB/s HBM3.  Shares are stated against them; the card's power limit is
printed beside every run.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def min_time(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def attention_fwd(b: int, h: int, hkv: int, s: int, d: int,
                  elem: int = 2, causal: bool = True) -> Tuple[float, float]:
    """(FLOP, bytes) of causal attention's forward over [b, h, s, d]
    queries and [b, hkv, s, d] keys and values: two products over the
    causal half; q, k, v read once, the output and its fp32 log-sum-exp
    written once."""
    frac = 0.5 if causal else 1.0
    flop = 2 * 2 * b * h * s * s * d * frac
    nbytes = elem * b * s * d * (2 * h + 2 * hkv) + 4 * b * h * s
    return flop, nbytes


def param_count(port: Dict) -> int:
    """Parameters of a dense decoder configuration (untied head)."""
    d, f, v, L = (port["d_model"], port["d_ff"], port["vocab_size"],
                  port["n_layers"])
    kv = port["n_kv_heads"] * (d // port["n_heads"])
    layer = 2 * d * d + 2 * d * kv + 2 * d + 3 * d * f
    return 2 * v * d + d + L * layer


def prefill_flop(port: Dict, n: int) -> float:
    """The training benchmarks' MFU convention (6N + 6 L S d a token) in
    forward form for a prompt of ``n`` real tokens: 2N a token plus
    causal attention, 2 L n^2 d."""
    N = param_count(port)
    return 2 * N * n + 2 * port["n_layers"] * n * n * port["d_model"]
