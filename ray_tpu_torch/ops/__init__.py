"""Ops of the port: attention (kernel K1), RMSNorm (kernel K4), RoPE."""

from .attention import (flash_attention, flash_attention_fwd,
                        flash_attention_ref, mha_reference)
from .norms import rms_norm, rms_norm_cuda
from .rotary import apply_rotary, rope_frequencies

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_ref",
           "mha_reference", "rms_norm", "rms_norm_cuda", "apply_rotary",
           "rope_frequencies"]
