"""Ops of the port: attention (kernels K1, K2, K3), ring attention over
them, RMSNorm (kernel K4), RoPE, losses."""

from .attention import (flash_attention, flash_attention_bwd_dkv,
                        flash_attention_bwd_dq,
                        flash_attention_bwd_ref, flash_attention_fwd,
                        flash_attention_ref, mha_reference)
from .losses import masked_cross_entropy, masked_nll
from .norms import rms_norm, rms_norm_cuda
from .ring_attention import ring_attention
from .rotary import apply_rotary, rope_frequencies

__all__ = ["flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
           "flash_attention_bwd_ref", "flash_attention_fwd",
           "flash_attention_ref", "mha_reference", "masked_cross_entropy",
           "masked_nll", "rms_norm", "rms_norm_cuda", "ring_attention",
           "apply_rotary",
           "rope_frequencies"]
