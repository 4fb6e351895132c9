"""Device resolution for the port's entry points.

Every entry point (``llama_init``, ``InferenceEngine``) runs on the card
unless the caller asks for the CPU with ``device="cpu"``, as the CPU tests
do.  There is no silent fallback: asking for CUDA (explicitly or by passing
nothing) on a machine without it raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA device; a CUDA device that is not
    available raises ``RuntimeError`` instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

