"""Weights made from ``--seed``, on the device, in a few large calls: the
inputs the benchmark hands to the program and, made again from the same
seed, to the reference.

Each group (the globals, one layer's leaves) is one ``torch.randn`` call
from its own generator, seeded from (seed, group), so the reference can
make one layer again without the others.  A leaf is a slice of its
group's draw times its scale; norms are ones.  The leaves, their shapes
and their scales are the model family's (``families/<family>.py``:
``global_leaves(port)``, ``layer_leaves(port, i)``), passed in as
``family``.

Names are the port's parameter names (``layers.3.attn.wq``), so the
harness fills the program's modules by name.  Plain torch: nothing of the
program is imported here.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: (name, shape, std or None for ones)
Leaf = Tuple[str, Tuple[int, ...], Optional[float]]


def group_seed(seed: int, *keys) -> int:
    """A 63-bit seed for one group, from the run's seed and the group's
    keys (ints or strings)."""
    words = [seed % (1 << 64)]
    for k in keys:
        words.append(k if isinstance(k, int) else zlib.crc32(k.encode()))
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def generator(seed: int, device, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        group_seed(seed, *keys))


def _draw(leaves: List[Leaf], seed: int, device, dtype: torch.dtype,
          key) -> Dict[str, torch.Tensor]:
    """One randn call for the random leaves; ones for the norms."""
    out: Dict[str, torch.Tensor] = {}
    group = [lf for lf in leaves if lf[2] is not None]
    n = sum(int(np.prod(shape)) for _, shape, _ in group)
    flat = torch.randn(n, generator=generator(seed, device, *key, 0),
                       device=device, dtype=dtype)
    o = 0
    for name, shape, std in group:
        size = int(np.prod(shape))
        out[name] = flat[o:o + size].view(shape).mul_(std)
        o += size
    for name, shape, std in leaves:
        if std is None:
            out[name] = torch.ones(shape, device=device, dtype=dtype)
    return out


def layer_weights(family, config: Dict, seed: int, layer: int, device
                  ) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s leaves as served."""
    return _draw(family.layer_leaves(config["port"], layer), seed,
                 device, DTYPES[config["dtype"]], ("layer", layer))


def global_weights(family, config: Dict, seed: int, device
                   ) -> Dict[str, torch.Tensor]:
    """The globals: for the dense family the embedding, the final norm and
    the output head."""
    return _draw(family.global_leaves(config["port"]), seed, device,
                 DTYPES[config["dtype"]], ("global",))
