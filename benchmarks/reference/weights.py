"""Weights made from ``--seed``, on the device, in a few large calls: the
inputs the benchmark hands to the program and, made again from the same
seed, to the reference.

Each group (the embedding, the output head, one layer's leaves) is one
``torch.randn`` call from its own generator, seeded from (seed, group),
so the reference can make one layer again without the others.  A leaf is
a slice of its group's draw times its scale; norms are ones.  The
distributions are the port's ``llama_init`` ones: embedding N(0, 1),
projections N(0, d^-1/2), down projections N(0, d_ff^-1/2).

Names are the port's parameter names (``layers.3.attn.wq``), so the
harness fills the program's modules by name.  Plain torch: nothing of the
program is imported here.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: (name, shape, std or None for ones)
Leaf = Tuple[str, Tuple[int, ...], float]


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


def layer_leaves(port: Dict[str, int]) -> List[Leaf]:
    """One dense layer's leaves, relative names, in draw order."""
    d, f = port["d_model"], port["d_ff"]
    kv = port["n_kv_heads"] * (d // port["n_heads"])
    sd, sf = d ** -0.5, f ** -0.5
    return [("attn_norm", (d,), None),
            ("attn.wq", (d, d), sd),
            ("attn.wk", (d, kv), sd),
            ("attn.wv", (d, kv), sd),
            ("attn.wo", (d, d), sd),
            ("mlp_norm", (d,), None),
            ("mlp.w1", (d, f), sd),
            ("mlp.w3", (d, f), sd),
            ("mlp.w2", (f, d), sf)]


def global_leaves(port: Dict[str, int]) -> List[Leaf]:
    d, v = port["d_model"], port["vocab_size"]
    return [("embed", (v, d), 1.0),
            ("final_norm", (d,), None),
            ("lm_head", (d, v), d ** -0.5)]


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


def layer_weights(config: Dict, seed: int, layer: int, device
                  ) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s leaves as served."""
    return _draw(layer_leaves(config["port"]), seed,
                 device, DTYPES[config["dtype"]], ("layer", layer))


def global_weights(config: Dict, seed: int, device
                   ) -> Dict[str, torch.Tensor]:
    """The embedding, the final norm and the output head."""
    return _draw(global_leaves(config["port"]), seed, device,
                 DTYPES[config["dtype"]], ("global",))
