"""The one generator of serving traffic, driven by a mix file.

The mix's ``shape_seed`` fixes the sizes and the arrival times; the run's
``--seed`` permutes which request gets which sizes and draws the token
ids.  Sizes are drawn in blocks, and ``--seed`` permutes them only within
a block, so every seed sends the same work in every block, in another
order: two seeds differ no more than two runs of one seed would.

- ``open_loop``: independent users.  The lead-in and the window are each
  cut into blocks of ``block_s`` seconds (the last one shorter); a block
  of length ``t`` holds ``round(rate_per_s * t)`` arrivals, placed as a
  Poisson process given its count (sorted uniform times).  So the window
  offers exactly the stated rate.
- ``closed_loop``: ``clients`` callers, each sending its next request when
  the last one ends; they take sizes in turn from blocks of ``block``
  requests.

Lengths are lognormal with the given median and sigma, rounded and
clipped to [min, max].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from reference.weights import group_seed


@dataclasses.dataclass
class Request:
    due: float            # seconds after the lead-in starts (open loop)
    prompt: np.ndarray    # int32 token ids
    max_new: int


def _lengths(rng: np.random.Generator, spec: Dict, n: int) -> np.ndarray:
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], size=n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def block_sizes(mix: Dict, key: Tuple[int, ...], n: int) -> List[tuple]:
    """One block's ``n`` (prompt length, output length) pairs, from the
    mix's shape seed and the block's key alone."""
    rng = np.random.default_rng([mix["shape_seed"], *key])
    p = _lengths(rng, mix["prompt_len"], n)
    o = _lengths(rng, mix["output_len"], n)
    return list(zip(p.tolist(), o.tolist()))


def open_blocks(mix: Dict, lead_s: float, seconds: float
                ) -> List[Tuple[Tuple[int, ...], np.ndarray]]:
    """(key, arrival times) of every block of the lead-in and the window,
    in time order."""
    rate, step = float(mix["rate_per_s"]), float(mix["block_s"])
    out = []
    for seg, (start, length) in enumerate(((0.0, lead_s),
                                           (lead_s, seconds))):
        nb = int(np.ceil(length / step - 1e-9))
        for b in range(nb):
            t0 = start + b * step
            span = min(step, start + length - t0)
            n = int(round(rate * span))
            rng = np.random.default_rng([mix["shape_seed"], seg, b, 1])
            out.append(((seg, b), t0 + np.sort(rng.uniform(0.0, span, n))))
    return out


def requests(mix: Dict, seed: int, vocab: int, lead_s: float = 0.0,
             seconds: float = 0.0, n: int = 0) -> List[Request]:
    """The run's requests in the order they go out: open loop, every
    arrival of the lead-in and the window; closed loop, ``n`` in the order
    the clients take them."""
    if mix["kind"] == "open_loop":
        blocks = [(key, t.tolist()) for key, t in
                  open_blocks(mix, lead_s, seconds)]
    else:
        size = int(mix["block"])
        blocks = [((2, b), [0.0] * size) for b in range(-(-n // size))]
    rng = np.random.default_rng(group_seed(seed, "traffic"))
    out: List[Request] = []
    for key, times in blocks:
        sizes = block_sizes(mix, key, len(times))
        for due, i in zip(times, rng.permutation(len(times))):
            plen, olen = sizes[i]
            prompt = rng.integers(1, vocab, size=plen, dtype=np.int32)
            out.append(Request(due=float(due), prompt=prompt,
                               max_new=int(olen)))
    return out[:n] if mix["kind"] != "open_loop" else out
