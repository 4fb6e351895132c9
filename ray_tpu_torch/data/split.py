"""streaming_split coordinator: one actor hands disjoint block streams to n
consumers.

Role-equivalent to the reference's OutputSplitter operator (reference:
data/_internal/execution/operators/output_splitter.py — round-robin block
routing to n output splits, driven by the streaming executor;
dataset.py streaming_split returns per-split DataIterators).  The
coordinator executes the plan once (first epoch) while assigning block refs
round-robin; later epochs replay the cached assignment, so every Train
worker sees the same shard every epoch.
"""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote(num_cpus=0)
class _SplitCoordinator:
    """Owns plan execution and the per-split block assignment.  Actor method
    calls are serialized (per-actor FIFO), so no locking is needed."""

    def __init__(self, parts: List[tuple], n: int):
        from .dataset import Dataset

        self._ds = Dataset(parts)
        self._n = n
        self._assignment: List[List[Any]] = [[] for _ in range(n)]
        self._iter = None
        self._exhausted = False
        self._epochs = [0] * n

    def begin_epoch(self, split: int) -> int:
        self._epochs[split] += 1
        return self._epochs[split]

    def _pull_until(self, split: int, pos: int) -> None:
        """Drive the streaming executor until `split` has > pos blocks
        assigned (or the plan is exhausted)."""
        if self._iter is None and not self._exhausted:
            self._iter = self._ds._iter_block_refs()
        while not self._exhausted and len(self._assignment[split]) <= pos:
            try:
                ref = next(self._iter)
            except StopIteration:
                self._exhausted = True
                self._iter = None
                return
            # Assign to the currently shortest queue: balanced splits even
            # when consumers advance at different paces.
            target = min(range(self._n), key=lambda i: len(self._assignment[i]))
            self._assignment[target].append(ref)

    def next_block(self, split: int, epoch: int, pos: int) -> Optional[Any]:
        """The pos-th block ref of `split`, or None when the split's stream
        is exhausted for this epoch."""
        self._pull_until(split, pos)
        q = self._assignment[split]
        if pos < len(q):
            return q[pos]
        return None

    def stats(self) -> dict:
        return {
            "splits": self._n,
            "blocks_per_split": [len(q) for q in self._assignment],
            "exhausted": self._exhausted,
            "epochs": list(self._epochs),
        }


def make_split_iterators(ds, n: int) -> List["DataIterator"]:
    from .iterator import DataIterator

    coord = _SplitCoordinator.remote(ds._parts, n)
    return [DataIterator(coord, i) for i in range(n)]
