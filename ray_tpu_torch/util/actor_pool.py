"""ActorPool: load-balance a stream of work over a fixed set of actors.

Role-equivalent to the reference's ray.util.ActorPool (reference:
python/ray/util/actor_pool.py — map/map_unordered/submit/get_next over a
list of actor handles, idle actors reused as results drain).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List

import ray_tpu_torch


class ActorPool:
    """A pool of actor handles fed by `fn(actor, value) -> ObjectRef`.

    Ordered consumption (`map`/`get_next`) buffers out-of-order completions
    until their turn; unordered consumption yields whatever finishes first.
    """

    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        # ref -> (actor, submission index)
        self._inflight: dict = {}
        self._next_submit = 0   # next submission index to assign
        self._next_yield = 0    # next index an ordered get returns
        self._ready_ordered: dict = {}  # index -> value (completed early)
        # Indices already handed out by get_next_unordered: ordered gets
        # skip them (reference: ActorPool tracks returned futures so the
        # two consumption modes can interleave mid-stream).
        self._consumed_unordered: set = set()

    # -- submission ----------------------------------------------------------

    def has_free(self) -> bool:
        return bool(self._idle)

    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """Dispatch one work item to an idle actor (raises when none —
        check has_free(), or use map which interleaves automatically)."""
        if not self._idle:
            raise RuntimeError("no idle actors; drain results first")
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._inflight[ref] = (actor, self._next_submit)
        self._next_submit += 1

    def push(self, actor: Any) -> None:
        """Return an external actor to the pool (reference: push)."""
        self._idle.append(actor)

    def pop_idle(self) -> Any:
        if not self._idle:
            raise RuntimeError("no idle actors")
        return self._idle.pop()

    # -- consumption ---------------------------------------------------------

    def has_next(self) -> bool:
        return bool(self._inflight) or bool(self._ready_ordered)

    def _wait_one(self, timeout: float):
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        actor, idx = self._inflight.pop(ref)
        self._idle.append(actor)
        return idx, ray_tpu_torch.get(ref)

    def _maybe_reset(self):
        # Fully drained: restart index bookkeeping (keeps the skip set
        # from growing across independent map phases).
        if not self._inflight and not self._ready_ordered:
            self._next_submit = 0
            self._next_yield = 0
            self._consumed_unordered.clear()

    def get_next_unordered(self, timeout: float = 3600.0) -> Any:
        if self._ready_ordered:
            # Buffered by an earlier ordered wait: drain those first.
            idx = next(iter(self._ready_ordered))
            value = self._ready_ordered.pop(idx)
            self._consumed_unordered.add(idx)
            self._maybe_reset()
            return value
        if not self._inflight:
            raise StopIteration("nothing in flight")
        idx, value = self._wait_one(timeout)
        self._consumed_unordered.add(idx)
        self._maybe_reset()
        return value

    def get_next(self, timeout: float = 3600.0) -> Any:
        """Next result in SUBMISSION order (buffers later completions;
        indices an interleaved get_next_unordered already returned are
        skipped).  ``timeout`` bounds the WHOLE call, not each internal
        wait."""
        import time

        deadline = time.monotonic() + timeout
        while self._next_yield in self._consumed_unordered:
            self._consumed_unordered.discard(self._next_yield)
            self._next_yield += 1
        target = self._next_yield
        while target not in self._ready_ordered:
            if not self._inflight:
                raise StopIteration("nothing in flight")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("no result within timeout")
            self._ready_ordered.update([self._wait_one(remaining)])
        self._next_yield += 1
        value = self._ready_ordered.pop(target)
        self._maybe_reset()
        return value

    # -- bulk ----------------------------------------------------------------

    def _map_impl(self, fn, values, ordered: bool) -> Iterator[Any]:
        it = iter(values)
        exhausted = False
        while True:
            while not exhausted and self._idle:
                try:
                    v = next(it)
                except StopIteration:
                    exhausted = True
                    break
                self.submit(fn, v)
            if not self.has_next():
                return
            yield self.get_next() if ordered else self.get_next_unordered()

    def map(self, fn: Callable[[Any, Any], Any],
            values: Iterable[Any]) -> Iterator[Any]:
        """Ordered results; work interleaves with consumption (reference:
        map — lazy, so an unconsumed iterator submits nothing)."""
        return self._map_impl(fn, values, ordered=True)

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]) -> Iterator[Any]:
        return self._map_impl(fn, values, ordered=False)
