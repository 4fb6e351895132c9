"""Distributed queue: a bounded multi-producer/multi-consumer channel.

Role-equivalent to the reference's ray.util.queue.Queue (reference:
python/ray/util/queue.py — an actor-backed asyncio.Queue with
blocking/timeout put/get and nowait/batch variants).  The backing actor is
ASYNC, so a blocked put/get parks a coroutine, not a thread — thousands of
waiters cost nothing (the repo's async-actor semaphore machinery does the
rest).
"""

from __future__ import annotations

from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        import asyncio

        self._q: "asyncio.Queue" = asyncio.Queue(maxsize)

    # NOTE: no actor-side timed `put`: asyncio.wait_for(self._q.put(...))
    # cancellation RACES a successful insert — the caller would see Full
    # with the item actually enqueued.  Clients probe with put_nowait.

    async def get(self, timeout: Optional[float] = None):
        import asyncio

        try:
            if timeout is None:
                return True, await self._q.get()
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    async def put_nowait(self, item) -> bool:
        import asyncio

        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    async def put_nowait_batch(self, items: List[Any]) -> int:
        import asyncio

        n = 0
        for item in items:
            try:
                self._q.put_nowait(item)
                n += 1
            except asyncio.QueueFull:
                break
        return n

    async def get_nowait(self):
        import asyncio

        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    async def get_nowait_batch(self, max_items: int) -> List[Any]:
        import asyncio

        out: List[Any] = []
        while len(out) < max_items:
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    async def qsize(self) -> int:
        return self._q.qsize()

    async def maxsize(self) -> int:
        return self._q.maxsize


class Queue:
    """Client handle; picklable, so producers/consumers anywhere in the
    cluster share one queue (reference: queue.py Queue)."""

    # Infinite blocking is re-armed in bounded actor-side waits: each wait
    # parks a coroutine that EXPIRES at the slice boundary, so a caller
    # that dies never leaves an immortal consumer coroutine behind to
    # swallow a later item.
    _BLOCK_SLICE_S = 300.0

    def __init__(self, maxsize: int = 0, *,
                 actor_options: Optional[dict] = None,
                 _actor=None, _maxsize=None):
        if _actor is not None:
            self._actor = _actor
            self._maxsize = _maxsize
            return
        opts = dict(actor_options or {})
        cls = _QueueActor.options(**opts) if opts else _QueueActor
        self._actor = cls.remote(maxsize)
        self._maxsize = maxsize

    # -- blocking ------------------------------------------------------------

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        # put is NOT idempotent, so BOTH blocking paths probe with
        # put_nowait instead of a timed actor-side put: an actor-side
        # asyncio.wait_for(self._q.put(item)) whose cancellation races a
        # successful insert would make the client raise Full with the
        # item actually enqueued (phantom insert), and retrying a
        # timed-out put could double-insert if the first landed late.
        if not block:
            return self.put_nowait(item)
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok = ray_tpu_torch.get(self._actor.put_nowait.remote(item),
                             timeout=60)
            if ok:
                return
            if deadline is not None and time.monotonic() >= deadline:
                raise Full(f"queue full after {timeout}s")
            time.sleep(0.05)

    def get(self, block: bool = True,
            timeout: Optional[float] = None) -> Any:
        if not block:
            return self.get_nowait()
        remaining = timeout
        while True:
            slice_s = (self._BLOCK_SLICE_S if remaining is None
                       else min(remaining, self._BLOCK_SLICE_S))
            ok, item = ray_tpu_torch.get(self._actor.get.remote(slice_s),
                                   timeout=slice_s + 30)
            if ok:
                return item
            if remaining is not None:
                remaining -= slice_s
                if remaining <= 0:
                    raise Empty(f"queue empty after {timeout}s")

    # -- nowait --------------------------------------------------------------

    def put_nowait(self, item) -> None:
        if not ray_tpu_torch.get(self._actor.put_nowait.remote(item),
                           timeout=60):
            raise Full("queue full")

    def get_nowait(self) -> Any:
        ok, item = ray_tpu_torch.get(self._actor.get_nowait.remote(), timeout=60)
        if not ok:
            raise Empty("queue empty")
        return item

    def put_nowait_batch(self, items: List[Any]) -> None:
        n = ray_tpu_torch.get(self._actor.put_nowait_batch.remote(list(items)),
                        timeout=60)
        if n < len(items):
            raise Full(f"queue accepted only {n}/{len(items)} items")

    def get_nowait_batch(self, max_items: int) -> List[Any]:
        return ray_tpu_torch.get(
            self._actor.get_nowait_batch.remote(max_items), timeout=60)

    # -- introspection -------------------------------------------------------

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote(), timeout=60)

    def size(self) -> int:
        return self.qsize()

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        if self._maxsize is None:  # handle rebuilt before maxsize shipped
            self._maxsize = ray_tpu_torch.get(self._actor.maxsize.remote(),
                                        timeout=60)
        return self._maxsize > 0 and self.qsize() >= self._maxsize

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self._actor)

    def __reduce__(self):
        return (_rebuild_queue, (self._actor, self._maxsize))


def _rebuild_queue(actor, maxsize=None):
    return Queue(_actor=actor, _maxsize=maxsize)
