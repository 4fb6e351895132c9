"""Request batching for async replica methods (port of
``ray_tpu/serve/batching.py``, unchanged).

Role-equivalent to the reference's @serve.batch
(reference: python/ray/serve/batching.py — concurrent calls queue up and one
invocation receives the whole batch; results fan back out).  Model replicas
want batched device calls, so the batcher is the bridge between per-request
handles and one batched call on the card.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float, fn_name: str = ""):
        from ..util.metrics import get_gauge, get_histogram

        self.fn = fn
        self.fn_name = fn_name or getattr(fn, "__name__", "batch")
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        import os

        self._m_size = get_histogram(
            "ray_tpu_serve_batch_size",
            "Items per @serve.batch invocation",
            boundaries=(1, 2, 4, 8, 16, 32, 64, 128),
            tag_keys=("fn",))
        # The depth gauge carries a pid tag: each replica process runs its
        # own batcher and same-(name, tags) gauges merge last-writer-wins
        # at the head.
        self._m_depth = get_gauge(
            "ray_tpu_serve_batch_queue_depth",
            "Requests waiting in the batcher queue",
            tag_keys=("fn", "pid"))
        self._m_tags = {"fn": self.fn_name}
        self._m_depth_tags = {"fn": self.fn_name, "pid": str(os.getpid())}

    def _ensure_loop_state(self):
        if self.queue is None:
            self.queue = asyncio.Queue()
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self):
        while True:
            item = await self.queue.get()
            batch: List = [item]
            deadline = asyncio.get_running_loop().time() + self.timeout
            while len(batch) < self.max_batch_size:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(self.queue.get(), remaining)
                    )
                except asyncio.TimeoutError:
                    break
            args = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            self._m_size.observe(len(batch), tags=self._m_tags)
            self._m_depth.set(self.queue.qsize(), tags=self._m_depth_tags)
            try:
                results = await self.fn(args)
                if len(results) != len(args):
                    raise ValueError(
                        f"@serve.batch function returned {len(results)} "
                        f"results for a batch of {len(args)}"
                    )
                for f, r in zip(futs, results):
                    if not f.done():
                        f.set_result(r)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                for f in futs:
                    if not f.done():
                        f.set_exception(e)

    async def __call__(self, item: Any):
        self._ensure_loop_state()
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put((item, fut))
        return await fut


def batch(_fn: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: `async def method(self, item)` becomes batched — the
    wrapped function is invoked as `fn(self, [items])` and must return a
    list of the same length."""

    def deco(fn):
        # The batcher lives ON the instance (not an id()-keyed side table:
        # ids recycle after GC and a side table would pin instances forever).
        attr = f"__serve_batcher_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(self, item):
            b = getattr(self, attr, None)
            if b is None:
                async def call(items):
                    return await fn(self, items)

                b = _Batcher(call, max_batch_size, batch_wait_timeout_s,
                             fn_name=fn.__name__)
                setattr(self, attr, b)
            return await b(item)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
