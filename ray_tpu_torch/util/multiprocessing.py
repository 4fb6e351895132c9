"""multiprocessing.Pool API over cluster tasks.

Role-equivalent to the reference's ray.util.multiprocessing (reference:
python/ray/util/multiprocessing/pool.py — a drop-in Pool whose workers are
actors, so existing multiprocessing code scales past one machine).  Here
work ships as plain tasks with chunking: the scheduler's worker pool
already provides process reuse, so no dedicated actor fleet is needed.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
def _run_chunk(fn_blob: bytes, chunk: List[tuple], star: bool) -> List[Any]:
    import cloudpickle

    fn = cloudpickle.loads(fn_blob)
    return [fn(*args) if star else fn(args[0]) for args in chunk]


@ray_tpu_torch.remote
def _apply_one(blob: bytes, args: tuple) -> List[Any]:
    import cloudpickle

    fn, kwds = cloudpickle.loads(blob)
    return [fn(*args, **kwds)]


class AsyncResult:
    """multiprocessing.pool.AsyncResult surface over object refs."""

    def __init__(self, refs: List[Any], single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None) -> Any:
        chunks = ray_tpu_torch.get(self._refs,
                             timeout=-1.0 if timeout is None else timeout)
        flat = [v for chunk in chunks for v in chunk]
        return flat[0] if self._single else flat

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=-1.0 if timeout is None else timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result not ready")
        try:
            self.get(timeout=1.0)
            return True
        except Exception:  # noqa: BLE001 — mirrors multiprocessing
            return False


class Pool:
    """Drop-in multiprocessing.Pool: map/starmap/apply/imap + async
    variants.  `processes` bounds in-flight chunks (defaults to the
    cluster's CPU count at first use)."""

    _FN_CACHE_MAX = 32

    def __init__(self, processes: Optional[int] = None):
        self._processes = processes
        self._closed = False
        self._fn_cache: dict = {}
        # Refs of submitted work, so join() can block until completion;
        # pruned opportunistically to keep long-lived pools bounded.
        self._inflight: List[Any] = []

    def _parallelism(self) -> int:
        if self._processes is None:
            # Resolve once at first use (the submission hot path must not
            # pay a cluster RPC per map call).
            try:
                from ray_tpu_torch.core.context import ctx

                nodes = ctx.client.call("list_state",
                                        {"kind": "nodes"})["items"]
                total = int(sum(
                    n.get("resources", {}).get("CPU", 0) for n in nodes))
                self._processes = max(total, 1)
            except Exception:  # noqa: BLE001 — sane default off-cluster
                self._processes = 4
        return self._processes

    def _blob(self, fn: Callable) -> bytes:
        # Keyed by the function OBJECT (the dict entry keeps it alive):
        # an id()-keyed cache serves stale blobs after CPython reuses a
        # collected function's id — silent wrong results.
        try:
            blob = self._fn_cache.get(fn)
        except TypeError:  # unhashable callable
            import cloudpickle

            return cloudpickle.dumps(fn)
        if blob is None:
            import cloudpickle

            blob = self._fn_cache[fn] = cloudpickle.dumps(fn)
            while len(self._fn_cache) > self._FN_CACHE_MAX:
                self._fn_cache.pop(next(iter(self._fn_cache)))
        return blob

    def _track(self, refs: List[Any]) -> None:
        self._inflight.extend(refs)
        if len(self._inflight) > 256:  # drop completed work's refs
            done, rest = ray_tpu_torch.wait(
                self._inflight, num_returns=len(self._inflight), timeout=0)
            self._inflight = list(rest)

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool is closed")
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()

    def _chunks(self, items: List[tuple], chunksize: Optional[int]):
        if chunksize is None:
            # multiprocessing's heuristic: ~4 chunks per worker.
            chunksize = max(1, len(items) // (self._parallelism() * 4))
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    # -- sync ----------------------------------------------------------------

    def apply(self, fn: Callable, args: tuple = (),
              kwds: Optional[dict] = None) -> Any:
        return self.apply_async(fn, args, kwds).get()

    def map(self, fn: Callable, iterable: Iterable[Any],
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        return self.starmap_async(fn, iterable, chunksize).get()

    # -- async ---------------------------------------------------------------

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: Optional[dict] = None) -> AsyncResult:
        self._check_open()
        import cloudpickle

        blob = cloudpickle.dumps((fn, dict(kwds or {})))
        refs = [_apply_one.remote(blob, tuple(args))]
        self._track(refs)
        return AsyncResult(refs, single=True)

    def map_async(self, fn: Callable, iterable: Iterable[Any],
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        items = [(v,) for v in iterable]
        blob = self._blob(fn)
        refs = [_run_chunk.remote(blob, c, False)
                for c in self._chunks(items, chunksize)]
        self._track(refs)
        return AsyncResult(refs)

    def starmap_async(self, fn: Callable, iterable: Iterable[tuple],
                      chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        items = [tuple(v) for v in iterable]
        blob = self._blob(fn)
        refs = [_run_chunk.remote(blob, c, True)
                for c in self._chunks(items, chunksize)]
        self._track(refs)
        return AsyncResult(refs)

    # -- streaming -----------------------------------------------------------

    @staticmethod
    def _chunk_iter(iterable, size: int):
        """Lazily batch an iterable — imap must consume on demand
        (an infinite generator is legal input)."""
        buf: List[tuple] = []
        for v in iterable:
            buf.append((v,))
            if len(buf) >= size:
                yield buf
                buf = []
        if buf:
            yield buf

    def imap(self, fn: Callable, iterable: Iterable[Any],
             chunksize: int = 1) -> Iterator[Any]:
        self._check_open()
        blob = self._blob(fn)
        window = self._parallelism() * 2
        pending: List[Any] = []
        it = self._chunk_iter(iterable, chunksize)
        exhausted = False
        while True:
            while not exhausted and len(pending) < window:
                try:
                    pending.append(_run_chunk.remote(blob, next(it), False))
                except StopIteration:
                    exhausted = True
            if not pending:
                return
            for v in ray_tpu_torch.get(pending.pop(0)):
                yield v

    def imap_unordered(self, fn: Callable, iterable: Iterable[Any],
                       chunksize: int = 1) -> Iterator[Any]:
        self._check_open()
        blob = self._blob(fn)
        window = self._parallelism() * 2
        pending: List[Any] = []
        it = self._chunk_iter(iterable, chunksize)
        exhausted = False
        while True:
            while not exhausted and len(pending) < window:
                try:
                    pending.append(_run_chunk.remote(blob, next(it), False))
                except StopIteration:
                    exhausted = True
            if not pending:
                return
            ready, rest = ray_tpu_torch.wait(pending, num_returns=1,
                                       timeout=3600)
            pending = list(rest)
            # wait may surface several completions at once: drain them all
            # (dropping any would silently lose results).
            for ref in ready:
                for v in ray_tpu_torch.get(ref):
                    yield v

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        if not self._closed:
            raise ValueError("join() before close()")
        if self._inflight:
            ray_tpu_torch.wait(self._inflight,
                         num_returns=len(self._inflight), timeout=-1.0)
            self._inflight = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
