"""Batch iteration: block streams → fixed-size batches → device.

Role-equivalent to the reference's batcher/prefetcher stack (reference:
data/_internal/block_batching/iter_batches.py — resolve→format→batch
pipeline with prefetching) collapsed to two generators: a row-carry batcher
and a one-slot device double buffer.  The next batch's host→device copy is
issued from pinned memory on a side CUDA stream before the current batch is
handed over, so it overlaps the caller's compute on the current batch,
which is what keeps the card from starving (Arrow→device ingest with no
input starvation).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .block import Batch, Block


def batches_from_blocks(
    blocks: Iterator[Block],
    batch_size: int,
    batch_format: str = "numpy",
    drop_last: bool = False,
) -> Iterator[Any]:
    """Re-chunk a block stream into exact batch_size batches, carrying
    remainder rows across block boundaries."""
    carry: Optional[Batch] = None
    for block in blocks:
        if block.num_rows == 0:
            continue
        batch = block.to_numpy()
        if carry is not None:
            batch = {
                k: np.concatenate([carry[k], batch[k]]) for k in batch
            }
            carry = None
        n = len(next(iter(batch.values()))) if batch else 0
        off = 0
        while n - off >= batch_size:
            yield _format({k: v[off:off + batch_size] for k, v in batch.items()},
                          batch_format)
            off += batch_size
        if off < n:
            carry = {k: v[off:] for k, v in batch.items()}
    if carry is not None and not drop_last:
        yield _format(carry, batch_format)


def _format(batch: Batch, batch_format: str) -> Any:
    if batch_format == "numpy":
        return batch
    if batch_format == "pandas":
        return Block.from_batch(batch).to_pandas()
    if batch_format == "pyarrow":
        return Block.from_batch(batch).to_arrow()
    raise ValueError(f"unknown batch_format {batch_format!r}")


def _torch_dtype(dt: np.dtype):
    """The torch dtype of a numpy column, or None for one torch cannot
    hold (object, str, bytes, datetimes): those columns stay numpy."""
    import torch

    if dt.kind not in "biufc":
        return None
    try:
        return torch.from_numpy(np.empty(0, dt)).dtype
    except TypeError:  # a numpy dtype this torch build lacks
        return None


def device_prefetch(batches: Iterator[Batch], device: Any) -> Iterator[Any]:
    """One-slot lookahead onto a device: batch N+1's copy is issued before
    batch N is yielded, so the transfer overlaps the consumer's step.

    ``device=True`` is the current CUDA device; ``"cpu"`` yields CPU
    tensors; a CUDA device on a host without CUDA raises (no fallback).
    Numeric columns become tensors; other columns stay numpy.  On the card
    each numeric column is staged in pinned host memory and copied with
    ``non_blocking=True`` on a side copy stream; an event recorded after
    the batch's copies is waited on by the consumer's current stream when
    the batch is yielded, and each tensor is ``record_stream``-ed on that
    stream, so its memory is not reused while the consumer's queued work
    reads it.  The pinned staging tensors are held until their batch is
    yielded (the caching host allocator also keeps a freed pinned block
    until the copy that read it has ended).  The stats of the last run in
    this process are in ``DataContext.get_current().last_prefetch_stats``.
    """
    import time

    import torch

    from ..device import resolve_device
    from .context import DataContext

    dev = resolve_device(None if device is True else device)
    cuda = dev.type == "cuda"
    stats = {"device": str(dev), "batches": 0, "bytes": 0, "pinned": cuda,
             "copy_stream": None, "consumer_streams": [], "copy_ms": [],
             "wait_s": []}
    DataContext.get_current().last_prefetch_stats = stats
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    if cuda:
        stats["copy_stream"] = copy_stream.stream_id
    timings = []

    def stage(batch: Batch):
        host, out = {}, {}
        for k, v in batch.items():
            dt = _torch_dtype(v.dtype)
            if dt is None:
                out[k] = v
            elif cuda:
                # One host copy, straight into pinned memory.
                buf = torch.empty(v.shape, dtype=dt, pin_memory=True)
                buf.numpy()[...] = v
                host[k] = buf
                stats["pinned"] &= buf.is_pinned()
                stats["bytes"] += buf.nbytes
            else:
                # Blocks from the object store are read-only; a tensor is
                # writable, so it gets its own copy of those.
                out[k] = torch.from_numpy(
                    np.array(v) if not v.flags.writeable
                    else np.ascontiguousarray(v))
                stats["bytes"] += out[k].nbytes
        if not host:
            return out, host, None
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(copy_stream):
            start.record(copy_stream)
            for k, t in host.items():
                out[k] = t.to(dev, non_blocking=True)
            done.record(copy_stream)
        timings.append((start, done))
        return out, host, done

    def ready(staged):
        out, _host, done = staged
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for v in out.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(consumer)
            if consumer.stream_id not in stats["consumer_streams"]:
                stats["consumer_streams"].append(consumer.stream_id)
        stats["batches"] += 1
        return out

    prev = None
    t0 = time.perf_counter()
    for batch in batches:
        cur = stage(batch)
        if prev is not None:
            stats["wait_s"].append(time.perf_counter() - t0)
            yield ready(prev)
            t0 = time.perf_counter()
        prev = cur
    if prev is not None:
        stats["wait_s"].append(time.perf_counter() - t0)
        yield ready(prev)
    for start, done in timings:
        done.synchronize()
        stats["copy_ms"].append(start.elapsed_time(done))


class DataIterator:
    """A shard handle from streaming_split — picklable, usable inside a
    Train worker (reference: data/iterator.py DataIterator handed out by
    streaming_split; session.get_dataset_shard returns one)."""

    def __init__(self, coordinator: Any, split_index: int):
        self._coord = coordinator
        self._split = split_index

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_blocks: int = 2,
        device: Any = None,
    ) -> Iterator[Any]:
        import ray_tpu_torch

        from .context import DataContext

        batch_size = batch_size or DataContext.get_current().default_batch_size
        epoch = ray_tpu_torch.get(self._coord.begin_epoch.remote(self._split))

        def blocks() -> Iterator[Block]:
            pending: List[Any] = []
            pos = 0
            done = False
            while pending or not done:
                # Keep `prefetch_blocks` next_block requests in flight.
                while not done and len(pending) <= prefetch_blocks:
                    pending.append(
                        self._coord.next_block.remote(self._split, epoch, pos)
                    )
                    pos += 1
                ref = ray_tpu_torch.get(pending.pop(0))
                if ref is None:
                    done = True
                    pending.clear()
                    break
                yield ray_tpu_torch.get(ref)

        out = batches_from_blocks(blocks(), batch_size, batch_format, drop_last)
        if device is not None:
            out = device_prefetch(out, device)
        return out

    def iter_rows(self) -> Iterator[Dict]:
        for batch in self.iter_batches(batch_format="numpy"):
            keys = list(batch)
            if not keys:
                continue
            for i in range(len(batch[keys[0]])):
                yield {k: batch[k][i] for k in keys}

    def __repr__(self) -> str:
        return f"DataIterator(split={self._split})"
