"""ObjectRef: a future handle to a task return or put object.

Reference analog: python/ray/includes/object_ref (Cython ObjectRef) — holds
the object id, supports get/wait, decrements the reference count on GC so the
control plane can free the underlying store segment.
"""

from __future__ import annotations

import threading
from typing import Optional

from . import serialization
from .context import ctx
from .ids import ObjectID
from ..devtools.locks import make_lock

# Batched free queue: ObjectRef.__del__ must never block on RPC — and must
# never call into Client methods at all: __del__ can run from cyclic GC
# inside a client critical section, so taking any client lock here can
# self-deadlock.  __del__ only appends and signals; the client's flusher
# thread does the actual work.
_free_lock = make_lock("objectref.free_queue")
_free_queue: list = []
flush_wanted = threading.Event()


def _flush_free_queue(background: bool = False):
    with _free_lock:
        batch, _free_queue[:] = _free_queue[:], []
    if batch and ctx.client is not None:
        try:
            if background:
                # __del__-triggered flushes must not block on a round trip;
                # the pipelined call keeps frees prompt so large freed
                # segments return to the store pool instead of forcing
                # eviction/spill of live objects.
                ctx.client.free_objects_bg(batch)
            else:
                ctx.client.free_objects(batch)
        except Exception:
            pass


class ObjectRef:
    __slots__ = ("_id", "_owned", "__weakref__")

    def __init__(self, object_id: ObjectID, owned: bool = True):
        self._id = object_id
        self._owned = owned

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    @property
    def object_id(self) -> ObjectID:
        return self._id

    def task_id(self):
        return self._id.task_id()

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __del__(self):
        # `ctx` can already be None during interpreter shutdown (module
        # globals cleared before the last refs are collected).
        client = ctx.client if ctx is not None else None
        if self._owned and client is not None:
            raw = self._id.binary()
            with _free_lock:
                _free_queue.append(raw)
            # Wake the client's flusher thread; large objects get a prompt
            # flush (their segments should return to the warm pool fast).
            if len(_free_queue) >= 16 or raw in client.large_oids:
                flush_wanted.set()

    def __reduce__(self):
        # Crossing a process boundary: the receiver holds a borrowed reference.
        # The sender bumps the count so the object outlives the transfer
        # (simplified borrowing vs reference_count.h's full protocol).
        if ctx.client is not None:
            # Direct-call results live only in the sender's local cache
            # until shared: register head-side first so the receiver's
            # get() has a record to seal against.
            ctx.client.ensure_shared(self._id.binary())
            ctx.client.add_reference(self._id.binary())
        return (_reconstruct_ref, (self._id.binary(),))

    # Allow `await ref` inside async actors.
    def __await__(self):
        import asyncio

        loop = asyncio.get_event_loop()
        fut = loop.run_in_executor(None, lambda: ctx.client.get([self])[0])
        return fut.__await__()


def _reconstruct_ref(raw: bytes) -> "ObjectRef":
    return ObjectRef(ObjectID(raw), owned=True)


class _TopLevelRef:
    """Marker for a top-level ObjectRef argument: resolved to its value before
    the task body runs (Ray semantics: top-level refs are awaited+inlined,
    nested refs are passed through as refs)."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        self.raw = raw


class ObjectRefGenerator:
    """Iterator over a streaming task's yielded objects
    (reference: python/ray/_raylet.pyx ObjectRefGenerator /
    core_worker.h:392 TryReadObjectRefStream)."""

    def __init__(self, task_id_bytes: bytes):
        self._task_id = task_id_bytes
        self._index = 0

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        item = ctx.client.next_stream_item(self._task_id, self._index)
        if item.get("done"):
            raise StopIteration
        if item.get("error") is not None:
            raise serialization.unpack(item["error"])
        self._index += 1
        return ObjectRef(ObjectID(item["object_id"]))

    def cancel(self, force: bool = False) -> None:
        """Cancel the producing task (reference: ray.cancel on a streaming
        generator's task).  The worker raises TaskCancelledError inside the
        generator body, which closes it — a token-streaming deployment
        frees its engine state mid-flight this way."""
        ctx.client.cancel_task(self._task_id, force)

    def __reduce__(self):
        return (ObjectRefGenerator, (self._task_id,))
