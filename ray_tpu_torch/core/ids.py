"""Unique identifiers for jobs, tasks, actors, objects, nodes, and placement groups.

Capability parity with the reference ID scheme (reference: src/ray/common/id.h) but
simplified for a Python-first control plane: every ID is a fixed-length random (or
derived) byte string with a hex representation.  Object IDs embed the creating task's
ID plus a return-index so lineage (which task produced this object) is recoverable
without a side table — the property the reference gets from its TaskID-embedded
ObjectIDs (src/ray/common/id.h ObjectID::FromIndex).
"""

from __future__ import annotations

import os
import threading

from ..devtools.locks import make_lock

_ID_LEN = 16  # bytes of entropy per ID
_OBJECT_INDEX_LEN = 4  # trailing bytes of an ObjectID encode the return index

# os.urandom is a syscall per call — on virtualised kernels it costs close to
# a millisecond, and ID generation sits on the task-submission hot path
# (one TaskID + one ObjectID per call).  A process-local PRNG seeded ONCE
# from os.urandom keeps the entropy while making subsequent IDs pure
# userspace.  Fork safety: a forked child (zygote workers) inheriting the
# parent's PRNG stream would mint colliding IDs, so the stream resets in
# the child via the at-fork hook (os.getpid() per ID would be another
# syscall on the hot path).
_rng = None
_rng_lock = threading.Lock()


def _reset_rng():
    global _rng
    _rng = None


os.register_at_fork(after_in_child=_reset_rng)


def _rand_bytes(n: int) -> bytes:
    global _rng
    rng = _rng
    if rng is None:
        import random
        import time as _time

        with _rng_lock:
            if _rng is None:
                _rng = random.Random(
                    os.urandom(16)
                    + os.getpid().to_bytes(8, "little", signed=False)
                    + _time.time_ns().to_bytes(16, "little", signed=False)
                )
            rng = _rng
    with _rng_lock:
        return rng.getrandbits(8 * n).to_bytes(n, "little")


class BaseID:
    """Immutable, hashable identifier backed by raw bytes."""

    __slots__ = ("_bytes", "_hash")
    _prefix = "id"

    def __init__(self, raw: bytes):
        if not isinstance(raw, bytes) or len(raw) != self.byte_len():
            raise ValueError(
                f"{type(self).__name__} requires {self.byte_len()} bytes, "
                f"got {raw!r}"
            )
        self._bytes = raw
        self._hash = hash((type(self).__name__, raw))

    @classmethod
    def byte_len(cls) -> int:
        return _ID_LEN

    @classmethod
    def from_random(cls):
        return cls(_rand_bytes(cls.byte_len()))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.byte_len())

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.byte_len()

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    _prefix = "job"


class NodeID(BaseID):
    _prefix = "node"


class WorkerID(BaseID):
    _prefix = "worker"


class ActorID(BaseID):
    _prefix = "actor"


class PlacementGroupID(BaseID):
    _prefix = "pg"


class TaskID(BaseID):
    _prefix = "task"


class ObjectID(BaseID):
    """Object IDs are derived from (task id, return index) so the producing task is
    always recoverable: bytes = task_id || uint32(index)."""

    _prefix = "obj"

    @classmethod
    def byte_len(cls) -> int:
        return _ID_LEN + _OBJECT_INDEX_LEN

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(_OBJECT_INDEX_LEN, "little"))

    @classmethod
    def from_random(cls):
        # Driver `put()` objects get a synthetic task id of all-random bytes.
        return cls(_rand_bytes(cls.byte_len()))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_ID_LEN])

    def return_index(self) -> int:
        return int.from_bytes(self._bytes[_ID_LEN:], "little")


class _Counter:
    """Process-local monotonically increasing counter (thread-safe)."""

    def __init__(self):
        self._value = 0
        self._lock = make_lock("ids.counter")

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value


unique_counter = _Counter()
