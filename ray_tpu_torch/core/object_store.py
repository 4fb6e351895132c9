"""Shared-memory object store (plasma equivalent).

Role-equivalent to the reference's plasma store
(reference: src/ray/object_manager/plasma/store.h:55 PlasmaStore +
object_lifecycle_manager.h / eviction_policy.h): immutable sealed objects in
shared memory, zero-copy reads from any process on the node, LRU eviction with
spill-to-disk (reference: src/ray/raylet/local_object_manager.h:41 +
python/ray/_private/external_storage.py FileSystemStorage).

Implementation notes:
- Each object is a file under /dev/shm mapped with mmap — no dependence on
  Python's multiprocessing resource tracker (which unlinks segments that other
  processes still map).  This mirrors plasma's fd-passing model with the unix
  permissions model doing the access control.
- Device memory never lives here: the store holds host bytes (a CUDA
  tensor crosses as a CPU tensor, serialization.py), and moving it onto a
  card is the consumer's `.to(device)`.
"""

from __future__ import annotations

import mmap
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from .ids import ObjectID
from ..devtools.locks import make_lock, make_rlock

_SHM_DIR = "/dev/shm"
_PREFIX = "rtpt"

# -- put-path contention accounting -------------------------------------------
# Stage attribution for the object-store write path (the committed baseline
# the zero-copy redesign must move — ROADMAP item 3): every large put's wall
# splits into serialize / alloc / first_touch / copy, plus the store-lock
# wait on the daemon's accounting lock.  Two sinks per observation: the
# cluster histograms (``ray_tpu_put_copy_seconds`` by stage,
# ``ray_tpu_store_lock_wait_seconds``) for `doctor --object-plane`, and a
# process-local accumulator bench_core/tests read without a cluster.

#: Cold segments below this size skip the pre-touch pass (the fault cost
#: of a few pages is noise; the Python per-page loop is not).
_PRETOUCH_MIN_BYTES = 1024 * 1024
_PAGE = mmap.PAGESIZE or 4096

_stage_lock = make_lock("store.put_stages")
_stage_acc: Dict[str, List[float]] = {}  # stage -> [seconds, bytes, count]
_stage_hist = None
_lock_hist = None

#: put-stage boundaries (seconds): large-put stages run 1ms..1s.
_STAGE_BOUNDS = (0.0005, 0.002, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0)


def note_put_stage(stage: str, seconds: float, nbytes: int = 0) -> None:
    """Attribute ``seconds`` of put wall to one named stage."""
    global _stage_hist
    if _stage_hist is None:
        from ..util.metrics import get_histogram

        _stage_hist = get_histogram(
            "ray_tpu_put_copy_seconds",
            "Object put wall time split by stage (serialize / alloc / "
            "first_touch / copy)", boundaries=_STAGE_BOUNDS,
            tag_keys=("stage",))
    _stage_hist.observe(seconds, {"stage": stage})
    with _stage_lock:
        acc = _stage_acc.get(stage)
        if acc is None:
            acc = _stage_acc[stage] = [0.0, 0.0, 0.0]
        acc[0] += seconds
        acc[1] += nbytes
        acc[2] += 1


def note_lock_wait(seconds: float) -> None:
    """Record one store-lock acquisition wait (daemon accounting lock)."""
    global _lock_hist
    if _lock_hist is None:
        from ..util.metrics import get_histogram

        _lock_hist = get_histogram(
            "ray_tpu_store_lock_wait_seconds",
            "Wait to acquire the object store's accounting lock",
            boundaries=(0.0001, 0.001, 0.005, 0.025, 0.1, 0.5, 1.0))
    _lock_hist.observe(seconds)
    with _stage_lock:
        acc = _stage_acc.get("lock_wait")
        if acc is None:
            acc = _stage_acc["lock_wait"] = [0.0, 0.0, 0.0]
        acc[0] += seconds
        acc[2] += 1


def put_stage_snapshot() -> Dict[str, dict]:
    """Process-local stage totals since start/reset (for bench + doctor)."""
    with _stage_lock:
        return {stage: {"seconds": acc[0], "bytes": int(acc[1]),
                        "count": int(acc[2])}
                for stage, acc in _stage_acc.items()}


def reset_put_stages() -> None:
    with _stage_lock:
        _stage_acc.clear()


def _pretouch(mm_buf, size: int) -> None:
    """Fault every page of a cold segment once (one byte store per page)
    so the copy that follows runs against warm pages — the fault cost
    becomes a measured ``first_touch`` stage instead of hiding inside the
    memcpy number.  Freshly created tmpfs segments read as zeros, and the
    stores write zeros, so content is unchanged."""
    for off in range(0, size, _PAGE):
        mm_buf[off] = 0


def _seg_path(session: str, object_id: ObjectID) -> str:
    return os.path.join(_SHM_DIR, f"{_PREFIX}-{session}-{object_id.hex()}")


def _pool_dir(session: str) -> str:
    return os.path.join(_SHM_DIR, f"{_PREFIX}-pool-{session}")


def _claim_pooled(session: str, path: str, size: int) -> Optional["_Segment"]:
    """Claim a warm segment from the session's free pool via atomic rename.

    tmpfs pages are expensive on first touch (allocate+zero page faults cap a
    cold 256 MiB write at well under 1 GiB/s on this class of machine) but
    nearly free on reuse, so freed segments are renamed into a pool instead
    of unlinked and new objects claim one of comparable size — the same
    reason the reference's plasma store allocates from a long-lived dlmalloc
    arena rather than mmap-per-object (reference:
    src/ray/object_manager/plasma/dlmalloc.cc)."""
    pool = _pool_dir(session)
    try:
        entries = os.listdir(pool)
    except FileNotFoundError:
        return None
    best = None
    best_delta = None
    for name in entries:
        try:
            fsize = int(name.split("-", 1)[0])
        except ValueError:
            continue
        # A smaller file still donates its warm prefix; a vastly larger one
        # wastes pooled bytes on ftruncate-down.  Prefer the closest size
        # within [size/2, 4*size].
        if fsize < size // 2 or fsize > 4 * size:
            continue
        delta = abs(fsize - size)
        if best_delta is None or delta < best_delta:
            best, best_delta = name, delta
    if best is None:
        return None
    try:
        os.rename(os.path.join(pool, best), path)
    except FileNotFoundError:
        return None  # lost the race to another writer
    try:
        seg = _Segment(path, size, create=False, exact_size=size)
    except OSError:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        return None
    return seg


class _Segment:
    """A mapped shared-memory segment holding one sealed object."""

    __slots__ = ("path", "size", "mm", "fd")

    def __init__(self, path: str, size: int, create: bool,
                 exact_size: Optional[int] = None):
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        self.fd = os.open(path, flags, 0o600)
        try:
            if create:
                os.ftruncate(self.fd, size)
            elif exact_size is not None:
                # Claimed from the warm pool: resize to the object's size
                # (shrinking keeps the warm prefix, growing adds cold tail).
                if os.fstat(self.fd).st_size != exact_size:
                    os.ftruncate(self.fd, exact_size)
                size = exact_size
            else:
                size = os.fstat(self.fd).st_size
            self.size = size
            self.mm = mmap.mmap(self.fd, size)
            self.path = path
        except Exception:
            os.close(self.fd)
            raise

    def view(self) -> memoryview:
        return memoryview(self.mm)

    def close(self) -> bool:
        """Returns True if the mapping was fully released; False when
        outstanding zero-copy views keep it alive (the caller must then treat
        the inode as still-read and never reuse it)."""
        clean = True
        try:
            self.mm.close()
        except (BufferError, ValueError):
            clean = False  # outstanding zero-copy views keep the map alive
        os.close(self.fd)
        return clean


class ObjectStore:
    """Node-scoped shared-memory object store with LRU eviction + spilling.

    One instance runs inside the node daemon (the accounting owner); worker
    and driver processes use :class:`StoreClient` views that attach segments
    read-only by name.
    """

    def __init__(self, session: str, capacity_bytes: int, spill_dir: str):
        self._session = session
        self._capacity = capacity_bytes
        self._spill_dir = os.path.join(spill_dir, session)
        os.makedirs(self._spill_dir, exist_ok=True)
        self._pool_dir = _pool_dir(session)
        os.makedirs(self._pool_dir, exist_ok=True)
        # Freed segments up to this many bytes stay pooled (pages warm) for
        # reuse by the next writer; beyond it they are unlinked.
        self._pool_cap = min(capacity_bytes // 2, 4 * 1024**3)
        self._lock = make_rlock("store.daemon")
        # Sealed objects in shm, LRU order (oldest first).
        self._objects: "OrderedDict[ObjectID, _Segment]" = OrderedDict()
        self._spilled: Dict[ObjectID, str] = {}
        self._pinned: Dict[ObjectID, int] = {}
        # Freed segments pass through here before entering the claimable
        # pool.  The owner's free is already gated on detach-acks from every
        # process that could hold a view (head._deferred_free), so no delay
        # is needed; the list only decouples pool bookkeeping from free().
        self._cooling: List[tuple] = []
        self._cooling_s = 0.0
        self._used = 0
        self.num_evictions = 0
        # Telemetry counters (cumulative; surfaced via stats() and the
        # head's ray_tpu_object_store_* built-in metrics).
        self.bytes_stored_total = 0
        self.bytes_transferred_total = 0
        self.gets_hit = 0
        self.gets_miss = 0

    # -- write path -----------------------------------------------------------

    def create(self, object_id: ObjectID, size: int) -> memoryview:
        """Allocate a segment for an object; caller writes then calls seal()."""
        self.tick()
        _t_lk = time.perf_counter()
        with self._lock:
            note_lock_wait(time.perf_counter() - _t_lk)
            if object_id in self._objects:
                raise KeyError(f"object {object_id} already exists")
            self._ensure_capacity(size)
            path = _seg_path(self._session, object_id)
            _t0 = time.perf_counter()
            seg = _claim_pooled(self._session, path, size)
            if seg is None:
                seg = _Segment(path, size, create=True)
                note_put_stage("alloc", time.perf_counter() - _t0, size)
                if size >= _PRETOUCH_MIN_BYTES:
                    _t1 = time.perf_counter()
                    _pretouch(seg.mm, size)
                    note_put_stage("first_touch",
                                   time.perf_counter() - _t1, size)
            else:
                note_put_stage("alloc", time.perf_counter() - _t0, size)
            self._objects[object_id] = seg
            self._used += size
            self.bytes_stored_total += size
            return seg.view()

    def seal(self, object_id: ObjectID) -> int:
        with self._lock:
            return self._objects[object_id].size

    def put_blob(self, object_id: ObjectID, blob: bytes) -> int:
        buf = self.create(object_id, len(blob))
        buf[:] = blob
        return self.seal(object_id)

    def adopt(self, object_id: ObjectID) -> int:
        """Take ownership (accounting + eviction) of a segment that a worker
        process created directly via StoreClient.create."""
        with self._lock:
            if object_id in self._objects:
                return self._objects[object_id].size
            seg = _Segment(_seg_path(self._session, object_id), 0, create=False)
            self._ensure_capacity(seg.size)
            self._objects[object_id] = seg
            self._used += seg.size
            self.bytes_stored_total += seg.size
            return seg.size

    # -- read path ------------------------------------------------------------

    def get(self, object_id: ObjectID) -> Optional[memoryview]:
        _t_lk = time.perf_counter()
        with self._lock:
            note_lock_wait(time.perf_counter() - _t_lk)
            seg = self._objects.get(object_id)
            if seg is not None:
                self._objects.move_to_end(object_id)  # LRU touch
                self.gets_hit += 1
                return seg.view()
            self.gets_miss += 1
            if object_id in self._spilled:
                return self._restore(object_id)
            return None

    def manifest(self) -> list:
        """(object_id, size) of every object this store can still serve —
        sealed shm segments plus spilled entries (restorable on access).
        The field-state report a node carries when it re-registers with a
        restarted head: the head rebuilds its volatile object directory
        from these (reference: GCS FT — raylets replay their object
        tables to a restarted GCS)."""
        out = []
        with self._lock:
            for oid, seg in self._objects.items():
                out.append((oid, seg.size))
            for oid, path in self._spilled.items():
                if oid in self._objects:
                    continue
                try:
                    out.append((oid, os.path.getsize(path)))
                except OSError:
                    pass  # spill file gone: nothing to report
        return out

    def count_transferred(self, nbytes: int) -> None:
        """Account bytes served to a cross-node pull (called by the pull
        handlers in node_main)."""
        with self._lock:
            self.bytes_transferred_total += nbytes

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects or object_id in self._spilled

    def pin(self, object_id: ObjectID):
        with self._lock:
            self._pinned[object_id] = self._pinned.get(object_id, 0) + 1

    def unpin(self, object_id: ObjectID):
        with self._lock:
            n = self._pinned.get(object_id, 0) - 1
            if n <= 0:
                self._pinned.pop(object_id, None)
            else:
                self._pinned[object_id] = n

    # -- lifecycle ------------------------------------------------------------

    def _pool_or_unlink(self, seg: _Segment):
        """Retire a freed segment: rename into the warm pool (keeping its
        pages for the next writer) while pooled bytes stay under the cap,
        else unlink.  Pooled bytes are recounted from the size-prefixed file
        names — writers consume pool entries without telling us."""
        pooled = 0
        try:
            for name in os.listdir(self._pool_dir):
                try:
                    pooled += int(name.split("-", 1)[0])
                except ValueError:
                    pass
        except FileNotFoundError:
            os.makedirs(self._pool_dir, exist_ok=True)
        if seg.size == 0 or pooled + seg.size > self._pool_cap:
            try:
                os.unlink(seg.path)
            except FileNotFoundError:
                pass
            return
        dst = os.path.join(
            self._pool_dir, f"{seg.size}-{os.urandom(4).hex()}"
        )
        try:
            os.rename(seg.path, dst)
        except FileNotFoundError:
            pass

    def tick(self):
        """Move cooled freed segments into the claimable pool.  Called from
        the owner's housekeeping loop and opportunistically from create()."""
        now = time.monotonic()
        with self._lock:
            while self._cooling and now - self._cooling[0][0] >= self._cooling_s:
                _, seg = self._cooling.pop(0)
                self._pool_or_unlink(seg)

    def free(self, object_id: ObjectID, pool: bool = True):
        """Release an object.  ``pool=False`` forces unlink (callers pass it
        when some process still holds zero-copy views of the segment — the
        orphaned inode then stays stable for those views, the pre-pool
        semantics; pooling would rewrite bytes under them)."""
        with self._lock:
            seg = self._objects.pop(object_id, None)
            if seg is not None:
                self._used -= seg.size
                if not seg.close():
                    pool = False  # our own mapping still has live views
                if object_id in self._pinned:
                    # An in-flight bulk transfer holds an fd (sendfile):
                    # unlink keeps the inode alive for that fd, pooling
                    # would let a new writer overwrite it mid-stream.
                    pool = False
                if pool:
                    self._cooling.append((time.monotonic(), seg))
                else:
                    try:
                        os.unlink(seg.path)
                    except FileNotFoundError:
                        pass
            spath = self._spilled.pop(object_id, None)
            if spath is not None:
                try:
                    os.unlink(spath)
                except FileNotFoundError:
                    pass
            self._pinned.pop(object_id, None)
        self.tick()

    def shutdown(self):
        with self._lock:
            for oid in list(self._objects):
                self.free(oid)
            for _, seg in self._cooling:
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
            self._cooling.clear()
            try:
                for name in os.listdir(self._pool_dir):
                    try:
                        os.unlink(os.path.join(self._pool_dir, name))
                    except FileNotFoundError:
                        pass
                os.rmdir(self._pool_dir)
            except OSError:
                pass

    # -- eviction / spilling --------------------------------------------------

    def _ensure_capacity(self, size: int):
        if size > self._capacity:
            raise MemoryError(
                f"object of {size} bytes exceeds store capacity {self._capacity}"
            )
        while self._used + size > self._capacity:
            victim = next(
                (oid for oid in self._objects if oid not in self._pinned), None
            )
            if victim is None:
                raise MemoryError(
                    f"object store full ({self._used} bytes, all pinned)"
                )
            self._spill(victim)

    def _spill(self, object_id: ObjectID):
        seg = self._objects.pop(object_id)
        path = os.path.join(self._spill_dir, object_id.hex())
        with open(path, "wb") as f:
            f.write(seg.view())
        self._spilled[object_id] = path
        self._used -= seg.size
        self.num_evictions += 1
        seg.close()
        try:
            os.unlink(seg.path)
        except FileNotFoundError:
            pass

    def _restore(self, object_id: ObjectID) -> memoryview:
        path = self._spilled.pop(object_id)
        with open(path, "rb") as f:
            blob = f.read()
        os.unlink(path)
        self._ensure_capacity(len(blob))
        seg = _Segment(_seg_path(self._session, object_id), len(blob), create=True)
        seg.view()[:] = blob
        self._objects[object_id] = seg
        self._used += len(blob)
        return seg.view()

    # -- stats ----------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "used_bytes": self._used,
                "capacity_bytes": self._capacity,
                "num_objects": len(self._objects),
                "num_spilled": len(self._spilled),
                "num_evictions": self.num_evictions,
                "bytes_stored_total": self.bytes_stored_total,
                "bytes_transferred_total": self.bytes_transferred_total,
                "gets_hit": self.gets_hit,
                "gets_miss": self.gets_miss,
            }


class StoreClient:
    """Read/write view of the node's store for worker & driver processes.

    Writers create segments directly (the daemon learns sizes via object
    registration in the control plane); readers attach by name.  Attached
    segments are cached so repeated gets are free.
    """

    def __init__(self, session: str):
        self._session = session
        self._attached: Dict[ObjectID, _Segment] = {}
        self._lock = make_lock("store.client_attach")

    def create(self, object_id: ObjectID, size: int,
               wait_pool_s: float = 0.0) -> memoryview:
        """Allocate a writable segment.  ``wait_pool_s`` bounds a brief wait
        for a warm pooled segment to appear — used when the caller knows
        frees are in flight (steady-state producers: reusing warm pages
        beats cold first-touch faults by ~10x under memory pressure)."""
        path = _seg_path(self._session, object_id)
        deadline = time.monotonic() + wait_pool_s
        _t0 = time.perf_counter()
        while True:
            seg = _claim_pooled(self._session, path, size)
            if seg is not None or time.monotonic() >= deadline:
                break
            time.sleep(0.003)
        if seg is None:
            seg = _Segment(path, size, create=True)
            note_put_stage("alloc", time.perf_counter() - _t0, size)
            if size >= _PRETOUCH_MIN_BYTES:
                _t1 = time.perf_counter()
                _pretouch(seg.mm, size)
                note_put_stage("first_touch", time.perf_counter() - _t1, size)
        else:
            # Pool claim (incl. any bounded wait for a warm segment): the
            # pages arrive warm, there is no first-touch stage to pay.
            note_put_stage("alloc", time.perf_counter() - _t0, size)
        with self._lock:
            self._attached[object_id] = seg
        return seg.view()

    def create_staged(self, object_id: ObjectID, size: int):
        """Create a segment at a temporary name; committing renames it to the
        object's canonical path atomically.  Used for inter-node pulls where
        several processes may fetch the same object concurrently — readers
        must never attach a partially-written segment (reference: plasma
        objects are invisible until sealed)."""
        final = _seg_path(self._session, object_id)
        tmp = f"{final}.pull-{os.getpid()}-{os.urandom(4).hex()}"
        seg = _claim_pooled(self._session, tmp, size)
        if seg is None:
            seg = _Segment(tmp, size, create=True)

        def commit() -> memoryview:
            os.rename(tmp, final)
            seg.path = final
            with self._lock:
                self._attached[object_id] = seg
            return seg.view()

        def abort():
            seg.close()
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass

        return seg.view(), commit, abort

    def get(self, object_id: ObjectID, timeout: float = 0.0) -> Optional[memoryview]:
        with self._lock:
            seg = self._attached.get(object_id)
            if seg is not None:
                return seg.view()
        deadline = time.monotonic() + timeout
        path = _seg_path(self._session, object_id)
        while True:
            try:
                seg = _Segment(path, 0, create=False)
                break
            except FileNotFoundError:
                if time.monotonic() >= deadline:
                    return None
                time.sleep(0.001)
        with self._lock:
            self._attached[object_id] = seg
        return seg.view()

    def detach(self, object_id: ObjectID) -> bool:
        """Unmap a segment.  Returns False when live zero-copy views (user
        code holding arrays aliasing the mmap) prevented the unmap — the
        store owner must then not recycle the inode."""
        with self._lock:
            seg = self._attached.pop(object_id, None)
        if seg is not None:
            return seg.close()
        return True

    def close(self):
        with self._lock:
            for seg in self._attached.values():
                seg.close()
            self._attached.clear()
