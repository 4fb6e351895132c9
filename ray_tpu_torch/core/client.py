"""Client: a process's connection to the control plane + object store.

Role-equivalent to the reference CoreWorker's client surface
(reference: src/ray/core_worker/core_worker.h:295 — Put/Get/Wait/SubmitTask/
CreateActor/SubmitActorTask) minus task execution, which lives in
worker_main.py.  One Client per process (driver or worker).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from .. import exceptions
from . import serialization
from .config import get_config
from .ids import NodeID, ObjectID
from . import object_store
from .object_store import StoreClient
from .rpc import ConnectionLost, RpcClient
from ..devtools.locks import guarded, make_lock

# Head RPCs that are safe to retry on a transient connection hiccup: pure
# reads (no head-side state mutation), so a duplicate delivery is harmless
# (reference: GCS clients retry idempotent RPCs with backoff —
# gcs_rpc_client.h RETRYABLE macros cover the read paths).
IDEMPOTENT_METHODS = frozenset({
    "list_state", "kv_get", "kv_keys", "cluster_resources",
    "available_resources", "store_stats", "object_sizes", "ping",
    "get_actor_by_name", "list_named_actors", "health_ack", "get_log",
    "resolve_actor",
    # Blocking reads: safe to re-issue after a head restart — the restarted
    # head re-learns objects from field-state resync and the re-issued wait
    # blocks until the reseal, giving head-routed gets a bounded pause
    # instead of a hard failure across the restart window.
    "get_objects", "wait_objects",
})
#: Back-compat aliases: the retry shape now lives in config
#: (``rpc_retry_attempts`` / ``rpc_retry_base_s``) and the curve in
#: core/deadline.py — these mirror the defaults for external readers.
IDEMPOTENT_RETRY_ATTEMPTS = 3
IDEMPOTENT_RETRY_BASE_S = 0.05


@guarded
class Client:
    # rtlint RT007 verifies these statically; RT_DEBUG_LOCKS=2 asserts the
    # guards at runtime (devtools.locks).  large_oids/_last_large_free ride
    # _local_lock: they are updated on the same put/free paths that touch
    # the in-process store.
    _RT_GUARDED_BY = {
        "_local_bytes": "_local_lock",
        "large_oids": "_local_lock",
        "_last_large_free": "_local_lock",
        "_bg_exc": "_bg_lock",
        "_put_batch": "_put_batch_lock",
        "_submit_batch": "_submit_batch_lock",
        "_stores": "_stores_lock",
    }
    _RT_UNGUARDED = {
        "rpc": "reconnect swaps in a fresh RpcClient with one reference "
               "store; racing readers use the dying client once more and "
               "retry through call()'s idempotent-retry path",
        "reconnect_refused": "monotonic None->reason publication from the "
                             "reconnect path (under _reconnect_lock); the "
                             "worker's reconnect thread polls it and a "
                             "stale None read just retries once more",
        "trace_sample_rate": "head-config publication at (re)register "
                             "(init, then under _reconnect_lock); tracing "
                             "readers tolerate a stale value for one "
                             "sampling decision",
    }

    def __init__(
        self,
        head_addr: str,
        kind: str,
        worker_id: Optional[bytes] = None,
        node_id: Optional[bytes] = None,
        pid: int = 0,
        session: Optional[str] = None,
        log_path: Optional[str] = None,
        peer_addr: Optional[str] = None,
    ):
        from . import schema as wire_schema

        self.head_addr = head_addr
        host, port = head_addr.rsplit(":", 1)
        self.rpc = RpcClient(host, int(port), name=f"{kind}-rpc")
        # Re-registration identity for head-restart reconnects: the SAME
        # worker identity must be adopted by the restarted head (field-state
        # resync), so the original register body's fields are retained.
        self._reg_info: Dict[str, Any] = {
            "kind": kind, "pid": pid, "worker_id": worker_id,
            "node_id": node_id, "log_path": log_path, "peer_addr": peer_addr,
        }
        # Populated by the owner process (worker_main) with a callable
        # returning the live field state (hosted actor + incarnation) to
        # carry on a reconnect register; None for drivers.
        self.resync_payload = None
        # Reconnect outcome channel for the owner's reconnect loop: set to a
        # reason string when the head explicitly refused to adopt this
        # process (stale incarnation, dead actor) — retrying is pointless
        # and the process should exit.
        self.reconnect_refused: Optional[str] = None
        # Post-reconnect hook (owner-installed): replay buffered reports,
        # re-arm process-level state.  Runs after the swap, outside locks.
        self.on_reconnected = None
        body: Dict[str, Any] = {
            "kind": kind, "pid": pid,
            "protocol": wire_schema.PROTOCOL_VERSION,
        }
        if peer_addr:
            # Worker-plane endpoint: the head hands this address to peers
            # for direct actor calls and task leases.
            body["peer_addr"] = peer_addr
        if log_path:
            # Registered in the head's cluster log index (retained past
            # process death) so `get_log` can serve this process's output.
            body["log_path"] = log_path
        if kind == "driver" and os.environ.get("RT_FORCE_PROXY_DRIVER") == "1":
            # Opt into the off-host proxy path explicitly (tests; also
            # useful when the driver host has no usable /dev/shm).
            body["force_proxy"] = True
        if worker_id is not None:
            body["worker_id"] = worker_id
        if node_id is not None:
            body["node_id"] = node_id
        reply = self.rpc.call("register", body)
        # Writes go under this process's *node* store session (worker
        # processes on non-head nodes pass it in); the head session is the
        # default for drivers/head-node processes.
        self.session: str = session or reply["session"]
        self.node_id: Optional[NodeID] = (
            NodeID(node_id) if node_id else
            (NodeID(reply["node_id"]) if reply.get("node_id") else None)
        )
        # Proxy mode (off-host driver, the Ray Client role): no local shm
        # attach — puts upload to the head, gets pull over TCP.  Pulled
        # copies land in a private local session namespace so a same-host
        # proxy (tests, RT_FORCE_PROXY_DRIVER) never clobbers the cluster
        # session's segments.
        self.proxy: bool = bool(reply.get("proxy"))
        if self.proxy:
            self.session = f"{self.session}-proxy{os.getpid()}"
        # Head-configured root-trace sampling rate (util/tracing.py reads
        # it at every trace root): one knob on the head governs the whole
        # cluster.  None -> fall back to this process's local config.
        self.trace_sample_rate = reply.get("trace_sample_rate")
        self.kind = kind
        # Per-session store clients: created lazily from whatever thread
        # first touches a session (user threads, push handlers on the rpc
        # loop, the free flusher).
        self._stores: Dict[str, StoreClient] = {}
        self._stores_lock = make_lock("client.stores")
        # In-process store for small objects this process owns or has read
        # (packed blobs, LRU-bounded).  The analog of the reference's
        # CoreWorkerMemoryStore (src/ray/core_worker/store_provider/
        # memory_store/memory_store.h:43): puts and repeated gets of small
        # objects never pay a control-plane round trip.
        self._local: "OrderedDict[ObjectID, bytes]" = OrderedDict()
        self._local_bytes = 0
        self._local_cap = get_config().local_store_max_bytes
        self._local_lock = make_lock("client.local_store")
        # In-flight fire-and-forget RPCs (registrations, submissions): a
        # bounded pipeline so submission throughput isn't gated on one
        # round trip per call (reference: task submission is async; errors
        # surface on the returned ref).
        self._bg_futs: deque = deque()
        self._bg_lock = make_lock("client.bg_pipeline")
        self._bg_exc: Optional[BaseException] = None
        # Buffered inline-object registrations (flushed as one RPC before
        # any other outbound call — see _flush_put_batch).
        self._put_batch: List[dict] = []
        self._put_batch_lock = make_lock("client.put_batch")
        # Buffered fire-and-forget calls (see call_batched).
        self._submit_batch: List[dict] = []
        self._submit_batch_lock = make_lock("client.submit_batch")
        # Function-table keys this process has already exported (api._export).
        self.exported_keys: set = set()
        # Large (shm) objects this process put, raw id -> size: their frees
        # flush immediately instead of batching (so multi-MiB segments return
        # to the store's warm pool promptly), and a driver reconnecting to a
        # RESTARTED head re-registers them from this map so the rebuilt
        # object directory can answer for its puts.
        self.large_oids: Dict[bytes, int] = {}
        self._last_large_free = 0.0
        self._sub_handlers: Dict[str, List[Callable]] = {}
        self._sub_lock = make_lock("client.pubsub")
        # Connections to other nodes' object-plane (pull) servers.
        self._pull_conns: Dict[str, RpcClient] = {}
        self._bulk_conns: Dict[str, tuple] = {}
        self._pull_lock = make_lock("client.pull_conns")
        self.rpc.on_push("pubsub", self._on_pubsub)
        self.rpc.on_push("object_free", self._on_object_free)
        # Peer dataplane: direct actor calls + leased task slots (proxy
        # drivers excluded — no peer reachability guarantees off-host).
        self._dataplane = None
        cfg = get_config()
        if not self.proxy and kind in ("driver", "worker") \
                and (cfg.direct_calls or cfg.task_leases):
            from .dataplane import Dataplane

            self._dataplane = Dataplane(self)
        # Free-queue flusher: ObjectRef.__del__ only appends + signals (it
        # may run from cyclic GC inside a client critical section, so it
        # must never take client locks itself); this thread does the RPCs.
        self._reconnect_lock = make_lock("client.reconnect")
        self._free_flusher = threading.Thread(
            target=self._free_flush_loop, daemon=True, name="free-flusher"
        )
        self._free_flusher.start()

    def _free_flush_loop(self):
        from . import object_ref as oref
        from .context import ctx

        while not self.rpc.closed:
            oref.flush_wanted.wait(timeout=0.5)
            oref.flush_wanted.clear()
            if self.rpc.closed:
                return
            if ctx.client is not None and ctx.client is not self:
                return  # superseded by a newer session's client
            try:
                oref._flush_free_queue(background=True)
                # Span plane: drain the process-local span ring into one
                # batched span_batch entry — the existing background-report
                # cadence IS the span flush cadence (and while headless the
                # batch buffers for replay like task_done reports).
                from ray_tpu_torch.util import gangrec as _gangrec
                from ray_tpu_torch.util import steprec as _steprec
                from ray_tpu_torch.util import tracing as _tracing

                _tracing.flush_spans(self)
                # Flight-recorder plane: engine step records and gang round
                # records batch-flush on the same cadence (and dump their
                # black-box sidecars so a SIGKILL still leaves the last N
                # steps/rounds on disk).
                _steprec.flush_steps(self)
                _gangrec.flush_rounds(self)
                # Safety net: batched calls must not sit forever in a driver
                # that stops making client calls (e.g. waits on side effects).
                self._flush_submit_batch()
                self._flush_put_batch()
                if self._dataplane is not None:
                    # Lease renew/idle-return, stale-queue flush, retired
                    # connection teardown.
                    self._dataplane.maintain()
            except Exception:
                pass

    # -- stores ----------------------------------------------------------------

    def store(self, session: Optional[str] = None) -> StoreClient:
        session = session or self.session
        with self._stores_lock:
            st = self._stores.get(session)
            if st is None:
                st = self._stores[session] = StoreClient(session)
            return st

    def _stores_snapshot(self) -> List[StoreClient]:
        with self._stores_lock:
            return list(self._stores.values())

    def _on_object_free(self, body):
        dirty: List[bytes] = []
        if self._dataplane is not None:
            self._dataplane.drop_results(list(body.get("object_ids", [])))
        for raw in body.get("object_ids", []):
            oid = ObjectID(raw)
            self._local_drop(oid)
            clean = True
            for st in self._stores_snapshot():
                had = oid in st._attached
                if not st.detach(oid):
                    clean = False
                elif had and self.proxy:
                    # Proxy-pulled copies live in this process's private
                    # session namespace: no node daemon owns the file, so
                    # unlink it here or the driver host's shm grows without
                    # bound.
                    from .object_store import _seg_path

                    try:
                        os.unlink(_seg_path(st._session, oid))
                    except OSError:
                        pass
            if not clean:
                dirty.append(raw)
        token = body.get("ack_token")
        if token is not None:
            # Runs on the rpc loop thread: fire-and-forget (a blocking call
            # here would deadlock the loop).  The head pools the segments
            # only after this ack; dirty ids (live zero-copy views in this
            # process) are unlinked instead so the views stay valid.
            try:
                self.rpc.call_async(
                    "object_free_ack", {"token": token, "dirty": dirty}
                )
            except Exception:
                pass

    # -- in-process store / background pipeline --------------------------------

    def _local_put(self, oid: ObjectID, blob: bytes):
        with self._local_lock:
            prev = self._local.pop(oid, None)
            if prev is not None:
                self._local_bytes -= len(prev)
            self._local[oid] = blob
            self._local_bytes += len(blob)
            while self._local_bytes > self._local_cap and self._local:
                _, victim = self._local.popitem(last=False)
                self._local_bytes -= len(victim)

    def _local_get(self, oid: ObjectID) -> Optional[bytes]:
        with self._local_lock:
            blob = self._local.get(oid)
            if blob is not None:
                self._local.move_to_end(oid)
            return blob

    def _local_drop(self, oid: ObjectID):
        with self._local_lock:
            blob = self._local.pop(oid, None)
            if blob is not None:
                self._local_bytes -= len(blob)

    def call_bg(self, method: str, body: Any):
        """Fire an RPC without waiting for the reply.  Ordering vs later
        calls on this client is preserved (single connection, FIFO).  Errors
        surface on the next synchronous call; a bounded in-flight window
        applies backpressure when the head falls behind."""
        self._flush_put_batch()
        self._flush_submit_batch()
        self._call_bg_raw(method, body)

    def _call_bg_raw(self, method: str, body: Any):
        # Reap/wait OUTSIDE the lock: the backpressure wait can block up
        # to 60s, and check_bg (every sync call) takes _bg_lock — holding
        # it here would stall the whole client behind one backlogged RPC.
        done_futs: List[Any] = []
        wait_fut = None
        with self._bg_lock:
            while self._bg_futs and self._bg_futs[0].done():
                done_futs.append(self._bg_futs.popleft())
            if len(self._bg_futs) >= 1000:
                wait_fut = self._bg_futs.popleft()
        for fut in done_futs:
            self._note_bg_exc(fut)
        if wait_fut is not None:
            self._note_bg_exc(wait_fut, wait=True)
        with self._bg_lock:
            self._bg_futs.append(self.rpc.call_async(method, body))

    def _flush_put_batch(self):
        """Send buffered inline-object registrations as one RPC.  Flushed
        before ANY other outbound call so no message that could reference a
        buffered object ever overtakes its registration.  While headless
        (lost head connection, reconnect pending) the batch stays buffered:
        registrations queue and replay after re-register instead of being
        dropped into a dead socket."""
        with self._put_batch_lock:
            if self.rpc.closed:
                return
            batch, self._put_batch = self._put_batch, []
        if batch:
            self._call_bg_raw("put_object_batch", {"objects": batch})

    def call_batched(self, method: str, body: dict):
        """Buffer a fire-and-forget call; bursts flush as ONE head RPC
        (head message processing, not wire latency, bounds control-plane
        throughput).  Order within the mixed batch is preserved, and every
        sync/bg call flushes it first, so batching never reorders."""
        self._flush_put_batch()  # registrations precede referencing bodies
        with self._submit_batch_lock:
            self._submit_batch.append({"method": method, "body": body})
            n = len(self._submit_batch)
        if n >= 64:
            self._flush_submit_batch()

    def _flush_submit_batch(self):
        with self._submit_batch_lock:
            # Headless: hold the batch (task_done reports, submissions) for
            # replay after reconnect — a worker finishing tasks during a
            # head restart must not lose its completion reports.
            if self.rpc.closed:
                return
            batch, self._submit_batch = self._submit_batch, []
        if batch:
            self._call_bg_raw("batch", {"entries": batch})

    def _note_bg_exc(self, fut, wait: bool = False):
        """Record a background failure.  Never called with _bg_lock held —
        the wait=True path blocks on the head for up to 60s."""
        try:
            if wait:
                fut.result(timeout=60)
                exc = None
            else:
                exc = fut.exception()
        except BaseException as e:  # noqa: BLE001
            exc = e
        if exc is not None and not isinstance(exc, ConnectionLost):
            with self._bg_lock:
                self._bg_exc = exc

    def check_bg(self):
        """Raise (once) a deferred error from the background pipeline."""
        with self._bg_lock:
            exc, self._bg_exc = self._bg_exc, None
        if exc is not None:
            raise exc

    # -- task/actor submission (dataplane routing) -----------------------------

    def submit_task(self, spec: dict) -> None:
        """Submit a stateless task: a leased direct slot when one is held
        (peer plane, no head traffic), else the head path — which also
        primes lease acquisition for the next burst."""
        dp = self._dataplane
        if dp is not None:
            dp.ensure_args_shared(spec)
            if dp.submit_task(spec):
                return
        self.call_batched("submit_task", spec)

    def submit_actor_task(self, spec: dict) -> None:
        """Submit an actor call: peer-direct once the actor's address is
        resolved (and the switch is order-safe), else head-mediated."""
        dp = self._dataplane
        if dp is not None:
            dp.ensure_args_shared(spec)
            if dp.submit_actor_task(spec):
                return
            dp.note_head_actor_call(spec["actor_id"])
        self.call_batched("submit_actor_task", spec)

    def prepare_actor_route(self, raw_actor_id: bytes) -> None:
        """Register interest in an actor's peer route at creation time (the
        ALIVE broadcast then pre-dials during creation dispatch)."""
        if self._dataplane is not None:
            self._dataplane.prepare_actor_route(raw_actor_id)

    def ensure_shared(self, raw: bytes) -> None:
        """A ref is crossing a process boundary: make sure the head can
        answer for it even if its value only lives in this process's
        direct-result cache."""
        if self._dataplane is not None:
            self._dataplane.ensure_shared(raw)

    def ensure_args_shared(self, spec: dict) -> None:
        """Same, for every arg id of a spec that bypasses the routed
        submission paths (e.g. actor creation tasks)."""
        if self._dataplane is not None:
            self._dataplane.ensure_args_shared(spec)

    def cancel_task(self, task_raw: bytes, force: bool = False):
        if self._dataplane is not None \
                and self._dataplane.cancel_task(task_raw, force):
            return {"cancelled": True}
        return self.call("cancel_task",
                         {"task_id": task_raw, "force": force})

    def drain_bg(self, timeout: float = 30.0):
        """Block until all fired background RPCs have been acknowledged."""
        self._flush_put_batch()
        self._flush_submit_batch()
        with self._bg_lock:
            futs, self._bg_futs = list(self._bg_futs), deque()
        for f in futs:
            try:
                f.result(timeout=timeout)
            except BaseException as e:  # noqa: BLE001
                if not isinstance(e, ConnectionLost):
                    with self._bg_lock:
                        self._bg_exc = e
        self.check_bg()

    # -- objects ---------------------------------------------------------------

    def put(self, value: Any) -> ObjectID:
        oid = ObjectID.from_random()
        self.put_with_id(oid, value)
        return oid

    def put_with_id(self, oid: ObjectID, value: Any) -> int:
        cfg = get_config()
        _t0 = time.perf_counter()
        meta, buffers = serialization.serialize(value)
        size = serialization.packed_size(meta, buffers)
        # Contention accounting (doctor --object-plane): the large-put wall
        # splits into serialize (here) / alloc / first_touch (StoreClient)
        # / copy (pack_into below).  Inline puts skip the bookkeeping — two
        # histogram observes would be real overhead on a ~100us path.
        _large = size > cfg.inline_object_max_bytes and not self.proxy
        if _large:
            object_store.note_put_stage(
                "serialize", time.perf_counter() - _t0, size)
        if size <= cfg.inline_object_max_bytes:
            blob = bytearray(size)
            serialization.pack_into(meta, buffers, memoryview(blob))
            blob = bytes(blob)
            self._local_put(oid, blob)
            with self._put_batch_lock:
                self._put_batch.append(
                    {"object_id": oid.binary(), "inline": blob}
                )
                n = len(self._put_batch)
            if n >= 64:
                self._flush_put_batch()
        elif self.proxy:
            # Off-host driver: no local shm store the cluster can read —
            # upload into the head's store in message-sized chunks
            # (reference: util/client/dataclient.py chunked put stream).
            blob = bytearray(size)
            serialization.pack_into(meta, buffers, memoryview(blob))
            chunk = 4 << 20
            futs = []
            for off in range(0, size, chunk):
                part = bytes(blob[off:off + chunk])
                futs.append(self.rpc.call_async("proxy_put", {
                    "object_id": oid.binary(), "total": size,
                    "offset": off, "data": part,
                    "done": off + chunk >= size,
                }))
                while len(futs) > 4:
                    futs.pop(0).result(timeout=120)
            for f in futs:
                f.result(timeout=120)
        else:
            # If this process freed large objects moments ago, their warm
            # segments are on their way to the pool (free -> detach-ack ->
            # pool, a few ms): a short wait claims warm pages instead of
            # paying cold first-touch faults.
            with self._local_lock:
                recent = time.monotonic() - self._last_large_free < 0.5
            wait = 0.06 if recent else 0.0
            buf = self.store().create(oid, size, wait_pool_s=wait)
            _t1 = time.perf_counter()
            serialization.pack_into(meta, buffers, buf)
            object_store.note_put_stage(
                "copy", time.perf_counter() - _t1, size)
            with self._local_lock:
                self.large_oids[oid.binary()] = size
            # Registration rides the put batch (same-connection FIFO keeps
            # it ahead of any message referencing the object) — and, while
            # headless, it queues for replay instead of vanishing into a
            # dead socket.
            with self._put_batch_lock:
                self._put_batch.append(
                    {"object_id": oid.binary(), "size": size,
                     "node_id": self.node_id.binary()}
                )
            _t2 = time.perf_counter()
            self._flush_put_batch()
            object_store.note_put_stage(
                "register", time.perf_counter() - _t2, 0)
        return size

    @contextlib.contextmanager
    def _maybe_blocked(self):
        """Tell the head this worker is parked in a blocking get/wait so its
        task's resources can be released (and a replacement worker spawned) —
        without this, nested gets deeper than the worker-pool cap deadlock
        (reference: raylet releases the CPU lease for workers blocked in
        ray.get).  Actor tasks hold no pool resources, so they skip it."""
        from .context import ctx

        tid = ctx.current_task_id
        if self.kind != "worker" or tid is None or ctx.current_actor_id is not None:
            yield
            return
        try:
            self.rpc.call("task_blocked", {"task_id": tid.binary()})
        except Exception:
            pass
        try:
            yield
        finally:
            try:
                self.rpc.call("task_unblocked", {"task_id": tid.binary()})
            except Exception:
                pass

    def get_raw(self, object_ids: Sequence[ObjectID], timeout: float = -1.0):
        """Fetch wire descriptors for objects (blocking until sealed)."""
        self._flush_put_batch()
        self._flush_submit_batch()
        with self._maybe_blocked():
            # Through call(): get_objects is idempotent, so a head-restart
            # window retries (with reconnects between attempts) instead of
            # surfacing the first ConnectionLost — the bounded pause.
            reply = self.call(
                "get_objects",
                {"object_ids": [o.binary() for o in object_ids], "timeout": timeout},
                timeout=None if timeout < 0 else timeout + 30,
            )
        return reply["objects"]

    def get(self, refs: Sequence, timeout: float = -1.0) -> List[Any]:
        self.check_bg()
        object_ids = [r.object_id for r in refs]
        dp = self._dataplane
        if dp is not None:
            # Flush staged peer submissions, then block on their replies —
            # no head involvement for the whole get when every ref is a
            # direct result.  The direct wait consumes from the SAME
            # timeout budget the head fetch below gets (never double it).
            t0 = time.monotonic()
            dp.flush_pending()
            dp.await_calls([o.binary() for o in object_ids], timeout)
            if timeout >= 0:
                timeout = max(0.0, timeout - (time.monotonic() - t0))
        # In-process store first: objects this process put or already read
        # resolve without a control-plane round trip.
        local: Dict[int, bytes] = {}
        direct: Dict[int, dict] = {}
        missing: List[ObjectID] = []
        for i, oid in enumerate(object_ids):
            if dp is not None:
                d = dp.result_desc(oid.binary())
                if d is not None:
                    direct[i] = d
                    continue
            blob = self._local_get(oid)
            if blob is not None:
                local[i] = blob
            else:
                missing.append(oid)
        descs = iter(self.get_raw(missing, timeout) if missing else ())
        out = []
        for i, oid in enumerate(object_ids):
            if i in direct:
                try:
                    out.append(self._materialize(oid, direct[i]))
                except exceptions.ObjectReconstructionFailedError:
                    raise
                except exceptions.ObjectLostError:
                    out.append(self._recover_and_get(oid, timeout))
                continue
            if i in local:
                out.append(serialization.unpack(local[i]))
                continue
            desc = next(descs)
            if desc.get("timeout"):
                raise exceptions.GetTimeoutError(
                    f"ray_tpu_torch.get timed out after {timeout}s on {oid}"
                )
            inline = desc.get("inline")
            if inline is not None and desc.get("error") is None:
                self._local_put(oid, inline)
            try:
                out.append(self._materialize(oid, desc))
            except exceptions.ObjectReconstructionFailedError:
                raise
            except exceptions.ObjectLostError:
                out.append(self._recover_and_get(oid, timeout))
        return out

    def _recover_and_get(self, oid: ObjectID, timeout: float):
        """Every known copy of the object is gone: ask the head to recompute
        it from lineage, then wait for the re-seal and re-read (reference:
        object_recovery_manager.h:90)."""
        from . import deadline as _dl

        deadline = None if timeout < 0 else _dl.Deadline.after(timeout)
        # The sole-copy node may be dead but not yet declared (its head
        # connection can linger); back off between attempts so the health
        # prober has time to reap it and the head drops the stale location.
        backoff = _dl.BackoffPolicy(base_s=0.5, multiplier=2.0, cap_s=2.0,
                                    jitter=0.0)
        for attempt in range(3):
            if attempt:
                backoff.sleep(attempt, deadline)
            self.call("reconstruct_object", {"object_id": oid.binary()})
            remaining = (
                -1.0 if deadline is None
                else max(0.0, deadline.remaining())
            )
            desc = self.get_raw([oid], remaining)[0]
            if desc.get("timeout"):
                raise exceptions.GetTimeoutError(
                    f"ray_tpu_torch.get timed out awaiting reconstruction of {oid}"
                )
            try:
                return self._materialize(oid, desc)
            except exceptions.ObjectReconstructionFailedError:
                raise
            except exceptions.ObjectLostError:
                continue  # lost again mid-recovery (another node died)
        raise exceptions.ObjectLostError(
            f"object {oid} kept vanishing during reconstruction"
        )

    def _materialize(self, oid: ObjectID, desc: dict) -> Any:
        if desc.get("error") is not None:
            raise serialization.unpack(desc["error"])
        if desc.get("inline") is not None:
            return serialization.unpack(desc["inline"])
        loc = desc.get("node_id")
        if self.proxy:
            # Off-host driver: every stored object is remote by definition;
            # pull it over the owning node's object-plane endpoints.
            view = self._pull_remote(oid, desc)
            return serialization.unpack(view)
        if (loc is not None and self.node_id is not None
                and loc != self.node_id.binary()):
            # The object lives on another node: fetch it over that node's
            # object-plane server into our local store (reference:
            # object_manager.h:117 chunked pull + local plasma copy).
            view = self._pull_remote(oid, desc)
            return serialization.unpack(view)
        view = self.store(desc["session"]).get(oid, timeout=2.0)
        if view is None:
            # Segment may have been spilled to disk; ask the store daemon to
            # restore it, then retry the attach.
            if self.rpc.call(
                "restore_object", {"object_id": oid.binary()}
            ).get("ok"):
                view = self.store(desc["session"]).get(oid, timeout=2.0)
        if view is None:
            raise exceptions.ObjectLostError(
                f"object {oid} location lost (node died?)"
            )
        return serialization.unpack(view)

    # -- inter-node transfer ---------------------------------------------------

    def _pull_conn(self, addr: str) -> RpcClient:
        with self._pull_lock:
            conn = self._pull_conns.get(addr)
            if conn is None or conn.closed:
                host, port = addr.rsplit(":", 1)
                conn = RpcClient(host, int(port), name="object-pull")
                self._pull_conns[addr] = conn
            return conn

    def _pull_remote(self, oid: ObjectID, desc: dict) -> memoryview:
        from .node_main import PULL_CHUNK_BYTES

        addr = desc.get("addr")
        if not addr:
            raise exceptions.ObjectLostError(
                f"object {oid}: owner node has no object-plane address"
            )
        local = self.store()
        existing = local.get(oid)
        if existing is not None:  # already pulled by this process earlier
            return existing
        size = desc["size"]
        buf, commit, abort = local.create_staged(oid, size)
        if size >= (8 << 20):
            # Fault in backing pages in parallel before the transfer: the
            # recv_into loop otherwise pays first-touch faults serially,
            # one page per 4 KiB of stream.
            from ray_tpu_torch import _native

            _native.prefault(buf)
        bulk_addr = desc.get("bulk_addr")
        if bulk_addr:
            try:
                self._bulk_pull(bulk_addr, oid, buf, size)
                return self._commit_pull(oid, size, commit)
            except exceptions.ObjectLostError:
                abort()
                raise
            except Exception:
                pass  # bulk channel unavailable: fall back to chunked RPC
        try:
            # Pipelined chunk window: several chunk requests in flight on the
            # one connection so the transfer overlaps server read, wire time
            # and local memcpy (reference: object_manager.h:63 splits objects
            # into chunks and streams them concurrently).
            from ray_tpu_torch import _native

            rpc = self._pull_conn(addr)
            window = 8
            futs: Dict[int, Any] = {}
            next_off = 0

            def fire():
                nonlocal next_off
                while next_off < size and len(futs) < window:
                    futs[next_off] = rpc.call_async(
                        "pull_object",
                        {"object_id": oid.binary(), "offset": next_off,
                         "max_bytes": PULL_CHUNK_BYTES},
                    )
                    next_off += PULL_CHUNK_BYTES

            fire()
            while futs:
                off = min(futs)
                reply = futs.pop(off).result(timeout=120.0)
                if not reply.get("found"):
                    raise exceptions.ObjectLostError(
                        f"object {oid} vanished from {addr} mid-pull"
                    )
                data = reply["data"]
                want = min(PULL_CHUNK_BYTES, size - off)
                if len(data) != want:
                    raise exceptions.ObjectLostError(
                        f"object {oid}: short chunk at offset {off} from {addr}"
                    )
                if len(data) >= (1 << 20):
                    _native.copy(buf[off:off + len(data)], data)
                else:
                    buf[off:off + len(data)] = data
                fire()
        except Exception:
            abort()
            raise
        return self._commit_pull(oid, size, commit)

    def _commit_pull(self, oid: ObjectID, size: int, commit) -> memoryview:
        view = commit()
        # Register the new copy: same-node readers now attach via shm, and
        # the node's store daemon takes accounting ownership.  `from_pull`
        # lets the head reject (and reclaim) the copy if the object's last
        # reference was dropped mid-pull — resurrecting a freed record would
        # leak the segment with no owner left to decref it.  Proxy drivers
        # skip registration: their private copy is not a cluster location.
        if self.node_id is not None:
            try:
                self.rpc.call(
                    "put_object",
                    {"object_id": oid.binary(), "size": size,
                     "node_id": self.node_id.binary(), "from_pull": True},
                )
            except Exception:
                pass
        return view

    def _bulk_conn(self, addr: str):
        import socket

        with self._pull_lock:
            entry = self._bulk_conns.get(addr)
        if entry is not None:
            return entry
        # Connect outside the lock: a 30s timeout on an unreachable node
        # must not stall other threads' pull-connection lookups.
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=30)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        entry = (sock, make_lock("client.bulk_conn"))
        with self._pull_lock:
            racer = self._bulk_conns.get(addr)
            if racer is not None:
                sock.close()
                return racer
            self._bulk_conns[addr] = entry
        return entry

    def _bulk_pull(self, addr: str, oid: ObjectID, buf: memoryview, size: int):
        """Raw-TCP transfer into the staged segment: request, then
        recv_into() the mmap directly — no framing or intermediate copies
        (server side is sendfile; see node_main.BulkServer)."""
        import struct

        from .node_main import BULK_NOT_FOUND

        sock, lock = self._bulk_conn(addr)
        try:
            with lock:
                sock.sendall(oid.binary() + struct.pack("<QQ", 0, size))
                hdr = b""
                while len(hdr) < 8:
                    part = sock.recv(8 - len(hdr))
                    if not part:
                        raise ConnectionError("bulk channel closed")
                    hdr += part
                (n,) = struct.unpack("<Q", hdr)
                if n == BULK_NOT_FOUND:
                    raise exceptions.ObjectLostError(
                        f"object {oid} vanished from {addr} mid-pull"
                    )
                if n != size:
                    raise exceptions.ObjectLostError(
                        f"object {oid}: bulk size mismatch ({n} != {size})"
                    )
                got = 0
                while got < n:
                    r = sock.recv_into(buf[got:], n - got)
                    if r == 0:
                        raise ConnectionError("bulk channel closed mid-body")
                    got += r
        except BaseException:
            # Any failure leaves undrained body bytes on the stream — the
            # connection is desynced and must not be reused (a poisoned
            # socket would parse stale body bytes as the next length header,
            # and the server would sit in sendfile holding a pin).
            with self._pull_lock:
                if self._bulk_conns.get(addr) is not None \
                        and self._bulk_conns[addr][0] is sock:
                    self._bulk_conns.pop(addr, None)
            try:
                sock.close()
            except OSError:
                pass
            raise

    def wait(self, refs: Sequence, num_returns: int, timeout: float):
        self._flush_put_batch()
        self._flush_submit_batch()
        raws = [r.object_id.binary() for r in refs]
        dp = self._dataplane
        if dp is not None:
            dp.flush_pending()
        if dp is None:
            ready_set = self._wait_head(raws, num_returns, timeout)
        else:
            # Mixed readiness sources: direct-call results resolve locally
            # (their completion never touches the head), everything else
            # via the head's wait.  Pure-direct waits make no head RPC at
            # all; mixed waits slice the head wait so local completions
            # can satisfy num_returns early.
            deadline = None if timeout < 0 else time.monotonic() + timeout
            head_ready: set = set()
            while True:
                local_ready, events, head_raws = dp.wait_split(raws)
                ready_set = local_ready | head_ready
                if len(ready_set) >= num_returns:
                    break
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                head_pending = [raw for raw in head_raws
                                if raw not in head_ready]
                if remaining is not None and remaining <= 0:
                    # Budget exhausted — including the pure-poll timeout=0
                    # case, which must still ask the head once: breaking
                    # without a poll reports already-sealed head objects
                    # as not-ready forever.
                    if head_pending:
                        head_ready |= self._wait_head(
                            head_pending,
                            min(max(num_returns - len(ready_set), 1),
                                len(head_pending)),
                            0.0,
                        )
                        local_ready, _, _ = dp.wait_split(raws)
                        ready_set = local_ready | head_ready
                    break
                if head_pending:
                    slice_t = 0.05 if events else remaining
                    if remaining is not None and slice_t is not None:
                        slice_t = min(slice_t, remaining)
                    head_ready |= self._wait_head(
                        head_pending,
                        min(max(num_returns - len(ready_set), 1),
                            len(head_pending)),
                        -1.0 if slice_t is None else slice_t,
                    )
                    if not events:
                        # The head wait consumed the whole budget: final.
                        local_ready, _, _ = dp.wait_split(raws)
                        ready_set = local_ready | head_ready
                        break
                elif events:
                    step = (0.02 if remaining is None
                            else max(0.001, min(0.02, remaining)))
                    events[0].wait(step)
                else:
                    break
        ready = [r for r in refs if r.object_id.binary() in ready_set]
        not_ready = [r for r in refs if r.object_id.binary() not in ready_set]
        return ready, not_ready

    def _wait_head(self, raws: List[bytes], num_returns: int,
                   timeout: float) -> set:
        with self._maybe_blocked():
            # Through call(): wait_objects is idempotent — rides the
            # head-restart retry window like get_objects.
            reply = self.call(
                "wait_objects",
                {
                    "object_ids": raws,
                    "num_returns": num_returns,
                    "timeout": timeout,
                },
                timeout=None if timeout < 0 else timeout + 30,
            )
        return set(reply["ready"])

    def _note_frees(self, raw_ids: List[bytes]):
        """Local-store drops + large-segment free timestamps for a free
        batch, under one _local_lock pass (the free flusher thread and
        user threads both reach here)."""
        with self._local_lock:
            for raw in raw_ids:
                blob = self._local.pop(ObjectID(raw), None)
                if blob is not None:
                    self._local_bytes -= len(blob)
                if self.large_oids.pop(raw, None) is not None:
                    self._last_large_free = time.monotonic()

    def free_objects(self, raw_ids: List[bytes]):
        self._note_frees(raw_ids)
        if self._dataplane is not None:
            # Drop cached direct results; defer frees of args pinned by
            # in-flight direct calls (released at call completion).
            raw_ids = self._dataplane.intercept_frees(raw_ids)
            if not raw_ids:
                return
        # Flush buffered registrations/submissions first: freeing an object
        # whose registration is still batched would hit an unknown record
        # head-side and the late registration would resurrect it as a leak.
        self._flush_put_batch()
        self._flush_submit_batch()
        self.rpc.call("free_objects", {"object_ids": raw_ids})

    def free_objects_bg(self, raw_ids: List[bytes]):
        """Pipelined free for the ObjectRef GC flusher: local drops +
        dataplane interception, then a fire-and-forget head RPC."""
        self._note_frees(raw_ids)
        if self._dataplane is not None:
            raw_ids = self._dataplane.intercept_frees(raw_ids)
            if not raw_ids:
                return
        self.call_bg("free_objects", {"object_ids": raw_ids})

    def add_reference(self, raw_id: bytes):
        try:
            self.rpc.call("add_object_ref", {"object_ids": [raw_id]})
        except Exception:
            pass

    def next_stream_item(self, task_id: bytes, index: int) -> dict:
        if self._dataplane is not None:
            # Direct streaming tasks serve their items straight from the
            # executing worker (peer_next_stream_item).
            reply = self._dataplane.next_stream_item(task_id, index)
            if reply is not None:
                return reply
        with self._maybe_blocked():
            # Streams have no per-item budget: the producer paces the
            # consumer, so this read legitimately waits forever.
            return self.rpc.call(
                "next_stream_item", {"task_id": task_id, "index": index},
                timeout=None,
            )

    # -- KV --------------------------------------------------------------------

    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        return self.rpc.call(
            "kv_put", {"key": key, "value": value, "overwrite": overwrite}
        )["added"]

    def kv_get(self, key: str) -> Optional[bytes]:
        # Via call(): kv_get is in IDEMPOTENT_METHODS, so transient
        # connection errors retry instead of failing rendezvous/polling.
        return self.call("kv_get", {"key": key})["value"]

    def kv_del(self, key: str) -> bool:
        return self.rpc.call("kv_del", {"key": key})["deleted"]

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self.call("kv_keys", {"prefix": prefix})["keys"]

    # -- pubsub ----------------------------------------------------------------

    def _on_pubsub(self, body):
        with self._sub_lock:
            handlers = list(self._sub_handlers.get(body["topic"], ()))
        for fn in handlers:
            try:
                fn(body["data"])
            except Exception:
                import traceback

                traceback.print_exc()

    def subscribe(self, topic: str, handler: Callable[[Any], None]):
        with self._sub_lock:
            self._sub_handlers.setdefault(topic, []).append(handler)
        self.rpc.call("subscribe", {"topic": topic})

    def unsubscribe(self, topic: str, handler: Callable[[Any], None]) -> None:
        """Drop a local handler registered via subscribe().  The server-side
        topic subscription stays (other handlers may share it); a process
        with zero handlers simply ignores the pushes."""
        with self._sub_lock:
            handlers = self._sub_handlers.get(topic)
            if handlers and handler in handlers:
                handlers.remove(handler)

    def publish(self, topic: str, data: Any):
        self.rpc.call("publish", {"topic": topic, "data": data})

    # -- passthrough -----------------------------------------------------------

    def call(self, method: str, body=None, timeout: Optional[float] = 60.0):
        self.check_bg()
        self._flush_put_batch()
        self._flush_submit_batch()
        # getattr: synthetic/partial clients (tests, tooling) may lack the
        # dataplane field entirely.
        dp = getattr(self, "_dataplane", None)
        if dp is not None:
            # Cross-plane ordering: staged peer submissions flush before
            # any synchronous control-plane call (kill_actor after a burst
            # of casts must land after them, matching head-batch flushing).
            dp.flush_pending()
        if method not in IDEMPOTENT_METHODS:
            try:
                return self.rpc.call(method, body, timeout=timeout)
            except ConnectionLost as e:
                # A mutating call interrupted by connection loss cannot be
                # replayed safely (the head may or may not have applied it).
                # Heal the connection for the caller's NEXT call, then fail
                # typed so the caller knows to resubmit this one.
                try:
                    self._try_reconnect()
                except Exception:
                    pass
                raise exceptions.HeadRestartedError(method) from e
        # Idempotent reads survive transient connection hiccups (head busy,
        # socket reset during a head restart window) on the unified
        # deadline/backoff policy (core/deadline.py).  Timeouts are NOT
        # retried: a stuck head would just multiply the caller's wait; only
        # connection-level failures qualify.  When the connection is
        # genuinely DOWN (head restart window), retries — with reconnect
        # attempts between them — continue until the outage Deadline
        # (head_restart_retry_window_s) expires: the bounded pause a
        # head-routed read pays across a head restart.
        from . import deadline as _dl

        policy = _dl.call_policy()
        last: Optional[BaseException] = None
        attempt = 0
        outage_deadline: Optional[_dl.Deadline] = None
        while True:
            try:
                return self.rpc.call(method, body, timeout=timeout)
            except (ConnectionLost, ConnectionError, OSError) as e:
                if isinstance(e, TimeoutError):
                    raise
                last = e
                attempt += 1
                _dl.count_retry("head")
                closed = bool(getattr(self.rpc, "closed", False))
                if not closed and attempt >= get_config().rpc_retry_attempts:
                    raise last
                if closed:
                    if outage_deadline is None:
                        outage_deadline = _dl.Deadline.after(
                            get_config().head_restart_retry_window_s)
                    if outage_deadline.expired:
                        _dl.count_deadline_exceeded("head")
                        raise last
                policy.sleep(attempt, outage_deadline)
                if self.rpc.closed:
                    # A dead RpcClient never heals on its own (sticky
                    # `closed`): without a fresh connection the remaining
                    # attempts would fail identically.
                    try:
                        self._try_reconnect()
                    except Exception:
                        pass

    def _try_reconnect(self) -> bool:
        """Recovery from a lost head connection (e.g. a head restart
        window): dial a fresh RpcClient, re-register carrying the SAME
        identity, re-subscribe pubsub topics, and swap it in.  Drivers AND
        workers reconnect — a worker re-register is the field-state resync
        half of head fault tolerance (the restarted head adopts the live
        worker, its hosted actor, and its incarnation instead of treating
        the process as dead).  Proxy drivers don't: their mode/session
        state is negotiated in the initial register reply, and a silent
        re-register could flip the head's view of the protocol
        mid-stream."""
        if self.kind not in ("driver", "worker") or self.proxy:
            return False
        if self.reconnect_refused is not None:
            return False  # the head told us to stay dead; retrying is noise
        from . import schema as wire_schema

        # One reconnector at a time: concurrent retry paths (user thread +
        # autoscaler/serve poll threads) would each dial and register, and
        # the loser's swap would close the winner's fresh connection —
        # leaving a duplicate driver registration head-side whose
        # disconnect fires job-scoped cleanup against live state.
        with self._reconnect_lock:
            if not self.rpc.closed:
                return True  # another caller already healed the connection
            return self._reconnect_locked(wire_schema)

    def _reconnect_body(self, wire_schema) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "kind": self.kind, "pid": os.getpid(),
            "protocol": wire_schema.PROTOCOL_VERSION,
            # Same-process re-dial: lets the head un-retire this pid's
            # cumulative metrics instead of double-counting them (and
            # never confuse a recycled pid for a comeback).
            "reconnect": True,
        }
        for key in ("worker_id", "node_id", "log_path", "peer_addr"):
            val = self._reg_info.get(key)
            if val:
                body[key] = val
        payload_fn = self.resync_payload
        if payload_fn is not None:
            try:
                resync = payload_fn()
            except Exception:
                resync = None
            if resync:
                body["resync"] = resync
        return body

    def _reconnect_locked(self, wire_schema) -> bool:
        rpc = None
        try:
            host, port = self.head_addr.rsplit(":", 1)
            rpc = RpcClient(host, int(port), name=f"{self.kind}-rpc")
            # The fresh connection inherits EVERY push handler (execute_task
            # / cancel / lease_revoke / pubsub / ...) BEFORE registering:
            # the head may push work the moment the register reply is sent.
            for name, fn in list(self.rpc._push_handlers.items()):
                rpc.on_push(name, fn)
            rpc.on_push("pubsub", self._on_pubsub)
            rpc.on_push("object_free", self._on_object_free)
            reply = rpc.call("register", self._reconnect_body(wire_schema))
            if reply.get("refused"):
                # The head explicitly refused to adopt this identity (stale
                # worker incarnation, dead actor): publish the reason so the
                # owner's reconnect loop exits instead of retrying forever.
                self.reconnect_refused = str(reply["refused"])
                rpc.close()
                return False
            if self.kind == "driver" and reply.get("session") != self.session:
                # A different session means a head restart LOST the store
                # namespace this driver's puts live in (no stable
                # RT_HEAD_SESSION): a silent rebind would look healthy until
                # the first object access hung.  Surface the outage instead.
                # (A standalone head restarted with the same session is
                # indistinguishable from a network blip here — by design.)
                rpc.close()
                return False
            with self._sub_lock:
                topics = list(self._sub_handlers)
            for topic in topics:
                rpc.call("subscribe", {"topic": topic})
            # The replacement inherits the lost-connection callback only
            # once registration succeeded — a drop during the handshake is
            # handled by this method's own failure path, not by spawning a
            # second reconnect loop.  (The old client's attribute still
            # holds the owner's callback: close() nulls it after the swap.)
            rpc.on_connection_lost = self.rpc.on_connection_lost
            self.trace_sample_rate = reply.get(
                "trace_sample_rate", self.trace_sample_rate)
        except Exception:
            if os.environ.get("RT_DEBUG_RPC_ERR"):
                import sys as _sys
                import traceback as _tb

                print("reconnect attempt failed:", file=_sys.stderr)
                _tb.print_exc()
            # A dial that got as far as registering left a live duplicate
            # driver connection head-side: close it so its disconnect
            # cleanup runs NOW (against a connection that owns nothing)
            # rather than minutes later against this driver's live state —
            # and so each failed attempt doesn't leak a socket + thread.
            if rpc is not None:
                try:
                    rpc.close()
                except Exception:
                    pass
            return False  # head still down: the caller's backoff continues
        old, self.rpc = self.rpc, rpc
        try:
            old.on_connection_lost = None  # its loss already happened
            old.close()  # stop the dead client's event-loop thread
        except Exception:
            pass
        # Field-state resync, client half: a restarted head's object
        # directory is rebuilt from live reports — re-register this
        # process's large shm puts so its refs stay resolvable.  Rides the
        # put batch (FIFO ahead of anything that references them); the
        # restarted head's adopt path tolerates already-known objects, so
        # a plain network blip just re-asserts existing records.
        with self._local_lock:
            large = list(self.large_oids.items())
        if large and self.node_id is not None:
            with self._put_batch_lock:
                self._put_batch[:0] = [
                    {"object_id": raw, "size": size,
                     "node_id": self.node_id.binary()}
                    for raw, size in large
                ]
        if self._dataplane is not None:
            try:
                # Held leases died with the old head: drop the slots (their
                # lease ids mean nothing to the new incarnation) and
                # re-route queued specs; cached direct-actor routes stay —
                # the workers survived and their peer servers kept serving.
                self._dataplane.on_head_reconnected()
            except Exception:
                pass
        # Replay everything buffered during the headless window (task_done
        # reports, submissions, object registrations).
        try:
            self._flush_put_batch()
            self._flush_submit_batch()
        except Exception:
            pass
        cb = self.on_reconnected
        if cb is not None:
            try:
                cb()
            except Exception:
                pass
        # The free-flusher thread exits when it observes a closed rpc; if it
        # died during the outage window, object frees (and the batched
        # put/submit safety-net flush) would silently stop forever.  The
        # brief join drains a loop that already decided to exit but hasn't
        # returned yet (its wakeup period is 0.5s).
        flusher = getattr(self, "_free_flusher", None)
        if flusher is not None and flusher is not threading.current_thread():
            flusher.join(timeout=1.0)
        if flusher is None or not flusher.is_alive():
            self._free_flusher = threading.Thread(
                target=self._free_flush_loop, daemon=True, name="free-flusher"
            )
            self._free_flusher.start()
        # Reads work again, but the OLD connection's death already tore
        # down job-scoped state head-side (non-detached placement groups,
        # in-flight task ownership).  Say so loudly instead of letting a
        # later hang be the first symptom.  (Workers skip the warning —
        # their reconnect is the designed headless-recovery path and the
        # head logs the resync.)
        if self.kind == "driver":
            import warnings

            warnings.warn(
                "ray_tpu_torch driver reconnected to the head after a lost "
                "connection; job-scoped state tied to the old connection "
                "(non-detached placement groups, in-flight head-routed "
                "tasks) may have been released — resubmit anything that "
                "fails with HeadRestartedError",
                RuntimeWarning,
                stacklevel=3,
            )
        return True

    def close(self):
        try:
            # Final span flush: a short-lived driver's trailing spans must
            # not die in the ring (only for the session's active client —
            # a tooling client closing must not steal another's spans).
            from .context import ctx as _ctx

            if _ctx.client is self:
                from ..util import tracing as _tracing

                _tracing.flush_spans(self)
        except BaseException:  # noqa: BLE001 — shutdown is best-effort
            pass
        try:
            self.drain_bg(timeout=5.0)
        except BaseException:  # noqa: BLE001 — shutdown is best-effort
            pass
        if self._dataplane is not None:
            try:
                # Return held leases + close peer connections before the
                # head connection drops (disconnect would release them
                # anyway; this keeps shutdown deterministic).
                self._dataplane.close()
            except BaseException:  # noqa: BLE001
                pass
        for st in self._stores_snapshot():
            st.close()
        self.rpc.close()
