"""Client-side dataplane: peer-to-peer actor calls and leased task slots.

Role-equivalent to the reference core worker's direct task transport and
lease policy (reference: src/ray/core_worker/transport/
direct_actor_task_submitter.h — per-actor client cache with ordered
submission; normal_task_submitter.h — worker leasing, pipelined submission,
lease returns).  The head stays the address directory and the lessor; the
per-call hot path runs submitter -> worker over the workers' peer RPC
servers, so steady-state traffic never transits the head's event loop.

Two planes, one fallback rule:

- **Direct actor calls**: the first call resolves the owning worker's
  address via the head (``resolve_actor``, cached; pre-warmed by the
  ``actor_events`` broadcast at creation) and every subsequent call ships
  peer-to-peer.  Per-submitter FIFO survives the switch because a client
  that already routed calls through the head only switches once the head
  reports the actor idle; once direct, one TCP connection is the order.
- **Task leases**: stateless default-strategy tasks ride execution slots
  leased per resource shape (``lease_request``).  The client pipelines
  specs into leased workers, renews/returns leases in the background, and
  honors head-pushed revocations (drain, TTL, preemption).

Any failure on the peer plane — dial refused, connection lost, stale
incarnation — degrades to the head-mediated path and re-resolves.  The
head path is the correctness baseline; this module is the fast path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

from .. import exceptions
from . import serialization
from .config import get_config
from .rpc import RpcClient
from ..devtools.locks import guarded, make_lock

#: pipelining bound for an actor's peer connection: deep (the head path
#: blocks at 1000 in-flight background RPCs, this is the analog), and calls
#: past it queue client-side rather than falling back — a mixed direct/head
#: stream would break per-submitter FIFO.
ACTOR_WINDOW = 1024
#: client-side queue residency bound: a spec parked longer than this while
#: every slot is saturated ships via the head instead (the head can spawn
#: workers and place globally; the local pool can only wait).
PENDING_STALE_S = 1.0


class _Slot:
    """One peer endpoint: a leased worker slot, or an actor's hosting
    worker."""

    __slots__ = ("addr", "worker_id", "node_id", "session", "object_addr",
                 "bulk_addr", "lease_id", "conn", "in_flight",
                 "last_progress", "last_active", "dead", "revoked",
                 "lat_ewma")

    def __init__(self, info: dict, conn: RpcClient,
                 lease_id: Optional[bytes] = None):
        self.addr: str = info["addr"]
        self.worker_id: bytes = info["worker_id"]
        self.node_id: bytes = info["node_id"]
        self.session: str = info["session"]
        self.object_addr = info.get("object_addr")
        self.bulk_addr = info.get("bulk_addr")
        self.lease_id = lease_id
        self.conn = conn
        self.in_flight = 0
        now = time.monotonic()
        # Completion recency: the long-runner heuristic (a slot that
        # hasn't completed anything lately is probably stuck on a long
        # task and should not collect more work while peers are fresher).
        self.last_progress = now
        self.last_active = now  # any traffic; drives the idle-return timer
        self.dead = False
        self.revoked = False
        # Per-route completion-latency EWMA: the gray-failure signal (a
        # route can be alive yet uselessly slow).  0.0 = no samples yet.
        self.lat_ewma = 0.0


class _ActorRoute:
    __slots__ = ("slot", "pending", "head_calls", "next_attempt", "dead",
                 "unsupported")

    def __init__(self):
        self.slot: Optional[_Slot] = None
        self.pending: deque = deque()  # _DirectCall queued behind the window
        # Calls this client routed through the head: while any could still
        # be queued/running head-side, switching to the peer plane could
        # reorder them behind newer direct calls.
        self.head_calls = 0
        self.next_attempt = 0.0  # resolve backoff
        self.dead = False
        self.unsupported = False  # e.g. execute_out_of_order actors


class _LeasePool:
    __slots__ = ("resources", "slots", "pending", "requesting",
                 "next_request", "request_at")

    def __init__(self, resources: dict):
        self.resources = resources
        self.slots: List[_Slot] = []
        self.pending: deque = deque()  # (call, enqueue_monotonic)
        self.requesting = False
        self.next_request = 0.0
        # When the in-flight lease_request fired: maintain() resets a
        # request whose reply never arrived (dropped on the wire), so a
        # lost grant can't wedge the pool's `requesting` latch forever.
        self.request_at = 0.0


class _DirectCall:
    """One in-flight (or queued) peer submission and its local outcome."""

    __slots__ = ("spec", "kind", "slot", "pool", "route", "fut", "finalized",
                 "done", "event", "share", "sent_at", "deadline_at")

    def __init__(self, spec: dict, kind: str):
        self.spec = spec
        self.kind = kind  # "actor" | "task"
        self.slot: Optional[_Slot] = None
        self.pool: Optional[_LeasePool] = None
        self.route: Optional[_ActorRoute] = None
        self.fut = None
        self.finalized = False
        # Watchdog inputs: when the spec hit the wire (0.0 = still queued
        # client-side) and the caller's absolute budget expiry (0.0 =
        # none; carried in from spec["deadline_s"] so a re-routed call
        # can't exceed the original budget).
        self.sent_at = 0.0
        self.deadline_at = 0.0
        # True once the call reached a terminal local state: a result
        # descriptor exists, OR the spec was re-routed to the head (the
        # submitter's get()/wait() then follow the head path).  The Event
        # is allocated lazily — only when a waiter shows up — because an
        # Event per call is measurable on the submission hot path; both
        # fields transition under the dataplane lock.
        self.done = False
        self.event: Optional[threading.Event] = None
        # A ref to one of this call's returns crossed a process boundary
        # while the call was in flight: register the results head-side the
        # moment they arrive so the borrower's get() can seal.
        self.share = False


@guarded
class Dataplane:
    """Per-client routing state for both peer planes.  All public entry
    points are thread-safe; completion callbacks run on peer RPC loop
    threads and only ever take this object's lock plus the client's batch
    locks (strictly in that order)."""

    # Every routing table below is mutated from submitter threads, the
    # head-connection rpc loop (push handlers, lease replies), the shared
    # peer loop (completion callbacks), and throwaway fallback threads.
    # rtlint RT007 verifies the guards statically; RT_DEBUG_LOCKS=2
    # asserts them on every field rebind at runtime (devtools.locks).
    _RT_GUARDED_BY = {
        "_routes": "_lock",
        "_pools": "_lock",
        "_calls": "_lock",
        "_task_calls": "_lock",
        "_stream_routes": "_lock",
        "_results": "_lock",
        "_registered": "_lock",
        "_pins": "_lock",
        "_deferred_frees": "_lock",
        "_retired_conns": "_lock",
        "_failed_sends": "_lock",
        "_staged_callbacks": "_lock",
        "_subscribed": "_lock",
        "_quarantine": "_lock",
        "_peer_loop": "_peer_loop_lock",
    }

    def __init__(self, client):
        cfg = get_config()
        self._client = client
        self.actor_calls_enabled = bool(cfg.direct_calls)
        # Leasing is driver-only: a leased task that blocks in a nested
        # get() relies on the HEAD being able to place the nested work —
        # workers therefore always submit through the head, which can spawn
        # past the pool cap for them (the blocked-worker protocol).
        self.leases_enabled = bool(cfg.task_leases) \
            and client.kind == "driver"
        self._window = max(1, cfg.direct_inflight_per_slot)
        self._lease_max = max(1, cfg.lease_max_slots)
        self._idle_return_s = cfg.lease_idle_return_s
        self._peer_timeout = cfg.peer_connect_timeout_s
        # Gray-failure net: the in-flight budget for a direct call (the
        # dial-only peer_connect_timeout_s can't see a route that accepted
        # and then went dark) and the quarantine hold before a re-probe.
        self._peer_deadline = cfg.peer_call_deadline_s
        self._probe_s = cfg.peer_quarantine_probe_s
        self._lease_reply_s = cfg.rpc_connect_timeout_s
        self._lock = make_lock("dataplane.state")
        self._routes: Dict[bytes, _ActorRoute] = {}
        self._pools: Dict[Tuple, _LeasePool] = {}
        self._calls: Dict[bytes, _DirectCall] = {}       # return oid -> call
        self._task_calls: Dict[bytes, _DirectCall] = {}  # task id -> call
        self._stream_routes: Dict[bytes, _Slot] = {}     # streaming task -> slot
        self._results: Dict[bytes, dict] = {}            # oid -> result desc
        self._registered: Set[bytes] = set()             # oids sealed head-side
        self._pins: Dict[bytes, int] = {}                # arg oid -> pin count
        self._deferred_frees: Set[bytes] = set()
        self._retired_conns: List[RpcClient] = []
        self._failed_sends: List[_DirectCall] = []
        # Done-callbacks staged under the lock, attached after release:
        # concurrent.futures runs a callback INLINE when the future is
        # already done, and an inline _finalize/_on_lease_reply would
        # re-enter the non-reentrant dataplane lock (self-deadlock).
        self._staged_callbacks: List[Tuple[Any, Any]] = []
        # One shared loop thread multiplexes every peer connection (a
        # reader thread per worker connection would thrash small hosts).
        self._peer_loop = None
        self._peer_loop_lock = make_lock("dataplane.peer_loop")
        self._subscribed = False
        # Quarantined peer addrs -> monotonic lift time.  While held, every
        # dial of the addr degrades to the head path; the first dial past
        # the lift time IS the re-probe.
        self._quarantine: Dict[str, float] = {}
        self._direct_counter = None
        self._leased_counter = None
        self._quarantine_counter = None
        client.rpc.on_push("lease_revoke", self._on_lease_revoke)

    # ------------------------------------------------------------ counters

    def _count_direct(self):
        try:
            if self._direct_counter is None:
                from ..util.metrics import get_counter

                self._direct_counter = get_counter(
                    "ray_tpu_direct_calls_total",
                    "Actor calls submitted peer-to-peer (head bypassed)")
            self._direct_counter.inc()
        except Exception:
            pass

    def _count_leased(self):
        try:
            if self._leased_counter is None:
                from ..util.metrics import get_counter

                self._leased_counter = get_counter(
                    "ray_tpu_leased_tasks_total",
                    "Stateless tasks submitted via leased execution slots")
            self._leased_counter.inc()
        except Exception:
            pass

    def _count_quarantine(self, addr: str = ""):
        # Tagged by peer addr so the health plane's partition-suspicion
        # evidence (and `doctor`) can name WHICH peer went gray, not just
        # that one did; cardinality is bounded by cluster size.
        try:
            if self._quarantine_counter is None:
                from ..util.metrics import get_counter

                self._quarantine_counter = get_counter(
                    "ray_tpu_peer_quarantines_total",
                    "Peer routes quarantined for gray failure (stalled or "
                    "slow-but-alive)", tag_keys=("peer",))
            self._quarantine_counter.inc(1.0, {"peer": str(addr)})
        except Exception:
            pass

    # ----------------------------------------------------------- plumbing

    def _ensure_subscribed(self):
        # Flag flips under the lock (claim-then-act: one thread wins the
        # subscribe); the RPC itself runs outside it — subscribe() blocks
        # on the head round trip and must not hold the dataplane lock.
        with self._lock:
            if self._subscribed:
                return
            self._subscribed = True
        try:
            self._client.subscribe("actor_events", self._on_actor_event)
        except Exception:
            with self._lock:
                self._subscribed = False

    def _get_peer_loop(self):
        import asyncio

        with self._peer_loop_lock:
            if self._peer_loop is None:
                loop = asyncio.new_event_loop()
                threading.Thread(target=loop.run_forever, daemon=True,
                                 name="peer-loop").start()
                self._peer_loop = loop
            return self._peer_loop

    def _dial(self, info: dict,
              lease_id: Optional[bytes] = None) -> Optional[_Slot]:
        """Dial a peer endpoint (blocking, short timeout).  Never call on
        an RPC loop thread.  Quarantined addrs return None (head path)
        until their lift time; the first dial past it is the re-probe."""
        addr = info["addr"]
        with self._lock:
            lift = self._quarantine.get(addr)
            if lift is not None:
                now = time.monotonic()
                if now < lift:
                    return None
                # Re-probe window claimed: exactly one dial tests the
                # route; concurrent dials keep degrading until it lands.
                self._quarantine[addr] = now + self._probe_s
        try:
            conn = RpcClient(*_split(addr), name="peer-direct",
                             connect_timeout_s=self._peer_timeout,
                             loop=self._get_peer_loop())
        except Exception:
            if lift is not None:
                with self._lock:
                    # Failed re-probe: stay quarantined for another hold.
                    self._quarantine[addr] = \
                        time.monotonic() + self._probe_s
            return None
        if lift is not None:
            with self._lock:
                self._quarantine.pop(addr, None)  # probe succeeded
        return _Slot(info, conn, lease_id)

    def _quarantine_route_locked(self, slot: _Slot,
                                 route: Optional[_ActorRoute]):
        """Lock held.  Gray failure on a peer route (stalled in-flight
        call, or completion EWMA degraded past the budget): take the addr
        out of service until a re-probe, retire the slot, and detach every
        actor route pinned to it so their next call re-resolves (and,
        while the quarantine holds, runs via the head)."""
        self._quarantine[slot.addr] = time.monotonic() + self._probe_s
        if not slot.dead:
            self._retire_slot(slot)
        if route is not None and route.slot is slot:
            route.slot = None
        for r in self._routes.values():
            if r.slot is slot:
                r.slot = None
        self._count_quarantine(slot.addr)

    def _retire_slot(self, slot: _Slot):
        """Lock held.  Take a slot out of service; its connection is closed
        later by maintain() (closing joins the conn's loop thread, which a
        completion callback running ON that thread must never do)."""
        slot.dead = True
        if slot.conn is not None:
            self._retired_conns.append(slot.conn)

    # -- argument pinning -----------------------------------------------------

    def _pin_args(self, spec: dict):
        """Lock held.  A direct task's args bypass the head's submit-time
        pinning, so the submitting client must keep them alive itself: a
        free arriving while the call is in flight is deferred until the
        call completes (the head-path analog of _register_task's ref
        bump)."""
        for raw in spec.get("arg_ids", []):
            self._pins[raw] = self._pins.get(raw, 0) + 1
        if spec.get("args_ref") is not None:
            raw = spec["args_ref"]
            self._pins[raw] = self._pins.get(raw, 0) + 1

    def _unpin_args(self, spec: dict) -> List[bytes]:
        """Lock held.  Returns deferred-free ids now releasable."""
        release: List[bytes] = []
        raws = list(spec.get("arg_ids", []))
        if spec.get("args_ref") is not None:
            raws.append(spec["args_ref"])
        for raw in raws:
            n = self._pins.get(raw, 0) - 1
            if n <= 0:
                self._pins.pop(raw, None)
                if raw in self._deferred_frees:
                    self._deferred_frees.discard(raw)
                    release.append(raw)
            else:
                self._pins[raw] = n
        return release

    @staticmethod
    def _queue_frees(raws: List[bytes]):
        if not raws:
            return
        from . import object_ref as oref

        with oref._free_lock:
            oref._free_queue.extend(raws)
        oref.flush_wanted.set()

    # -- result registration (sharing with other processes) -------------------

    def _registration_entry(self, raw: bytes, desc: dict) -> dict:
        entry: Dict[str, Any] = {"object_id": raw}
        if desc.get("error") is not None:
            entry["error"] = desc["error"]
        elif desc.get("inline") is not None:
            entry["inline"] = desc["inline"]
        else:
            entry["size"] = desc["size"]
            entry["node_id"] = desc["node_id"]
        return entry

    def _register_result(self, raw: bytes, desc: dict):
        """Lock held.  Queue a head-side registration through the client's
        put batch — same-connection FIFO means it can never be overtaken by
        a later submission or free that references the object."""
        if raw in self._registered:
            return
        self._registered.add(raw)
        entry = self._registration_entry(raw, desc)
        with self._client._put_batch_lock:
            self._client._put_batch.append(entry)

    def ensure_shared(self, raw: bytes):
        """A ref to ``raw`` is crossing a process boundary: make sure the
        head can answer for it.  Inline/error direct results register
        lazily here (the common fire-and-get loop never pays for it);
        in-flight calls register at completion."""
        with self._lock:
            call = self._calls.get(raw)
            if call is not None and not call.done:
                call.share = True
                return
            desc = self._results.get(raw)
            if desc is not None:
                self._register_result(raw, desc)

    def ensure_args_shared(self, spec: dict):
        for raw in spec.get("arg_ids", []):
            self.ensure_shared(raw)

    # ======================================================================
    # direct actor calls
    # ======================================================================

    def prepare_actor_route(self, raw_actor_id: bytes):
        """Called at actor creation: registers interest so the ALIVE
        broadcast pre-dials the peer connection during creation dispatch
        (no first-call handshake cliff)."""
        if not self.actor_calls_enabled:
            return
        self._ensure_subscribed()
        with self._lock:
            self._routes.setdefault(raw_actor_id, _ActorRoute())

    def note_head_actor_call(self, raw_actor_id: bytes):
        if not self.actor_calls_enabled:
            return
        with self._lock:
            route = self._routes.setdefault(raw_actor_id, _ActorRoute())
            route.head_calls += 1

    def _on_actor_event(self, data):
        """Pubsub ``actor_events`` (runs on the head-connection RPC loop:
        never block here — dials happen on a throwaway thread)."""
        try:
            raw = bytes.fromhex(data["actor_id"])
        except (KeyError, ValueError):
            return
        state = data.get("state")
        if state in ("RESTARTING", "DEAD"):
            with self._lock:
                route = self._routes.get(raw)
                if route is None:
                    return
                if route.slot is not None:
                    self._retire_slot(route.slot)
                    route.slot = None
                if state == "DEAD":
                    # Terminal: drop the route entirely (a later call just
                    # re-resolves and learns the actor is dead) — routes
                    # must not accumulate across actor churn.
                    self._routes.pop(raw, None)
                flush = self._drain_route_pending(route)
            self._submit_via_head_offloop(flush)
            return
        if state == "ALIVE" and data.get("addr"):
            with self._lock:
                route = self._routes.get(raw)
                # Pre-warm only actors this client created/uses, and only
                # when no head-routed calls could still be ahead.
                if route is None or route.slot is not None \
                        or route.head_calls > 0 or route.dead:
                    return
            info = {k: data.get(k) for k in (
                "addr", "worker_id", "node_id", "session", "object_addr",
                "bulk_addr")}

            def _prewarm():
                slot = self._dial(info)
                if slot is None:
                    return
                with self._lock:
                    route2 = self._routes.get(raw)
                    if route2 is None or route2.slot is not None \
                            or route2.head_calls > 0 or route2.dead:
                        self._retired_conns.append(slot.conn)
                        return
                    route2.slot = slot

            threading.Thread(target=_prewarm, daemon=True,
                             name="peer-prewarm").start()

    def submit_actor_task(self, spec: dict) -> bool:
        """Route an actor call.  True = handled on the direct plane (sent
        or queued behind the route's window); False = caller must use the
        head path."""
        if not self.actor_calls_enabled:
            return False
        raw = spec["actor_id"]
        with self._lock:
            route = self._routes.setdefault(raw, _ActorRoute())
            if route.dead or route.unsupported:
                return False
            slot = route.slot
            if slot is not None and slot.dead:
                route.slot = slot = None
            if slot is None:
                attempt = time.monotonic() >= route.next_attempt
                if attempt:
                    route.next_attempt = time.monotonic() + 0.25
            if slot is not None:
                # Stage, don't send: submissions buffer in pure userspace
                # and flush once per burst (get()/wait()/size trigger) —
                # one peer-loop wakeup per burst, not per call.
                call = self._admit_call(spec, "actor", route=route)
                route.pending.append(call)
                drain = len(route.pending) >= 64
                handled = True
            else:
                handled = False
        if handled:
            if drain:
                self._drain_route(route)
            return True
        if not attempt:
            return False
        # Resolve outside the lock: one sync head round trip, then (on
        # success) every subsequent call to this actor skips the head.
        slot = self._resolve_actor(raw)
        if slot is None:
            return False
        with self._lock:
            route = self._routes.setdefault(raw, _ActorRoute())
            if route.slot is None and not route.dead:
                route.slot = slot
                route.head_calls = 0
            elif route.slot is not slot:
                self._retired_conns.append(slot.conn)
                slot = route.slot
            if slot is None or slot.dead:
                return False
            call = self._admit_call(spec, "actor", route=route)
            route.pending.append(call)
            drain = len(route.pending) >= 64
        if drain:
            self._drain_route(route)
        return True

    def _resolve_actor(self, raw: bytes) -> Optional[_Slot]:
        self._ensure_subscribed()
        try:
            reply = self._client.call("resolve_actor", {"actor_id": raw})
        except Exception:
            return None
        with self._lock:
            route = self._routes.setdefault(raw, _ActorRoute())
            if reply.get("dead"):
                route.dead = True
                return None
            if reply.get("unsupported"):
                route.unsupported = True
                return None
            if not reply.get("ready"):
                return None
            if reply.get("busy") and route.head_calls > 0:
                # Our earlier head-routed calls may still be queued or
                # running: switching now could reorder.  A client with no
                # prior head traffic has nothing to order against and may
                # dial a busy actor freely.
                return None
        return self._dial(reply)

    # ======================================================================
    # leased stateless tasks
    # ======================================================================

    @staticmethod
    def _lease_eligible(spec: dict) -> bool:
        if spec.get("strategy") is not None:
            return False
        res = spec.get("resources") or {}
        if int(res.get("GPU", 0) or 0) >= 1:
            return False  # whole-card grants need head-side GPU IDs
        return True

    @staticmethod
    def _shape(spec: dict) -> Tuple:
        res = spec.get("resources") or {}
        return tuple(sorted(res.items()))

    def submit_task(self, spec: dict) -> bool:
        """Route a stateless task via a leased slot.  True = handled
        (sent or queued); False = head path (and possibly a lease request
        fired in the background for next time)."""
        if not self.leases_enabled or not self._lease_eligible(spec):
            return False
        shape = self._shape(spec)
        with self._lock:
            pool = self._pools.get(shape)
            if pool is None:
                pool = self._pools[shape] = _LeasePool(
                    dict(spec.get("resources") or {}))
            live = [s for s in pool.slots if not s.dead and not s.revoked]
            handled = True
            drain = False
            if not live:
                self._maybe_request_slots_locked(pool)
                if not pool.requesting:
                    # No slots and no grant coming (recent denial backoff
                    # or request failure): head path.
                    handled = False
                else:
                    # A grant is in flight: queue rather than flood the
                    # head — fallback submissions would queue head-side
                    # and trip the lease-starvation preemption against the
                    # very lease we just requested.  Bounded: grant-zero
                    # and the stale-queue timer both flush this to the
                    # head.
                    call = self._admit_call(spec, "task", pool=pool)
                    pool.pending.append((call, time.monotonic()))
            else:
                # Stage, don't send (see submit_actor_task): the flush
                # points (get/wait/size trigger/maintain) drain the queue
                # through _drain_pool's window + long-runner-aware pick.
                call = self._admit_call(spec, "task", pool=pool)
                pool.pending.append((call, time.monotonic()))
                drain = len(pool.pending) >= 64
        # The request fired above may have staged its reply callback.
        self._after_lock()
        if drain:
            self._drain_pool(pool)
        return handled

    def _pick_slot(self, live: List[_Slot]) -> Optional[_Slot]:
        """Lock held.  Least-loaded slot below the window; ties prefer the
        slot that completed work most recently (a stale last_progress marks
        a probable long-runner that should not collect more work)."""
        best = min(live, key=lambda s: (s.in_flight, -s.last_progress))
        return best if best.in_flight < self._window else None

    def _maybe_request_slots_locked(self, pool: _LeasePool):
        now = time.monotonic()
        if pool.requesting or now < pool.next_request:
            return
        want = self._lease_max - len(
            [s for s in pool.slots if not s.dead and not s.revoked])
        if want <= 0:
            return
        pool.requesting = True
        pool.request_at = now  # maintain() unwedges a reply lost in flight
        try:
            fut = self._client.rpc.call_async(
                "lease_request",
                {"resources": pool.resources, "count": want})
        except Exception:
            pool.requesting = False
            pool.next_request = now + 0.5
            return
        self._staged_callbacks.append(
            (fut, lambda f: self._on_lease_reply(pool, f)))

    def _on_lease_reply(self, pool: _LeasePool, fut):
        """Head-connection loop thread: record the grant, dial the granted
        workers on a throwaway thread (dials block), then drain pending."""
        try:
            reply = fut.result()
            slots = reply.get("slots", [])
        except BaseException:
            slots = []
        if not slots:
            with self._lock:
                pool.requesting = False
                pool.next_request = time.monotonic() + 0.5
                live = [s for s in pool.slots
                        if not s.dead and not s.revoked]
                # Grant-zero with NO slots at all: the head (which can
                # spawn and place globally) takes the backlog.  With live
                # slots the queue stays — the denial backoff switches
                # _drain_pool into deep pipelining over what we hold.
                flush = [] if live else [c for c, _ in pool.pending]
                if not live:
                    pool.pending.clear()
            # Reader-thread context: re-route and drain off-loop.
            self._submit_via_head_offloop(flush)
            if live:
                threading.Thread(target=self._drain_pool, args=(pool,),
                                 daemon=True, name="lease-drain").start()
            return

        def _connect():
            dialed = []
            for info in slots:
                slot = self._dial(info, lease_id=info["lease_id"])
                if slot is not None:
                    dialed.append(slot)
            failed = [info["lease_id"] for info in slots] if not dialed \
                else [info["lease_id"] for info in slots
                      if info["lease_id"] not in
                      {s.lease_id for s in dialed}]
            if failed:
                try:
                    self._client.call_batched(
                        "lease_return", {"lease_ids": failed})
                except Exception:
                    pass
            with self._lock:
                pool.requesting = False
                if not dialed:
                    pool.next_request = time.monotonic() + 0.5
                pool.slots.extend(dialed)
            self._drain_pool(pool)

        threading.Thread(target=_connect, daemon=True,
                         name="lease-dial").start()

    def _drain_pool(self, pool: _LeasePool):
        """Send staged specs.  Dispatch policy: idle slots first (freshest
        completion wins ties — probable long-runners collect nothing while
        peers are free); when every slot is busy, GROW the pool before
        stacking depth; deep pipelining only once growth is exhausted (at
        the slot cap or inside a denial backoff) — then burst tails fill
        the windows instead of trickling one send per completion."""
        while True:
            flush: List[_DirectCall] = []
            with self._lock:
                if not pool.pending:
                    break
                live = [s for s in pool.slots
                        if not s.dead and not s.revoked]
                now = time.monotonic()
                if not live:
                    if pool.requesting:
                        break  # grant in flight: hold the queue
                    if now >= pool.next_request:
                        self._maybe_request_slots_locked(pool)
                        if pool.requesting:
                            break
                    # No slots and no grant coming: the head path is the
                    # only way forward.
                    flush = [c for c, _ in pool.pending]
                    pool.pending.clear()
                else:
                    idle = [s for s in live if s.in_flight == 0]
                    if idle:
                        slot = min(idle, key=lambda s: -s.last_progress)
                    elif pool.requesting:
                        break  # more slots coming: don't stack yet
                    elif len(live) < self._lease_max \
                            and now >= pool.next_request:
                        self._maybe_request_slots_locked(pool)
                        break
                    else:
                        slot = self._pick_slot(live)
                        if slot is None:
                            break  # every window full: completions drain
                    call, _ = pool.pending.popleft()
                    self._send_locked(call, slot)
                    continue
            # Failed sends are EARLIER calls than this flush: re-route
            # them first so per-submitter order survives the degrade.
            self._after_lock()
            self._submit_calls_via_head(flush)
            break
        self._after_lock()

    def flush_pending(self):
        """Drain every staged submission toward its peer connection — the
        peer-plane analog of the client's submit-batch flush, invoked from
        the same rendezvous points (get/wait/sync calls/the background
        flusher)."""
        with self._lock:
            routes = [r for r in self._routes.values() if r.pending]
            pools = [p for p in self._pools.values() if p.pending]
        for route in routes:
            self._drain_route(route)
        for pool in pools:
            self._drain_pool(pool)

    def _on_lease_revoke(self, body):
        """Head push (drain/TTL/preemption/worker death): stop routing to
        the slot; the lease returns once in-flight work drains, so nothing
        in flight is orphaned."""
        lease_id = body.get("lease_id")
        flush: List[_DirectCall] = []
        returns: List[bytes] = []
        with self._lock:
            for pool in self._pools.values():
                for slot in pool.slots:
                    if slot.lease_id == lease_id and not slot.revoked:
                        slot.revoked = True
                        slot.last_active = time.monotonic()
                        if slot.in_flight == 0:
                            self._retire_slot(slot)
                            returns.append(lease_id)
                        if not any(s for s in pool.slots
                                   if not s.dead and not s.revoked):
                            flush = [c for c, _ in pool.pending]
                            pool.pending.clear()
                pool.slots = [s for s in pool.slots if not s.dead]
        # Reader-thread context (head push): the lease return and any
        # head re-routing must not risk blocking the only thread that can
        # read their responses.
        if returns:
            def _return():
                try:
                    self._client.call_batched("lease_return",
                                              {"lease_ids": returns})
                except Exception:
                    pass

            threading.Thread(target=_return, daemon=True,
                             name="lease-return").start()
        self._submit_via_head_offloop(flush)

    # ======================================================================
    # send / complete / fall back
    # ======================================================================

    def _admit_call(self, spec: dict, kind: str,
                    route: Optional[_ActorRoute] = None,
                    pool: Optional[_LeasePool] = None) -> _DirectCall:
        """Lock held.  Register bookkeeping for a call the dataplane now
        owns (whether it sends immediately or queues)."""
        call = _DirectCall(spec, kind)
        call.route = route
        call.pool = pool
        if spec.get("deadline_s") is not None:
            # Caller-supplied budget (absolute from admission): survives
            # re-routes — a retried call can't exceed the original budget.
            call.deadline_at = time.monotonic() + float(spec["deadline_s"])
        for raw in spec.get("return_ids", []):
            self._calls[raw] = call
        self._task_calls[spec["task_id"]] = call
        self._pin_args(spec)
        return call

    def _send_locked(self, call: _DirectCall, slot: _Slot):
        """Lock held.  Fire the peer RPC (non-blocking)."""
        spec = call.spec
        call.slot = slot
        slot.in_flight += 1
        now = time.monotonic()
        slot.last_active = now
        call.sent_at = now  # watchdog baseline for the in-flight budget
        if spec.get("num_returns") == "streaming":
            self._stream_routes[spec["task_id"]] = slot
        if slot.conn.closed:
            self._send_failed_locked(call)
            return
        try:
            fut = slot.conn.call_async(
                "peer_submit", {"spec": spec, "worker_id": slot.worker_id})
        except Exception:
            self._send_failed_locked(call)
            return
        call.fut = fut
        if call.kind == "actor":
            self._count_direct()
        else:
            self._count_leased()
        # Staged, not attached: an already-failed future would run
        # _finalize inline under the lock we are holding (_after_lock
        # attaches once the lock is released).
        self._staged_callbacks.append(
            (fut, lambda f: self._finalize(call, f)))

    def _submit_calls_via_head(self, calls: List[_DirectCall]):
        """Re-route calls to the head path, in order.  Never under the
        lock (call_batched flushes may fire RPCs)."""
        for call in calls:
            self._fallback_to_head(call)

    def _fallback_to_head(self, call: _DirectCall,
                          decrement_retries: bool = False):
        spec = call.spec
        with self._lock:
            if call.finalized:
                return
            call.finalized = True
            for raw in spec.get("return_ids", []):
                self._calls.pop(raw, None)
            self._task_calls.pop(spec["task_id"], None)
            self._stream_routes.pop(spec["task_id"], None)
            release = self._unpin_args(spec)
        spec = {k: v for k, v in spec.items() if not k.startswith("_")}
        if call.deadline_at:
            # Remaining budget rides the spec: the head-path retry of this
            # call inherits what's left, never a fresh window.
            spec["deadline_s"] = max(
                0.0, call.deadline_at - time.monotonic())
        if decrement_retries:
            retries = spec.get("max_retries", 0)
            if retries > 0:
                spec["max_retries"] = retries - 1
        injected = spec.get("trace_ctx")
        if injected is not None:
            # The degrade is part of the request's story: a zero-length
            # marker span makes the peer->head re-route visible in the
            # trace (buffered emission — no head RPC from this path).
            from ..util import tracing

            now = time.time()
            tracing.emit_span(tracing.make_span(
                injected, f"reroute:{spec.get('name', 'task')}", now, now,
                to="head", retry_charged=bool(decrement_retries)))
        method = "submit_actor_task" if call.kind == "actor" \
            else "submit_task"
        try:
            if call.kind == "actor":
                self.note_head_actor_call(spec["actor_id"])
            self._client.call_batched(method, spec)
        except Exception:
            self._seal_error_locked_entry(
                call, serialization.pack(exceptions.WorkerCrashedError(
                    "direct call failed and head fallback submission "
                    "failed")))
        with self._lock:
            call.done = True
            ev = call.event
        if ev is not None:
            ev.set()
        self._queue_frees(release)

    def _seal_error_locked_entry(self, call: _DirectCall, error_blob: bytes):
        with self._lock:
            self._seal_result(call, uniform={"error": error_blob})

    def _seal_result(self, call: _DirectCall,
                     descs: Optional[Dict[bytes, dict]] = None,
                     uniform: Optional[dict] = None):
        """Lock held.  Store result descriptors for every return id:
        ``descs`` maps raw oid -> desc, ``uniform`` applies one desc (an
        error, typically) to every return."""
        spec = call.spec
        for raw in spec.get("return_ids", []):
            desc = uniform if descs is None else descs.get(raw, uniform)
            if desc is None:
                continue
            self._results[raw] = desc
            self._calls.pop(raw, None)
            if call.share or desc.get("size") is not None:
                # Large results register eagerly: the head must adopt the
                # worker-created segment for eviction/cleanup accounting,
                # and the creator's eventual free must find a record.
                self._register_result(raw, desc)
        self._task_calls.pop(spec["task_id"], None)

    def _send_failed_locked(self, call: _DirectCall):
        """Lock held.  The spec never left this process (dead connection at
        send time): retire the slot and park the call for head re-routing —
        the caller flushes ``self._failed_sends`` after releasing the
        lock (re-routing fires RPCs and must not run under it)."""
        slot = call.slot
        if slot is not None:
            slot.in_flight = max(0, slot.in_flight - 1)
            if not slot.dead:
                self._retire_slot(slot)
                if call.route is not None and call.route.slot is slot:
                    call.route.slot = None
        call.slot = None
        self._failed_sends.append(call)

    def _flush_failed_sends(self):
        with self._lock:
            failed, self._failed_sends = self._failed_sends, []
        self._submit_calls_via_head(failed)

    def _after_lock(self):
        """Run the work staged while the lock was held: attach completion
        callbacks (inline-safe now — the lock is released) and re-route
        failed sends BEFORE anything queued behind them, preserving
        per-submitter order."""
        # The two bare reads are deliberate double-checked pre-checks: the
        # hot per-completion path must not pay a lock round trip when both
        # lists are empty; a stale non-empty read just takes the lock and
        # finds nothing, a stale empty read is flushed by the next caller.
        if self._staged_callbacks:  # rt-unguarded: double-checked pre-check
            with self._lock:
                cbs, self._staged_callbacks = self._staged_callbacks, []
            for fut, cb in cbs:
                fut.add_done_callback(cb)
        if self._failed_sends:  # rt-unguarded: double-checked pre-check
            self._flush_failed_sends()

    def _submit_via_head_offloop(self, calls: List[_DirectCall]):
        """Re-route via the head from a PUSH handler: those run on the
        head-connection reader thread, and call_batched's backpressure can
        block on futures only that reader can resolve — hand the work to a
        throwaway thread instead."""
        if not calls:
            return
        threading.Thread(target=self._submit_calls_via_head, args=(calls,),
                         daemon=True, name="peer-fallback").start()

    def _finalize(self, call: _DirectCall, fut):
        """Completion callback — runs on the peer connection's RPC loop
        thread.  Must never close that connection (joining your own loop
        thread deadlocks): dead slots are retired and closed by
        maintain()."""
        reply = None
        try:
            reply = fut.result()
            failure = None
        except BaseException as e:  # noqa: BLE001 — conn-level failure
            failure = e
        release: List[bytes] = []
        fallback = False
        ev: Optional[threading.Event] = None
        lease_return: Optional[bytes] = None
        drain_route: Optional[_ActorRoute] = None
        drain_pool: Optional[_LeasePool] = None
        flush_pending: List[_DirectCall] = []
        with self._lock:
            if call.finalized:
                return
            slot = call.slot
            if slot is not None:
                slot.in_flight = max(0, slot.in_flight - 1)
            if failure is not None:
                # Connection-level failure: the task may or may not have
                # executed.  Head-path parity for worker death: retry when
                # the spec has retries left, else WorkerCrashedError.
                if slot is not None and not slot.dead:
                    self._retire_slot(slot)
                    if call.route is not None and call.route.slot is slot:
                        call.route.slot = None
                if call.spec.get("max_retries", 0) != 0:
                    fallback = True
                else:
                    call.finalized = True
                    err = serialization.pack(exceptions.WorkerCrashedError(
                        "worker died while running direct task "
                        f"{call.spec.get('name', '')!r}"))
                    self._seal_result(call, uniform={"error": err})
                    release = self._unpin_args(call.spec)
                # Last in-flight call off a dead slot: re-route whatever
                # was still queued behind it.
                if slot is not None and slot.in_flight == 0:
                    if call.route is not None:
                        flush_pending = self._drain_route_pending(call.route)
                    if call.pool is not None:
                        call.pool.slots = [
                            s for s in call.pool.slots if not s.dead]
                        if not any(s for s in call.pool.slots
                                   if not s.revoked):
                            flush_pending = [
                                c for c, _ in call.pool.pending]
                            call.pool.pending.clear()
            elif reply.get("stale"):
                # Refused before execution — always safe to re-route; the
                # route must re-resolve (actor restarted elsewhere).
                if slot is not None and call.route is not None \
                        and call.route.slot is slot:
                    self._retire_slot(slot)
                    call.route.slot = None
                    flush_pending = self._drain_route_pending(call.route)
                fallback = True
            elif reply.get("error") is not None and reply.get("retryable") \
                    and call.spec.get("max_retries", 0) != 0:
                # Application-level retryable error (retry_exceptions):
                # hand the remaining budget to the head path, which owns
                # retry scheduling.
                fallback = True
                failure = True  # decrement the budget on re-route
                if slot is not None:
                    now = time.monotonic()
                    slot.last_progress = now
                    slot.last_active = now
            else:
                call.finalized = True
                if slot is not None:
                    now = time.monotonic()
                    slot.last_progress = now
                    slot.last_active = now
                    if call.sent_at:
                        # Route-latency EWMA: completions that keep taking
                        # a large fraction of the deadline budget mark a
                        # slow-but-alive route — quarantine it before the
                        # watchdog has to (the other gray-failure net).
                        dt = now - call.sent_at
                        slot.lat_ewma = dt if slot.lat_ewma == 0.0 \
                            else 0.8 * slot.lat_ewma + 0.2 * dt
                        if slot.lat_ewma > 0.5 * self._peer_deadline \
                                and not slot.dead \
                                and slot.addr not in self._quarantine:
                            self._quarantine_route_locked(slot, call.route)
                    if slot.revoked and slot.in_flight == 0 \
                            and slot.lease_id is not None:
                        self._retire_slot(slot)
                        lease_return = slot.lease_id
                self._seal_reply(call, reply)
                release = self._unpin_args(call.spec)
                if call.spec.get("args_ref") is not None:
                    # Head-path tasks get their spilled-args object freed
                    # at head-side finalization; direct tasks never reach
                    # it, so the submitter drops the creation ref here.
                    release.append(call.spec["args_ref"])
                # Only schedule queue drains that have work (the per-
                # completion fast path must not pay lock round-trips for
                # empty queues).
                if call.route is not None and call.route.pending:
                    drain_route = call.route
                if call.pool is not None and call.pool.pending:
                    drain_pool = call.pool
            if not fallback:
                call.done = True
                ev = call.event
        if fallback:
            self._fallback_to_head(call,
                                   decrement_retries=failure is not None)
        elif ev is not None:
            ev.set()
        self._queue_frees(release)
        if lease_return is not None:
            try:
                self._client.call_batched(
                    "lease_return", {"lease_ids": [lease_return]})
            except Exception:
                pass
        self._after_lock()  # earlier failed sends re-route first
        if flush_pending:
            self._submit_calls_via_head(flush_pending)
        if drain_route is not None:
            self._drain_route(drain_route)
        if drain_pool is not None:
            self._drain_pool(drain_pool)

    def _seal_reply(self, call: _DirectCall, reply: dict):
        """Lock held.  Translate a peer_submit reply into local result
        descriptors (the submitter-side seal)."""
        slot = call.slot
        if reply.get("error") is not None:
            self._seal_result(call, uniform={"error": reply["error"]})
            return
        descs: Dict[bytes, dict] = {}
        for ret in reply.get("returns", []):
            raw = ret["object_id"]
            if ret.get("inline") is not None:
                descs[raw] = {"inline": ret["inline"]}
            else:
                descs[raw] = {
                    "size": ret["size"],
                    "session": reply.get("session"),
                    "node_id": reply.get("node_id"),
                    "addr": slot.object_addr if slot else None,
                    "bulk_addr": slot.bulk_addr if slot else None,
                }
        if call.spec.get("num_returns") == "streaming":
            # Stream bookkeeping lives in _stream_routes; the placeholder
            # return seals empty (matching the head path, where it exists
            # only to carry errors).
            for raw in call.spec.get("return_ids", []):
                descs.setdefault(
                    raw, {"inline": serialization.pack(None)})
        self._seal_result(call, descs=descs)

    def _drain_route_pending(self, route: _ActorRoute) -> List[_DirectCall]:
        """Lock held.  Detach a route's queued calls for head re-routing."""
        flush = list(route.pending)
        route.pending.clear()
        return flush

    def _drain_route(self, route: _ActorRoute):
        flush: List[_DirectCall] = []
        while True:
            with self._lock:
                if not route.pending:
                    break
                slot = route.slot
                if slot is None or slot.dead:
                    # Nothing in flight to order against: staged calls can
                    # only proceed via the head.  (With calls still in
                    # flight on a dying slot, their completion callbacks
                    # own the re-route, preserving FIFO.)
                    if slot is None or slot.in_flight == 0:
                        flush = self._drain_route_pending(route)
                    break
                if slot.in_flight >= ACTOR_WINDOW:
                    break
                call = route.pending.popleft()
                self._send_locked(call, slot)
        self._after_lock()  # earlier failed sends re-route before `flush`
        if flush:
            self._submit_calls_via_head(flush)

    # ======================================================================
    # get()/wait() integration
    # ======================================================================

    def await_calls(self, raws: List[bytes], timeout: float):
        """Block until every listed ref that is an in-flight direct call
        reaches a terminal local state (result desc or head fallback)."""
        deadline = None if timeout < 0 else time.monotonic() + timeout
        for raw in raws:
            with self._lock:
                call = self._calls.get(raw)
                if call is None or call.done:
                    continue
                ev = call.event
                if ev is None:
                    ev = call.event = threading.Event()
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if (remaining is not None and remaining <= 0) \
                    or not ev.wait(remaining):
                raise exceptions.GetTimeoutError(
                    f"ray_tpu_torch.get timed out after {timeout}s on a "
                    "direct-call result")

    def result_desc(self, raw: bytes) -> Optional[dict]:
        with self._lock:
            return self._results.get(raw)

    def wait_split(self, raws: List[bytes]):
        """For wait(): (locally_ready, pending_events, head_raws)."""
        ready: Set[bytes] = set()
        events: List[threading.Event] = []
        head: List[bytes] = []
        with self._lock:
            for raw in raws:
                if raw in self._results:
                    ready.add(raw)
                    continue
                call = self._calls.get(raw)
                if call is not None and not call.done:
                    ev = call.event
                    if ev is None:
                        ev = call.event = threading.Event()
                    events.append(ev)
                    continue
                head.append(raw)
        return ready, events, head

    # -- streaming -------------------------------------------------------------

    def next_stream_item(self, task_id: bytes, index: int) -> Optional[dict]:
        """Route an ObjectRefGenerator pull for a direct streaming task.
        None = not a direct stream (caller uses the head path)."""
        while True:
            # The spec may still be staged client-side: flush, then wait
            # for it to be either sent (peer route exists) or re-routed to
            # the head (the call disappears from the direct tables).
            self.flush_pending()
            with self._lock:
                slot = self._stream_routes.get(task_id)
                call = self._task_calls.get(task_id)
            if slot is not None:
                break
            if call is None:
                return None
            time.sleep(0.005)
        if slot.dead or slot.conn.closed:
            with self._lock:
                self._stream_routes.pop(task_id, None)
            return {"error": serialization.pack(exceptions.WorkerCrashedError(
                "worker died mid-stream (direct streaming task)"))}
        # Bounded, retried pull (was timeout=1e9, which a mid-stream
        # partition turned into a forever-hang): the pull is idempotent —
        # indexed reads re-issue safely — so each attempt gets one deadline
        # budget; a route that stays dark past the retry budget fails
        # typed and is quarantined.
        reply = None
        attempts = 0
        while True:
            try:
                reply = slot.conn.call(
                    "peer_next_stream_item",
                    {"task_id": task_id, "index": index,
                     "worker_id": slot.worker_id},
                    timeout=self._peer_deadline,
                )
                break
            except Exception:
                attempts += 1
                from . import deadline as _dl

                _dl.count_retry("stream")
                if slot.conn.closed or attempts >= 3:
                    with self._lock:
                        self._stream_routes.pop(task_id, None)
                        if not slot.dead:
                            self._quarantine_route_locked(slot, None)
                    return {"error": serialization.pack(
                        exceptions.WorkerCrashedError(
                            "worker unreachable mid-stream (direct "
                            "streaming task)"))}
        if reply.get("stale"):
            with self._lock:
                self._stream_routes.pop(task_id, None)
            return {"error": serialization.pack(exceptions.WorkerCrashedError(
                "stale stream route (worker restarted mid-stream)"))}
        if reply.get("done"):
            with self._lock:
                self._stream_routes.pop(task_id, None)
            return {"done": True}
        if reply.get("error") is not None:
            with self._lock:
                self._stream_routes.pop(task_id, None)
            return {"error": reply["error"]}
        item = reply["item"]
        raw = item["object_id"]
        with self._lock:
            if item.get("inline") is not None:
                self._results[raw] = {"inline": item["inline"]}
            else:
                desc = {
                    "size": item["size"],
                    "session": slot.session,
                    "node_id": slot.node_id,
                    "addr": slot.object_addr,
                    "bulk_addr": slot.bulk_addr,
                }
                self._results[raw] = desc
                self._register_result(raw, desc)
        return {"object_id": raw}

    # -- cancellation ----------------------------------------------------------

    def _seal_call_error(self, call: _DirectCall, exc: BaseException):
        """Seal a call locally with a typed error (deadline expiry; the
        local analog of cancel_task's queued-call seal).  Never under the
        lock on entry."""
        err = serialization.pack(exc)
        with self._lock:
            if call.finalized:
                return
            call.finalized = True
            self._seal_result(call, uniform={"error": err})
            release = self._unpin_args(call.spec)
            self._stream_routes.pop(call.spec["task_id"], None)
            call.done = True
            ev = call.event
        if ev is not None:
            ev.set()
        self._queue_frees(release)

    def cancel_task(self, task_raw: bytes, force: bool) -> bool:
        """True when the task was a direct call and the cancel was routed
        peer-side (or resolved locally)."""
        with self._lock:
            call = self._task_calls.get(task_raw)
            if call is None:
                return False
            slot = call.slot
        if slot is None:
            # Still queued client-side: cancel locally.
            err = serialization.pack(
                exceptions.TaskCancelledError(task_raw.hex()))
            with self._lock:
                if call.finalized:
                    return True
                call.finalized = True
                if call.route is not None and call in call.route.pending:
                    call.route.pending.remove(call)
                if call.pool is not None:
                    call.pool.pending = deque(
                        (c, t) for c, t in call.pool.pending if c is not call)
                self._seal_result(call, uniform={"error": err})
                release = self._unpin_args(call.spec)
                call.done = True
                ev = call.event
            if ev is not None:
                ev.set()
            self._queue_frees(release)
            return True
        try:
            slot.conn.call_async(
                "peer_cancel", {"task_id": task_raw, "force": force})
        except Exception:
            pass
        return True

    # ======================================================================
    # frees / maintenance / shutdown
    # ======================================================================

    def intercept_frees(self, raws: List[bytes]) -> List[bytes]:
        """Filter a free batch: results drop locally; args pinned by an
        in-flight direct call defer until the call completes."""
        out: List[bytes] = []
        with self._lock:
            for raw in raws:
                self._results.pop(raw, None)
                if self._pins.get(raw, 0) > 0:
                    self._deferred_frees.add(raw)
                else:
                    self._registered.discard(raw)
                    out.append(raw)
        return out

    def drop_results(self, raws: List[bytes]):
        """Head-initiated free broadcast: drop cached descriptors."""
        with self._lock:
            for raw in raws:
                self._results.pop(raw, None)
                self._registered.discard(raw)

    def on_head_reconnected(self):
        """The client re-registered with a (possibly restarted) head: every
        held lease id belongs to the OLD head incarnation and means nothing
        to the new one — drop the slots and let queued specs re-route (the
        head path re-primes lease acquisition on the next burst).  Cached
        direct-actor routes are kept: the hosting workers survived the head
        outage and their peer servers kept serving, which is exactly why
        direct calls see zero failures across a head restart.  Also clears
        the head-registration memo — the restarted head's directory starts
        empty, so results that cross a process boundary later must
        re-register.

        Runs from the reconnect path (user thread / free-flusher / owner
        reconnect thread) — never on an RPC reader thread, so the head
        re-submissions below are safe to fire inline."""
        flush: List[_DirectCall] = []
        with self._lock:
            self._registered.clear()
            for pool in self._pools.values():
                keep: List[_Slot] = []
                for slot in pool.slots:
                    if slot.dead:
                        continue
                    if slot.in_flight == 0:
                        self._retire_slot(slot)
                    else:
                        # Specs already pipelined to a live worker drain
                        # normally (their completions come back over the
                        # peer connection); `revoked` just stops new routing
                        # and the last completion retires the slot.
                        slot.revoked = True
                        keep.append(slot)
                pool.slots = keep
                pool.requesting = False
                pool.next_request = 0.0
                flush.extend(c for c, _ in pool.pending)
                pool.pending.clear()
        self._submit_calls_via_head(flush)

    def maintain(self):
        """Background upkeep, called from the client's flusher loop:
        renew held leases, return idle ones, flush stale client-side
        queues to the head, and close retired connections."""
        self.flush_pending()
        now = time.monotonic()
        renew: List[bytes] = []
        returns: List[bytes] = []
        flush: List[_DirectCall] = []
        overdue: List[_DirectCall] = []
        expired: List[_DirectCall] = []
        with self._lock:
            conns, self._retired_conns = self._retired_conns, []
            # Gray-failure watchdog: an in-flight direct call past the
            # deadline budget means its route is partitioned or wedged —
            # the dial succeeded, so peer_connect_timeout_s can't see it
            # (a one-way partition that drops only replies looks exactly
            # like this).  Quarantine the route; past the caller's own
            # budget the call seals DeadlineExceededError, otherwise it
            # re-routes via the head — worker-side dedup makes the
            # redelivery safe even when the peer DID execute and only the
            # reply was lost, so the retry budget is not charged.
            for call in list(self._task_calls.values()):
                if call.finalized or call.slot is None or not call.sent_at:
                    continue
                if call.deadline_at and now >= call.deadline_at:
                    if not call.slot.dead:
                        self._quarantine_route_locked(call.slot, call.route)
                    expired.append(call)
                elif now - call.sent_at > self._peer_deadline:
                    if not call.slot.dead:
                        self._quarantine_route_locked(call.slot, call.route)
                    overdue.append(call)
            # Lift bookkeeping: a quarantine whose lift time passed long
            # ago with no dial re-probing it (route abandoned) is pruned
            # so the table can't grow across peer churn.
            for addr in [a for a, t in self._quarantine.items()
                         if now - t > 60.0]:
                self._quarantine.pop(addr, None)
            # Prune terminal actor routes (dead, nothing queued): route
            # state must not accumulate across actor churn in long-lived
            # drivers.
            for raw in [r for r, route in self._routes.items()
                        if route.dead and not route.pending]:
                self._routes.pop(raw, None)
            for pool in self._pools.values():
                if pool.requesting and pool.request_at \
                        and now - pool.request_at > self._lease_reply_s:
                    # The grant reply never arrived (lost on the wire, or
                    # the head restarted mid-request): release the latch
                    # so the pool can re-request instead of starving.
                    pool.requesting = False
                    pool.next_request = now + 0.5
                for slot in list(pool.slots):
                    if slot.dead:
                        pool.slots.remove(slot)
                        continue
                    if slot.lease_id is None or slot.revoked:
                        continue
                    if slot.in_flight == 0 \
                            and now - slot.last_active > self._idle_return_s:
                        self._retire_slot(slot)
                        pool.slots.remove(slot)
                        returns.append(slot.lease_id)
                    else:
                        renew.append(slot.lease_id)
                # Stale staging: when every live slot has been stuck past
                # the window (long-runners) and no grant is in flight, the
                # head — which can spawn and place globally — takes the
                # backlog.  While slots are completing work, the queue is
                # draining on its own and stays put.
                if pool.pending and not pool.requesting:
                    live = [s for s in pool.slots
                            if not s.dead and not s.revoked]
                    progressing = any(
                        now - s.last_progress < PENDING_STALE_S
                        for s in live)
                    if not progressing:
                        while pool.pending and \
                                now - pool.pending[0][1] > PENDING_STALE_S:
                            call, _ = pool.pending.popleft()
                            flush.append(call)
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass
        try:
            if returns:
                self._client.call_batched("lease_return",
                                          {"lease_ids": returns})
            if renew:
                self._client.call_batched("lease_renew",
                                          {"lease_ids": renew})
        except Exception:
            pass
        if expired or overdue:
            from . import deadline as _dl

            for call in expired:
                _dl.count_deadline_exceeded("peer")
                self._seal_call_error(call, exceptions.DeadlineExceededError(
                    f"direct call {call.spec.get('name', '')!r} exceeded "
                    "its deadline budget"))
            for call in overdue:
                _dl.count_retry("peer")
                # No retry charge: the redelivery dedups worker-side.
                self._fallback_to_head(call, decrement_retries=False)
        self._submit_calls_via_head(flush)

    def close(self):
        self.flush_pending()
        self._after_lock()
        returns: List[bytes] = []
        conns: List[RpcClient] = []
        with self._lock:
            for pool in self._pools.values():
                for slot in pool.slots:
                    if slot.lease_id is not None and not slot.dead:
                        returns.append(slot.lease_id)
                    if slot.conn is not None:
                        conns.append(slot.conn)
                    slot.dead = True
                pool.slots = []
            for route in self._routes.values():
                if route.slot is not None and route.slot.conn is not None:
                    conns.append(route.slot.conn)
                    route.slot.dead = True
                    route.slot = None
            conns.extend(self._retired_conns)
            self._retired_conns = []
        if returns:
            try:
                self._client.rpc.call(
                    "lease_return", {"lease_ids": returns}, timeout=2.0)
            except Exception:
                pass
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass
        with self._peer_loop_lock:
            loop, self._peer_loop = self._peer_loop, None
        if loop is not None:
            import asyncio

            def _stop():
                async def _later():
                    # One breath for the connections' teardown tasks to
                    # unwind before the loop dies (else asyncio logs
                    # destroyed-pending-task warnings at shutdown).
                    await asyncio.sleep(0.05)
                    loop.stop()

                asyncio.ensure_future(_later())

            try:
                loop.call_soon_threadsafe(_stop)
            except RuntimeError:
                pass


def _split(addr: str):
    host, port = addr.rsplit(":", 1)
    return host, int(port)
