"""Control plane: object directory, task scheduling/dispatch, actor lifecycle,
placement groups, KV store, pubsub, worker-pool management.

Role-equivalent to the reference's GCS server + raylet combination
(reference: src/ray/gcs/gcs_server/gcs_server.h:78 — actor/node/job/PG/KV/
pubsub services; src/ray/raylet/node_manager.h:119 — leasing + dispatch;
src/ray/core_worker/task_manager.h:208 — retries + lineage).  Design choice
vs the reference: ownership of the object directory and the task table is
centralized in this process rather than distributed across core workers —
a deliberately simpler protocol (single writer, no borrowing dance) that a
TPU cluster's scale profile (hundreds of hosts, gang-scheduled SPMD jobs)
tolerates well; scale-out path is sharding the table, not distributing
ownership.

All state is owned by one asyncio loop — handlers never block.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Set

from . import serialization
from ..exceptions import ActorDiedError, TaskCancelledError, WorkerCrashedError
from .config import Config, tmp_root
from .ids import ActorID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID
from .rpc import Connection, RpcServer
from .scheduler import ClusterScheduler, SchedulingStrategy
from ..devtools.locks import guarded, make_lock

logger = logging.getLogger(__name__)

# Worker / actor / task states (subset of the reference FSMs:
# gcs_actor_manager.h actor FSM, worker_pool.h worker states).
STARTING, IDLE, LEASED, ACTOR, DEAD = "starting", "idle", "leased", "actor", "dead"
# A worker that ran a GPU-granted task: told to exit, never re-picked
# (the process keeps its CUDA context on the cards until it dies).
RETIRING = "retiring"
# BLOCKED: leased worker parked in a nested get/wait; its task's resources
# are released so the pool can run other work (see h_task_blocked).
BLOCKED = "blocked"
# DIRECT: worker leased out to a client for peer-to-peer task submission —
# the client pushes specs straight to the worker's peer server and the head
# never sees the per-call traffic (reference: raylet worker leasing +
# core-worker direct task push).  Excluded from head dispatch until the
# lease returns.
DIRECT = "direct"
PENDING, RUNNING, FINISHED, FAILED = "PENDING", "RUNNING", "FINISHED", "FAILED"


def _strategy_from_wire(d: Optional[dict]) -> SchedulingStrategy:
    if not d:
        return SchedulingStrategy.default()
    return SchedulingStrategy(
        kind=d.get("kind", "default"),
        node_id=NodeID(d["node_id"]) if d.get("node_id") else None,
        soft=d.get("soft", False),
        pg_id=PlacementGroupID(d["pg_id"]) if d.get("pg_id") else None,
        bundle_index=d.get("bundle_index", -1),
    )


class WorkerState:
    def __init__(self, worker_id: WorkerID, node_id: NodeID, conn: Connection, pid: int):
        self.worker_id = worker_id
        self.node_id = node_id
        self.conn = conn
        self.pid = pid
        # Workers start in STARTING and flip to IDLE on the worker_ready
        # handshake — dispatching before the worker has installed its push
        # handlers would drop the task push.
        self.state = STARTING
        self.inflight: Set[TaskID] = set()  # tasks currently on this worker
        self.actor_id: Optional[ActorID] = None
        self.last_seen = time.monotonic()  # last dispatch/completion activity
        self.last_ack = time.monotonic()   # last health-check ack
        # GPU IDs this worker process has been granted.  Its CUDA context
        # holds the cards until process exit, so the IDs return to the node
        # pool only at worker death (see _handle_worker_death).
        self.gpus: List[int] = []
        # True once any task ran here: a used worker may have initialised
        # CUDA with no card visible, and CUDA reads CUDA_VISIBLE_DEVICES
        # only at its first initialisation, so GPU grants only go to fresh
        # processes.
        self.used = False
        # Address of the worker's peer RPC server (direct actor calls and
        # leased task submission dial this).  Registered at worker_ready.
        self.peer_addr: str = ""


_task_seq = 0


class TaskRecord:
    def __init__(self, spec: dict):
        global _task_seq
        self.spec = spec
        self.task_id = TaskID(spec["task_id"])
        self.state = PENDING
        # Wall-clock submission time: feeds the built-in submit→start
        # latency histogram at dispatch.
        self.submit_time = time.time()
        self.pending_deps: Set[ObjectID] = set()
        self.worker_id: Optional[WorkerID] = None
        self.node_id: Optional[NodeID] = None
        self.retries_left = spec.get("max_retries", 0)
        self.start_time = 0.0
        self.end_time = 0.0
        self.error: Optional[str] = None
        # Submission order (used to restore FIFO when in-flight actor tasks
        # are requeued after a worker death) and blocked-in-get flag.
        _task_seq += 1
        self.seq = _task_seq
        self.blocked = False
        # Sticky placement: once the scheduler picks a node the task commits
        # to it (resources held) and parks until a worker there frees up
        # (reference: spread_scheduling_policy.h — the lease stays on the
        # chosen raylet while its worker pool spins up a worker).
        self.parked_node: Optional[NodeID] = None
        self.park_time = 0.0
        # Concrete GPU IDs granted at dispatch (tasks requesting
        # {"GPU": n}); freed back to the node's pool with the resources.
        self.gpus: Optional[List[int]] = None

    @property
    def is_actor_task(self) -> bool:
        return bool(self.spec.get("actor_id")) and not self.spec.get(
            "is_actor_creation"
        )

    @property
    def resources(self) -> Dict[str, float]:
        # api.py always sends explicit resources; {} (e.g. zero-CPU actors)
        # must stay empty, not fall back to 1 CPU.
        res = self.spec.get("resources")
        return dict(res) if res is not None else {"CPU": 1.0}

    @property
    def strategy(self) -> SchedulingStrategy:
        return _strategy_from_wire(self.spec.get("strategy"))

    def shape_key(self) -> tuple:
        """Placement-equivalence key: tasks with equal keys place (or fail to
        place) identically in a given cluster state — the analog of the
        reference's SchedulingClass (src/ray/common/task/task_spec.h).
        Memoized: the dispatch loop consults it on every queue scan, and a
        large burst is rescanned once per completion — recomputing the
        sorted tuples dominated scheduling CPU (observed: 1M recomputes for
        a 2k-task burst)."""
        cached = self.__dict__.get("_shape_key")
        if cached is None:
            res = self.spec.get("resources")
            strat = self.spec.get("strategy")
            cached = self._shape_key = (
                tuple(sorted(res.items())) if res else None,
                tuple(sorted(
                    (k, v if not isinstance(v, (bytes, bytearray))
                     else bytes(v))
                    for k, v in strat.items()
                )) if strat else None,
            )
        return cached


class ActorRecord:
    def __init__(self, actor_id: ActorID, spec: dict):
        self.actor_id = actor_id
        self.spec = spec
        self.state = "PENDING"  # PENDING|ALIVE|RESTARTING|DEAD
        self.worker_id: Optional[WorkerID] = None
        self.node_id: Optional[NodeID] = None
        self.restarts_left = spec.get("max_restarts", 0)
        self.name = spec.get("name") or ""
        # Tasks queued while the actor is pending/restarting.
        self.pending_tasks: deque = deque()
        self.num_executed = 0
        self.death_cause: Optional[str] = None


class ObjectRecord:
    __slots__ = (
        "object_id", "size", "inline", "locations", "error",
        "ref_count", "task_id", "sealed", "spilled",
    )

    def __init__(self, object_id: ObjectID):
        self.object_id = object_id
        self.size = 0
        self.inline: Optional[bytes] = None
        self.locations: Set[NodeID] = set()
        self.error: Optional[bytes] = None  # serialized exception
        self.ref_count = 1  # creator's reference
        self.task_id: Optional[TaskID] = None
        self.sealed = False
        self.spilled = False


@guarded
class Head:
    """The control-plane server."""

    # Spawn bookkeeping is mutated off-loop (executor spawn threads) while
    # the loop prunes/kills: rtlint RT007 verifies these statically and
    # RT_DEBUG_LOCKS=2 asserts them at runtime (devtools.locks).
    _RT_GUARDED_BY = {
        "worker_pids": "_pids_lock",
        "worker_procs": "_pids_lock",
        "_zygote": "_zygote_mutex",
    }
    _RT_UNGUARDED = {
        "_state_dirty": "monotonic re-arm: the loop clears it before the "
                        "off-loop dump and ONLY the failed dump sets it "
                        "back True — a racing loop-side _mark_dirty stores "
                        "the same value, and a lost False just means one "
                        "redundant snapshot next tick",
    }

    def __init__(self, config: Config, session: str, host: str = "127.0.0.1"):
        self.config = config
        self.session = session
        self.server = RpcServer(host=host, name="head-server")
        self.scheduler = ClusterScheduler(config.scheduler_spread_threshold)
        self.host = host
        self.port = 0

        # Local node's store daemon: accounting, eviction, spill, cleanup.
        from .object_store import ObjectStore

        self.store = ObjectStore(
            session, config.object_store_memory, config.spill_dir
        )
        self.kv: Dict[str, bytes] = {}
        self.workers: Dict[WorkerID, WorkerState] = {}
        self.conn_to_worker: Dict[int, WorkerID] = {}
        self.tasks: Dict[TaskID, TaskRecord] = {}
        self.tasks_waiting_on: Dict[ObjectID, Set[TaskID]] = {}
        self.finished_tasks: deque = deque(maxlen=10_000)  # for the state API
        self.actors: Dict[ActorID, ActorRecord] = {}
        self.named_actors: Dict[str, ActorID] = {}
        self.objects: Dict[ObjectID, ObjectRecord] = {}
        self.object_waiters: Dict[ObjectID, List[asyncio.Event]] = {}
        self.queued_tasks: deque = deque()  # TaskRecords ready to schedule
        # Shape histogram of queued_tasks: lets a dispatch pass stop as
        # soon as every shape still in the queue has already failed to
        # place — a homogeneous 10k-task burst costs O(1) per pass instead
        # of an O(n) rescan (reference: cluster_task_manager.h groups by
        # SchedulingClass).
        self.queue_shapes: Dict[tuple, int] = {}
        # Tasks committed to a node (resources held), awaiting an idle worker.
        self.node_parked: Dict[NodeID, deque] = {}
        # PGs with bundles lost to node death, awaiting re-placement.
        self.pgs_needing_bundles: Set[PlacementGroupID] = set()
        self.stream_items: Dict[tuple, dict] = {}  # (task_id, idx) -> item info
        self.stream_waiters: Dict[tuple, List[asyncio.Event]] = {}
        self.stream_done: Dict[TaskID, int] = {}  # total item count when finished
        self.subs: Dict[str, Set[int]] = {}  # topic -> conn ids
        self.node_sessions: Dict[NodeID, str] = {}  # store session per node
        self.node_worker_caps: Dict[NodeID, int] = {}
        self.node_worker_counts: Dict[NodeID, int] = {}
        self.local_node_id: Optional[NodeID] = None
        self.worker_procs: List[subprocess.Popen] = []
        self.worker_pids: List[int] = []  # zygote-forked (init reaps them)
        self._zygote = None
        self._zygote_mutex = make_lock("head.zygote")
        # Guards worker_pids/worker_procs only (list ops, microseconds):
        # spawns mutate them from executor threads while the loop prunes
        # exited pids — never hold this across the zygote handshake.
        self._pids_lock = make_lock("head.worker_pids")
        self.node_daemons: Dict[NodeID, Connection] = {}
        # Object-plane server address per node (chunked pull endpoint).
        self.node_object_addrs: Dict[NodeID, str] = {}
        self.node_bulk_addrs: Dict[NodeID, str] = {}
        self.node_last_ack: Dict[NodeID, float] = {}
        self.task_events: deque = deque(maxlen=config.task_events_buffer_size)
        self._events_since_persist = 0
        # -- debugging plane --------------------------------------------------
        # Cluster-wide log index: proc_id (worker/node hex) -> registered log
        # file + liveness.  Entries of EXITED processes are retained (bounded,
        # dead-oldest evicted first) so `get_log` works for crash post-mortems
        # (reference: the GCS worker table keeps dead workers for `ray logs`).
        self.log_index: "OrderedDict[str, dict]" = OrderedDict()
        # Per-task lifecycle histories: task hex -> record with a bounded
        # transition list + failure traceback, queryable via
        # list_state(kind="task_events") (reference: gcs_task_manager.h —
        # task events survive the worker because the HEAD holds them).
        self.task_history: "OrderedDict[str, dict]" = OrderedDict()
        # In-flight stack-dump round-trips: token -> future resolved by the
        # worker's stack_dump_reply.
        self._stack_waiters: Dict[int, asyncio.Future] = {}
        self._stack_token = 0
        # In-flight profile round-trips (same token discipline; resolved
        # by profile_reply after the worker's N-second capture).
        self._profile_waiters: Dict[int, asyncio.Future] = {}
        # Flight-recorder plane: per-engine bounded step-record rings fed
        # by h_engine_step_batch; list_state("engine_steps") and
        # `ray_tpu_torch top` read them (engine id -> deque of records,
        # oldest-engine evicted when the table itself fills).
        self.engine_steps: "OrderedDict[str, deque]" = OrderedDict()
        # Gang training observability: per-gang join state fed by
        # h_gang_round_batch — rounds awaiting a record from every rank
        # ("pending"), the bounded ring of joined skew profiles, and the
        # latest raw record per rank.  Oldest-idle gang evicted when the
        # table hits gang_rounds_max_gangs; read by
        # list_state("gang_rounds"), `ray_tpu_torch gang`, and the gang health
        # detectors.
        self.gang_rounds: "OrderedDict[str, dict]" = OrderedDict()
        # Device-memory accounting: latest util/devmem snapshot per
        # reporting worker pid, identity-joined at report time.
        self.devmem_by_pid: Dict[int, dict] = {}
        # Named actors that could NOT be restored after a head restart
        # (constructor args lived in the dead session's object store):
        # name -> human-readable reason, surfaced by get_actor(name)
        # (reference: GCS actor table entries keep a death cause).
        self.named_tombstones: Dict[str, str] = {}
        # Named actors restored from the snapshot but NOT yet re-created:
        # replay waits out head_resync_grace_s so a surviving worker's
        # field report can adopt the LIVE instance instead of racing a
        # fresh duplicate (name -> create_actor body); the periodic loop
        # replays the leftovers after the deadline.
        self._restore_named_pending: Dict[str, dict] = {}
        self._restore_named_deadline = 0.0
        # Resync race absorbers (head restart): until this deadline, actor
        # submissions for unknown actors PARK instead of failing — a
        # reconnected driver's replayed batch may legitimately precede the
        # hosting worker's adoption report.  Drained on adoption/replay;
        # leftovers fail typed when the window closes.
        self._resync_grace_until = 0.0
        self._parked_unknown_actor_tasks: List[dict] = []
        self._spawn_pending: Dict[NodeID, int] = {}
        self._spawn_times: Dict[NodeID, deque] = {}
        # Placement groups waiting for resources to free up (reference:
        # gcs_placement_group_manager queues pending PGs).
        self.pending_pgs: "Dict[PlacementGroupID, dict]" = {}
        # Creation bodies of every live PG (reserved or pending) — the
        # durable PG table: detached ones are replayed on head restart
        # (reference: gcs_table_storage.h PlacementGroupTable).
        self.pg_bodies: "Dict[PlacementGroupID, dict]" = {}
        # Non-detached PGs are scoped to their creator's connection.
        self.pg_owner_conn: "Dict[PlacementGroupID, int]" = {}
        self._pending_frees: Dict[int, dict] = {}
        self._free_token = 0
        # Live task leases: lease_id -> {worker_id, node_id, conn_id,
        # resources, expires, revoke_deadline}.  A lease is the head's
        # record that a worker's execution slot (and its resources) belongs
        # to a client for direct submission (reference: raylet
        # LocalLeaseManager's leased-worker table).
        self.leases: Dict[bytes, dict] = {}
        self._last_lease_preempt = 0.0
        self.metrics_by_pid: Dict[int, list] = {}
        # Counters/histograms of departed processes (see _retire_metrics):
        # cluster totals must stay monotonic across worker churn.
        self._metrics_retired: Dict[tuple, dict] = {}
        # Per-pid retired contributions, so a RECONNECTED process (driver
        # reconnect path) that re-reports its cumulative counters doesn't
        # get double-counted against its own retired snapshot.
        self._retired_by_pid: Dict[int, list] = {}
        # Cumulative store counters of departed NODES, same invariant.
        self._store_retired: Dict[str, float] = {}
        self._state_dirty = True  # persist once at startup when configured
        # Lineage: finished task specs kept (args pinned) so lost objects can
        # be recomputed by re-running their creating task (reference:
        # object_recovery_manager.h:90, reference_count.h:75).
        self.lineage: "OrderedDict[TaskID, dict]" = OrderedDict()
        self.reconstruction_counts: Dict[TaskID, int] = {}
        self.pg_waiters: Dict[PlacementGroupID, List[asyncio.Event]] = {}
        self._proxy_uploads: Dict[ObjectID, Any] = {}
        # Last per-node resource view from each daemon (the resource-syncer
        # table — reference: ray_syncer.h:88; consumed by the state API and
        # dashboard).
        self.node_stats: Dict[NodeID, dict] = {}
        # Workers killed by the memory monitor: their tasks' failure message
        # names the cause (reference: worker_killing_policy*.h attributes
        # OOM kills in the task error).  Ordered so the bound evicts oldest.
        self._oom_kills: "OrderedDict[WorkerID, float]" = OrderedDict()
        # Per-node kill cooldown: remote stats refresh every ~2s while this
        # check runs every tick — without the cooldown one stale reading
        # would kill a worker per tick.
        self._last_oom_kill: Dict[NodeID, float] = {}
        self._periodic_task: Optional[asyncio.Task] = None
        self._tick_task: Optional[asyncio.Task] = None
        self._shutdown = False
        self._kick_scheduled = False
        self.job_start_time = time.time()
        # Built-in ray_tpu_* instruments + retained time-series history
        # (see core/telemetry.py).  The history is fed by the periodic loop
        # from the same aggregate `list_state(kind="metrics")` serves.
        from .telemetry import HeadMetrics, MetricsHistory

        self.builtin_metrics = HeadMetrics()
        self.metrics_history = MetricsHistory(
            max_samples=config.metrics_history_max_samples,
            min_interval_s=config.metrics_history_min_interval_s,
            max_series=config.metrics_history_max_series,
        )
        # Health / incident plane (util/health.py): the detector pass runs
        # on the telemetry sampling cadence over the SAME aggregated rows
        # the history ring retains; incidents live only here (head-volatile,
        # like the timeline ring).  Loop-lag is probed by _periodic_loop.
        from ..util.health import HealthEngine

        self.health = HealthEngine(
            window_s=config.health_window_s,
            resolve_after_s=config.health_resolve_after_s,
            max_incidents=config.health_max_incidents,
            params={
                "slo_goal": config.health_slo_goal,
                "burn_fast_s": config.health_slo_fast_window_s,
                "burn_slow_s": config.health_slo_slow_window_s,
            },
            on_open=self._on_incident_open,
            on_resolve=self._on_incident_resolve,
        )
        self._loop_lag_s = 0.0

        for name in [
            "register", "kv_put", "kv_get", "kv_del", "kv_keys",
            "submit_task", "create_actor", "submit_actor_task",
            "task_done", "stream_item", "metrics_report", "batch",
            "put_object", "put_object_batch", "proxy_put",
            "get_objects",
            "wait_objects", "free_objects", "object_free_ack",
            "add_object_ref", "reconstruct_object",
            "create_placement_group", "remove_placement_group",
            "kill_actor", "cancel_task", "get_actor_by_name", "list_named_actors",
            "worker_ready",
            "publish", "subscribe", "cluster_resources", "available_resources",
            "next_stream_item", "list_state", "object_sizes",
            "ping", "shutdown_cluster",
            "restore_object", "store_stats",
            "task_blocked", "task_unblocked", "health_ack", "pg_ready",
            "node_health_ack", "node_stats", "node_drain", "span_batch",
            "get_log", "stack_dump", "stack_dump_reply",
            "engine_step_batch", "gang_round_batch", "devmem_report",
            "profile", "profile_reply",
            "resolve_actor", "lease_request", "lease_return", "lease_renew",
            "direct_done",
        ]:
            self.server.register(
                name, self._timed(name,
                                  _validated(name, getattr(self, f"h_{name}")))
            )
        # The head serves chunked pulls for its own node's objects
        # (remote nodes serve theirs via their daemon's object-plane server).
        from .node_main import make_pull_handler

        self.server.register("pull_object", make_pull_handler(self.store))
        self.server.on_disconnect = self._on_disconnect

    # ------------------------------------------------------------------ utils

    def _event(self, kind: str, **kw):
        if self.config.enable_timeline:
            self.task_events.append({"ts": time.time(), "kind": kind, **kw})
            # Coarse durability cadence: the event log rides the snapshot,
            # but marking dirty per event would re-pickle the whole state
            # every tick under load.  Every 100th event is enough for a
            # "recent timeline survives restart" guarantee.
            self._events_since_persist += 1
            if self._events_since_persist >= 100:
                self._events_since_persist = 0
                self._mark_dirty()

    # -- debugging plane: log index + task lifecycle history ------------------

    def _log_register(self, proc_id: str, kind: str, node_id: NodeID,
                      pid: int, log_path: str):
        """Add (or refresh) a process's entry in the cluster log index."""
        cap = self.config.log_index_max_entries
        if cap <= 0:
            return
        self.log_index.pop(proc_id, None)
        self.log_index[proc_id] = {
            "proc_id": proc_id,
            "kind": kind,
            "node_id": node_id.hex(),
            "pid": pid or 0,
            "log_path": log_path or "",
            "alive": True,
            "actor_id": None,
            "start_time": time.time(),
            "end_time": None,
        }
        while len(self.log_index) > cap:
            victim = next(
                (p for p, e in self.log_index.items() if not e["alive"]), None
            )
            if victim is None:
                self.log_index.popitem(last=False)
            else:
                self.log_index.pop(victim)

    def _log_mark_dead(self, proc_id: str):
        entry = self.log_index.get(proc_id)
        if entry is not None and entry["alive"]:
            entry["alive"] = False
            entry["end_time"] = time.time()

    def _resolve_log_entry(self, query: str):
        """Match a log-index entry by worker/node id (exact or unique
        prefix), the actor an entry's worker hosts/hosted, or pid.
        Returns ``(entry, error)`` — an ambiguous prefix gets an explicit
        error, never a misleading not-found (nor an arbitrary match)."""
        if not query:
            return None, "empty process id"
        entry = self.log_index.get(query)
        if entry is not None:
            return entry, None
        matches = [
            e for pid, e in self.log_index.items()
            if pid.startswith(query)
            or (e["actor_id"] or "").startswith(query)
        ]
        if len(matches) == 1:
            return matches[0], None
        if len(matches) > 1:
            return None, (f"{query!r} is ambiguous: matches "
                          f"{len(matches)} processes — use a longer prefix "
                          "(see list_state(kind='logs'))")
        if query.isdigit():
            by_pid = [e for e in self.log_index.values()
                      if e["pid"] == int(query)]
            if len(by_pid) == 1:
                return by_pid[0], None
            if len(by_pid) > 1:
                return None, (f"pid {query} matches {len(by_pid)} "
                              "processes (recycled pid) — use the "
                              "worker/node id instead")
        return None, (f"no log registered for {query!r} "
                      "(see list_state(kind='logs') for known ids)")

    def _task_transition(self, task: "TaskRecord", state: str,
                         node: Optional[NodeID] = None,
                         error: Optional[str] = None,
                         traceback_text: Optional[str] = None):
        """Append one lifecycle transition to the task's retained history
        (the task-event store: SUBMITTED/SCHEDULED/RUNNING/RETRYING/
        FINISHED/FAILED with timestamps, placement, and the full traceback
        on failure — survives worker and node death by living here)."""
        cap = self.config.task_history_max_tasks
        if cap <= 0:
            return
        hexid = task.task_id.hex()
        rec = self.task_history.get(hexid)
        if rec is None:
            rec = self.task_history[hexid] = {
                "task_id": hexid,
                "name": task.spec.get("name", ""),
                "actor_id": (ActorID(task.spec["actor_id"]).hex()
                             if task.spec.get("actor_id") else None),
                "state": state,
                "node_id": None,
                "worker_id": None,
                "error": None,
                "traceback": None,
                "events": [],
            }
            while len(self.task_history) > cap:
                self.task_history.popitem(last=False)
        ev: Dict[str, Any] = {"state": state, "ts": time.time()}
        nid = node or task.node_id
        if nid is not None:
            rec["node_id"] = ev["node"] = nid.hex()
        if task.worker_id is not None:
            rec["worker_id"] = ev["worker"] = task.worker_id.hex()
        if error:
            rec["error"] = ev["error"] = error
        if traceback_text:
            rec["traceback"] = traceback_text
        rec["state"] = state
        events = rec["events"]
        events.append(ev)
        if len(events) > self.config.task_history_max_events:
            # Keep the SUBMITTED head; a retry loop sheds its oldest middle.
            del events[1]

    def _obj(self, oid: ObjectID) -> ObjectRecord:
        rec = self.objects.get(oid)
        if rec is None:
            rec = self.objects[oid] = ObjectRecord(oid)
        return rec

    def _notify_object_ready(self, oid: ObjectID):
        for ev in self.object_waiters.pop(oid, []):
            ev.set()
        # Unblock tasks waiting on this dependency (indexed, not scanned).
        drained_actors = set()
        for tid in self.tasks_waiting_on.pop(oid, ()):
            task = self.tasks.get(tid)
            if task is None or task.state != PENDING:
                continue
            task.pending_deps.discard(oid)
            if task.pending_deps:
                continue
            if task.is_actor_task:
                # Actor tasks stay in the actor's FIFO queue; a newly
                # dep-free head-of-queue can now drain.
                aid = ActorID(task.spec["actor_id"])
                if aid not in drained_actors:
                    drained_actors.add(aid)
                    actor = self.actors.get(aid)
                    if actor is not None and actor.state == "ALIVE":
                        asyncio.ensure_future(self._drain_actor_queue(actor))
            elif task not in self.queued_tasks:
                self._enqueue_task(task)
        self._kick()

    def _kick(self):
        """Schedule a dispatch pass on the loop.  Coalesced: a burst of
        submissions (the client pipelines them) triggers one pass, not one
        pass per task — each pass scans the whole queue, so per-call passes
        turn a k-task burst into O(k²) scheduler work."""
        if self._kick_scheduled:
            return
        self._kick_scheduled = True

        def run():
            self._kick_scheduled = False
            asyncio.ensure_future(self._dispatch_loop())

        asyncio.get_running_loop().call_soon(run)

    # -------------------------------------------------------------- lifecycle

    async def start(self) -> int:
        self.port = await self.server.start()
        await self.start_periodic()
        return self.port

    async def start_periodic(self):
        """Launch the housekeeping loop on the serving event loop (callers
        that start the RpcServer directly must invoke this themselves)."""
        if self._periodic_task is None:
            self._periodic_task = asyncio.ensure_future(self._periodic_loop())
            self._tick_task = asyncio.ensure_future(self._store_tick_loop())

    async def _store_tick_loop(self):
        """Move cooled freed segments into the warm pool promptly (the main
        periodic loop may run at a coarser health-check cadence)."""
        while not self._shutdown:
            await asyncio.sleep(0.25)
            try:
                self.store.tick()
                self._expire_pending_frees()
            except Exception:
                pass

    async def _periodic_loop(self):
        """Housekeeping: worker health probes, idle-worker reaping, spawn
        timeout reclamation, pending-PG retry (reference:
        gcs_health_check_manager.h, worker_pool.h idle killing)."""
        cfg = self.config
        period = max(0.1, min(cfg.health_check_period_s, 1.0))
        while not self._shutdown:
            try:
                _t_sleep = time.monotonic()
                await asyncio.sleep(period)
                now = time.monotonic()
                # Event-loop lag probe: how late did this tick wake up?
                # Sustained lag means every handler is queueing behind
                # something — the health plane's head-pressure detector
                # watches the windowed max of this gauge.
                self._loop_lag_s = max(0.0, now - _t_sleep - period)
                self.builtin_metrics.loop_lag.set(self._loop_lag_s)
                self.store.tick()  # cooled freed segments -> warm pool
                try:
                    self._sample_telemetry()
                except Exception:
                    pass
                try:
                    self.persist_state()
                except Exception:
                    pass
                # Deferred snapshot replay: named actors the resync grace
                # window left unclaimed get re-created now (field reports
                # that arrived in time adopted the live instances instead).
                if self._restore_named_pending \
                        and now >= self._restore_named_deadline:
                    pending = self._restore_named_pending
                    self._restore_named_pending = {}
                    for name, spec in pending.items():
                        try:
                            await self._replay_named_actor(name, spec)
                        except Exception:
                            pass
                    # Replayed actors unblock their parked submissions.
                    await self._drain_parked_unknown_actor_tasks()
                if self._parked_unknown_actor_tasks \
                        and now >= self._resync_grace_until:
                    # Window closed: whatever is still unknown fails typed.
                    await self._drain_parked_unknown_actor_tasks(force=True)
                # Prune exited zygote-forked workers (orphans reaped by
                # init) so shutdown never signals a recycled pid.
                with self._pids_lock:
                    pids = list(self.worker_pids)
                for pid in pids:
                    try:
                        os.kill(pid, 0)
                    except (ProcessLookupError, PermissionError):
                        with self._pids_lock:
                            if pid in self.worker_pids:
                                self.worker_pids.remove(pid)
                # Health probes: push to every worker; acks come back via
                # h_health_ack.  A wedged process keeps the TCP connection
                # open but its rpc loop stops acking.
                dead_after = cfg.health_check_period_s * cfg.health_check_failure_threshold
                if self._loop_lag_s > cfg.health_check_period_s:
                    # This loop stalled (its process starved on a loaded
                    # host) and read no acks meanwhile: the silence is the
                    # head's, so every worker and node gets a fresh window
                    # instead of being killed for it.
                    for w in self.workers.values():
                        w.last_ack = max(w.last_ack, now)
                    for node_id in self.node_last_ack:
                        self.node_last_ack[node_id] = now
                for w in list(self.workers.values()):
                    if not w.conn.alive:
                        continue
                    try:
                        await w.conn.push("health_check", {})
                    except Exception:
                        continue
                    if now - w.last_ack > dead_after:
                        self._event("worker_health_timeout",
                                    worker=w.worker_id.hex())
                        if w.node_id == self.local_node_id:
                            try:
                                os.kill(w.pid, 9)
                            except (ProcessLookupError, PermissionError):
                                pass
                        else:
                            # A wedged (e.g. SIGSTOP'd) process can't run its
                            # connection-lost handler; its node daemon holds
                            # the Popen handle and delivers the SIGKILL.
                            daemon = self.node_daemons.get(w.node_id)
                            if daemon is not None:
                                try:
                                    await daemon.push(
                                        "kill_worker", {"pid": w.pid}
                                    )
                                except Exception:
                                    pass
                        w.conn.writer.close()  # triggers _on_disconnect
                # Node-daemon liveness (reference: GcsHealthCheckManager
                # probes every raylet).
                for node_id, conn in list(self.node_daemons.items()):
                    try:
                        await conn.push("health_check", {})
                    except Exception:
                        continue
                    last = self.node_last_ack.get(node_id, now)
                    if now - last > dead_after:
                        self._event("node_health_timeout", node=node_id.hex())
                        conn.writer.close()  # triggers node-death handling
                # Idle reaping: task-pool workers idle beyond the window exit
                # cleanly; demand respawns them.  Fresh (never-used) workers
                # are exempt up to the prestart spare budget — they ARE the
                # spare pool.
                idle_t = cfg.idle_worker_killing_time_s
                spares = cfg.prestart_spare_workers
                fresh_kept: Dict[NodeID, int] = {}
                for w in list(self.workers.values()):
                    if not (w.state == IDLE and w.conn.alive
                            and now - w.last_seen > idle_t):
                        continue
                    if not w.used and spares > 0:
                        kept = fresh_kept.get(w.node_id, 0)
                        if kept < spares:
                            fresh_kept[w.node_id] = kept + 1
                            continue
                    try:
                        await w.conn.push("shutdown", {})
                    except Exception:
                        pass
                # Prestart: keep the spare pool of fresh forked workers
                # filled so actor creations skip the fork+boot+register
                # latency (reference: worker_pool.h prestart).
                if spares > 0:
                    for node_id, cap in self.node_worker_caps.items():
                        if cap <= 0:
                            continue
                        # Never prestart for a node whose daemon is gone
                        # (caps outlive node death): the fallback would
                        # fork LOCAL processes for a nonexistent node,
                        # forever.
                        if (node_id != self.local_node_id
                                and node_id not in self.node_daemons):
                            continue
                        fresh = sum(
                            1 for w in self.workers.values()
                            if w.node_id == node_id and w.state == IDLE
                            and not w.used and w.conn.alive
                        )
                        pending = self._spawn_pending.get(node_id, 0)
                        live = sum(
                            1 for w in self.workers.values()
                            if w.node_id == node_id
                            and w.state in (STARTING, IDLE, LEASED)
                        )
                        hard = max(cap, 1) * \
                            self.config.worker_pool_hard_cap_multiple
                        room = hard - (live + pending)
                        for _ in range(
                                min(spares - fresh - pending, room)):
                            self._spawn_worker(node_id)
                # Spawn-timeout: reclaim slots of workers that never
                # registered so _maybe_spawn can retry.
                for node_id, times in self._spawn_times.items():
                    while times and now - times[0] > cfg.worker_register_timeout_s:
                        times.popleft()
                        if self._spawn_pending.get(node_id, 0) > 0:
                            self._spawn_pending[node_id] -= 1
                # Stale parked tasks: a node that can neither free nor spawn
                # a worker within the register window gives the task back to
                # the global queue (sticky placement must not become a
                # deadlock when a node's pool is wedged).
                stale_after = cfg.worker_register_timeout_s * 2
                requeued = False
                for node_id in list(self.node_parked):
                    q = self.node_parked[node_id]
                    for task in [
                        t for t in q
                        if t.state == PENDING
                        and now - t.park_time > stale_after
                    ]:
                        self._unpark(task)
                        self._enqueue_task(task)
                        requeued = True
                if requeued:
                    self._kick()
                # Lease TTLs: revoke unrenewed leases; force-reclaim ones
                # whose revoke handshake never completed (dead/wedged
                # client) so slots always flow back to the pool.
                for lease_id in list(self.leases):
                    lease = self.leases.get(lease_id)
                    if lease is None:
                        continue
                    deadline = lease["revoke_deadline"]
                    if deadline is not None:
                        if now >= deadline:
                            self._finalize_lease(
                                lease_id, "revoke_timeout", revoked=True)
                    elif now >= lease["expires"]:
                        await self._revoke_lease(lease_id, "ttl_expired")
                await self._check_memory_pressure()
            except asyncio.CancelledError:
                return
            except Exception:
                import traceback

                traceback.print_exc()

    # -- memory monitor (reference: src/ray/common/memory_monitor.h:52 +
    # raylet/worker_killing_policy_group_by_owner.h) -------------------------

    def _pick_oom_victim(self, node_id: NodeID) -> Optional[WorkerState]:
        """Retriable leased tasks first, newest first; actors and
        non-retriable work only as a last resort never — killing state-
        bearing actors trades a recoverable stall for data loss
        (reference: worker_killing_policy_group_by_owner.h prefers
        retriable tasks, LIFO)."""
        candidates = []
        for w in self.workers.values():
            if w.node_id != node_id or w.state != LEASED or not w.inflight:
                continue
            task = self.tasks.get(next(iter(w.inflight)))
            if task is None:
                continue
            retriable = task.retries_left != 0
            candidates.append((retriable, task.start_time, w))
        if not candidates:
            return None
        candidates.sort(key=lambda c: (not c[0], -c[1]))
        return candidates[0][2]

    async def _check_memory_pressure(self):
        thr = self.config.memory_usage_threshold
        if not thr:
            return
        for node_id in list(self.scheduler.nodes):
            if node_id == self.local_node_id:
                from .config import host_memory_used_frac

                frac = host_memory_used_frac()
            else:
                st = self.node_stats.get(node_id) or {}
                frac = st.get("mem_used_frac") or 0.0
            if frac < thr:
                continue
            now = time.monotonic()
            if now - self._last_oom_kill.get(node_id, 0.0) < 5.0:
                continue  # let the last kill take effect / stats refresh
            victim = self._pick_oom_victim(node_id)
            if victim is None:
                continue
            self._last_oom_kill[node_id] = now
            self._event("oom_kill", worker=victim.worker_id.hex(),
                        mem_used_frac=round(frac, 4))
            self._oom_kills[victim.worker_id] = now
            while len(self._oom_kills) > 1000:  # bound: evict oldest
                self._oom_kills.popitem(last=False)
            if victim.node_id == self.local_node_id:
                try:
                    os.kill(victim.pid, 9)
                except (ProcessLookupError, PermissionError):
                    pass
            else:
                daemon = self.node_daemons.get(victim.node_id)
                if daemon is not None:
                    try:
                        await daemon.push("kill_worker", {"pid": victim.pid})
                    except Exception:
                        pass

    async def stop(self):
        try:
            self.persist_state()
        except Exception:
            pass
        self._shutdown = True
        # Sweep this session's node-local fn-table cache (workers populate
        # it under <temp dir>/ray_tpu_torch_fncache/<session>).  Off-loop: a large
        # cache tree would stall the final pushes/acks below (RT001) —
        # and after the shutdown flag, so nothing new interleaves in.
        try:
            import shutil

            await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: shutil.rmtree(
                    os.path.join(tmp_root("fncache"), self.session),
                    ignore_errors=True,
                ),
            )
        except Exception:
            pass
        if self._periodic_task is not None:
            self._periodic_task.cancel()
        if self._tick_task is not None:
            self._tick_task.cancel()
        for w in self.workers.values():
            if w.conn.alive:
                try:
                    await w.conn.push("shutdown", {})
                except Exception:
                    pass
        await asyncio.sleep(0.05)
        with self._pids_lock:
            procs = list(self.worker_procs)
            pids = list(self.worker_pids)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for pid in pids:
            try:
                os.kill(pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        # Off-loop: an in-flight spawn can hold the mutex across its whole
        # handshake (seconds) and the loop must keep serving until then.
        def _close_zygote():
            with self._zygote_mutex:
                if self._zygote is not None:
                    self._zygote.close()

        await asyncio.get_running_loop().run_in_executor(None, _close_zygote)
        if getattr(self, "_bulk_server", None) is not None:
            self._bulk_server.close()
        await self.server.stop()
        self.store.shutdown()

    def add_local_node(self, resources: Dict[str, float], num_workers: int,
                       labels: Optional[Dict[str, str]] = None,
                       node_id: Optional[NodeID] = None) -> NodeID:
        # ``node_id``: a standalone head (head_main) pins its local node id
        # across restarts so pre-crash object locations, driver node
        # bindings, and resync manifests keep resolving to "this node".
        if node_id is None:
            node_id = NodeID.from_random()
        self.scheduler.add_node(node_id, resources, labels)
        self.local_node_id = node_id
        self.node_sessions[node_id] = self.session
        self.node_worker_caps[node_id] = num_workers
        self.node_worker_counts[node_id] = 0
        self._spawn_pending[node_id] = 0
        self.node_object_addrs[node_id] = f"{self.host}:{self.port}"
        try:
            from .node_main import BulkServer

            self._bulk_server = BulkServer(self.store, self.session, self.host)
            self._bulk_server.start()
            self.node_bulk_addrs[node_id] = f"{self.host}:{self._bulk_server.port}"
        except Exception:
            self._bulk_server = None
        # Boot the local zygote eagerly: its one-time import cost overlaps
        # driver startup instead of delaying the first worker spawn.
        # Try-acquire, never block: do_spawn holds the mutex across whole
        # spawn handshakes on executor threads, and this runs on the loop —
        # if it's contended, a spawn is already booting the zygote for us.
        if self._zygote_mutex.acquire(blocking=False):
            try:
                if self._zygote is None:
                    try:
                        from .zygote import Zygote

                        self._zygote = Zygote(  # rt-unguarded: mutex IS held (try-acquired above; a with-block would stall the loop)
                            self._worker_base_env(node_id))
                    except Exception:
                        self._zygote = None  # rt-unguarded: mutex IS held (try-acquired above)
            finally:
                self._zygote_mutex.release()
        return node_id

    def _worker_base_env(self, node_id: NodeID) -> Dict[str, str]:
        env = dict(os.environ)
        # Workers see no card (CUDA_VISIBLE_DEVICES=""), so they never grab
        # a GPU from under the driver; a task granted {"GPU": n} gets its
        # cards at task start (accelerators.apply_visibility).
        from .. import accelerators

        accelerators.set_worker_env(env)
        # Ensure workers can import ray_tpu_torch regardless of the driver's cwd.
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = (
            pkg_parent + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH")
            else pkg_parent
        )
        env.update(
            RT_HEAD_ADDR=f"{self.host}:{self.port}",
            RT_NODE_ID=node_id.hex(),
            RT_SESSION=self.node_sessions[node_id],
            # Peer-plane wiring: the host the worker's peer RPC server
            # binds.  (The node's object-plane endpoints travel via the
            # register reply / resolve_actor descriptors, not env.)
            RT_PEER_HOST=self.host,
        )
        return env

    def _spawn_worker(self, node_id: NodeID):
        """Spawn a worker process for a node (local nodes only; remote nodes
        get a spawn_worker push to their daemon)."""
        env = self._worker_base_env(node_id)
        daemon = self.node_daemons.get(node_id)
        self._spawn_pending[node_id] = self._spawn_pending.get(node_id, 0) + 1
        self._spawn_times.setdefault(node_id, deque()).append(time.monotonic())
        if daemon is not None:
            asyncio.ensure_future(daemon.push("spawn_worker", {}))
            return
        from .node_main import LOG_ROOT

        log_dir = os.path.join(LOG_ROOT, self.session)
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"worker-{time.time_ns()}.log")

        # Spawn off-loop: the zygote handshake (or a fallback interpreter
        # boot) must never block the control plane's event loop.
        def do_spawn():
            from .zygote import spawn_with_fallback

            with self._zygote_mutex:
                self._zygote, pid, proc = spawn_with_fallback(
                    self._zygote, env, log_path
                )
                with self._pids_lock:
                    if pid is not None:
                        self.worker_pids.append(pid)
                    else:
                        self.worker_procs.append(proc)

        asyncio.get_running_loop().run_in_executor(None, do_spawn)

    # ------------------------------------------------------------- handlers

    async def h_ping(self, conn, body):
        return {"ok": True, "session": self.session}

    async def h_register(self, conn, body):
        from . import schema as wire_schema
        from .rpc import RpcError

        try:
            wire_schema.check_protocol(body.get("protocol"))
        except wire_schema.SchemaError as e:
            raise RpcError(str(e)) from None
        kind = body["kind"]
        reconnect = bool(body.get("reconnect"))
        if kind == "worker":
            worker_id = WorkerID(body["worker_id"])
            node_id = NodeID(body["node_id"])
            if reconnect:
                # Field-state resync: a worker that survived a head restart
                # (or a connection blip) re-registers carrying its live
                # state.  Adoption may be REFUSED (stale actor incarnation,
                # dead actor) — then nothing is registered and the worker
                # exits.
                refused = await self._resync_worker_check(worker_id, body)
                if refused is not None:
                    self._event("worker_resync_refused",
                                worker=worker_id.hex(), reason=refused)
                    return {"session": self.session, "refused": refused}
            w = WorkerState(worker_id, node_id, conn, body.get("pid", 0))
            w.peer_addr = body.get("peer_addr") or ""
            old = self.workers.get(worker_id)
            if old is not None and old.conn is not conn:
                # The previous connection's disconnect may not have fired
                # yet: unlink it so its eventual teardown can't kill the
                # adopted record.
                self.conn_to_worker.pop(old.conn.conn_id, None)
            self.workers[worker_id] = w
            self.conn_to_worker[conn.conn_id] = worker_id
            conn.meta["kind"] = "worker"
            conn.meta["reader_node"] = node_id
            self._log_register(worker_id.hex(), "worker", node_id,
                               body.get("pid", 0), body.get("log_path", ""))
            if not reconnect and self._spawn_pending.get(node_id, 0) > 0:
                self._spawn_pending[node_id] -= 1
                times = self._spawn_times.get(node_id)
                if times:
                    times.popleft()
            self.node_worker_counts[node_id] = (
                self.node_worker_counts.get(node_id, 0) + 1
            )
            if reconnect:
                # Push handlers are already installed in the reconnecting
                # process — no worker_ready handshake: go straight to
                # service (IDLE, or ACTOR when an adoption bound an actor).
                w.used = True
                w.state = IDLE
                await self._resync_worker_adopt(w, body)
                self._note_resync("worker", worker_id.hex())
                self._kick()
            return {"session": self.session,
                    "trace_sample_rate": self.config.trace_sample_rate}
        if kind == "node":
            node_id = NodeID(body["node_id"]) if body.get("node_id") else NodeID.from_random()
            if node_id not in self.scheduler.nodes:
                self.scheduler.add_node(
                    node_id, body["resources"], body.get("labels"))
            self.node_sessions[node_id] = body.get("store_session", self.session)
            self.node_worker_caps[node_id] = body.get("num_workers", 4)
            if reconnect:
                # Blip case: workers of this node may have re-registered
                # BEFORE their daemon did — never zero a count they already
                # rebuilt.
                self.node_worker_counts.setdefault(node_id, 0)
                self._spawn_pending.setdefault(node_id, 0)
            else:
                self.node_worker_counts[node_id] = 0
                self._spawn_pending[node_id] = 0
            self.node_daemons[node_id] = conn
            if body.get("object_addr"):
                self.node_object_addrs[node_id] = body["object_addr"]
            if body.get("bulk_addr"):
                self.node_bulk_addrs[node_id] = body["bulk_addr"]
            self.node_last_ack[node_id] = time.monotonic()
            conn.meta["kind"] = "node"
            conn.meta["node_id"] = node_id
            self._log_register(node_id.hex(), "node", node_id,
                               body.get("pid", 0), body.get("log_path", ""))
            if reconnect:
                resync = body.get("resync") or {}
                self._note_resync("node", node_id.hex(),
                                  headless_s=resync.get("headless_s"))
            self._kick()
            return {"session": self.session, "node_id": node_id.binary(),
                    "trace_sample_rate": self.config.trace_sample_rate}
        # Drivers on the head host attach its shm session for zero-copy
        # reads.  A driver on another machine gets PROXY mode instead (the
        # Ray Client role — reference: python/ray/util/client/, ray_client
        # .proto): no shm attach, no location preference; puts upload in
        # chunks to the head's store (h_proxy_put) and gets pull over the
        # object-plane TCP endpoints like any cross-node read.
        peer = conn.writer.get_extra_info("peername")
        peer_ip = peer[0] if peer else ""
        if peer_ip.startswith("::ffff:"):  # IPv4-mapped (dual-stack socket)
            peer_ip = peer_ip[len("::ffff:"):]
        remote = peer_ip and peer_ip not in ("127.0.0.1", "::1", self.host)
        if remote or body.get("force_proxy"):
            conn.meta["kind"] = kind  # driver (proxied)
            conn.meta["pid"] = body.get("pid")
            conn.meta["proxy"] = True
            return {"session": self.session, "proxy": True,
                    "trace_sample_rate": self.config.trace_sample_rate}
        conn.meta["kind"] = kind  # driver
        conn.meta["pid"] = body.get("pid")
        conn.meta["reader_node"] = self.local_node_id
        if body.get("reconnect"):
            # Same-process driver re-dial (client._try_reconnect): its
            # cumulative counters were folded into the retired baseline at
            # disconnect and are about to be re-reported live.  Mark the
            # connection so the first metrics report un-retires them — an
            # explicit marker, never pid heuristics (a recycled pid from an
            # unrelated process must not decrement the baseline).
            conn.meta["reconnected_pid"] = body.get("pid")
        return {
            "session": self.session,
            "node_id": self.local_node_id.binary() if self.local_node_id else b"",
            # Head-configured root sampling rate: one cluster-wide knob
            # (util/tracing.py rolls it at every trace root).
            "trace_sample_rate": self.config.trace_sample_rate,
        }

    # -- field-state resync (head restart survival) ---------------------------
    # (reference: GCS FT — on a GCS restart, raylets and core workers
    # reconnect and replay their local state so the volatile tables are
    # rebuilt from the field; redis_store_client.h holds only the durable
    # tables.  Here: workers re-register carrying their live actor +
    # creation spec, node daemons replay their store manifests through
    # put_object_batch, and drivers re-assert their large puts.)

    def _note_resync(self, kind: str, proc_hex: str,
                     headless_s: Optional[float] = None):
        self.builtin_metrics.resync_reports.inc(tags={"kind": kind})
        if headless_s is not None and kind == "node":
            self.builtin_metrics.headless_seconds.set(
                float(headless_s), tags={"node": proc_hex})
        self._event("head_resync", peer_kind=kind, proc=proc_hex)

    async def _resync_worker_check(self, worker_id: WorkerID,
                                   body) -> Optional[str]:
        """Decide whether a reconnecting worker's claimed state can be
        adopted.  Returns a refusal reason, or None to adopt.  The refusal
        cases are exactly the stale-incarnation ones: the cluster has (or
        is creating) a NEWER incarnation of the claimed actor, so the old
        process's state must not re-enter the directory."""
        resync = body.get("resync") or {}
        raw_actor = resync.get("actor_id")
        if not raw_actor:
            return None  # plain pooled worker: always adoptable
        actor = self.actors.get(ActorID(raw_actor))
        if actor is None:
            # Unknown actor (head restarted): adoptable iff the worker
            # shipped a usable creation spec to rebuild the record from.
            creation = resync.get("creation_spec")
            if not isinstance(creation, dict) or not creation.get("task_id"):
                return "unknown_actor_without_creation_spec"
            meta = creation.get("actor_meta") or {}
            name = meta.get("name")
            if name and self.named_actors.get(name) not in (None, ActorID(raw_actor)):
                return "actor_name_taken_by_newer_incarnation"
            return None
        if actor.state == "DEAD":
            return "actor_dead"
        if actor.state in ("PENDING", "RESTARTING"):
            # A replacement incarnation is already being created (this
            # head watched the old connection die and started the restart):
            # the returning process is the STALE incarnation.
            return "stale_incarnation"
        if actor.worker_id is not None and actor.worker_id != worker_id:
            w = self.workers.get(actor.worker_id)
            if w is not None and w.conn.alive:
                return "stale_incarnation"
        return None

    async def _resync_worker_adopt(self, w: WorkerState, body) -> None:
        """Bind a reconnecting worker's claimed live actor (check already
        passed).  Unknown actors are rebuilt full-fidelity from the shipped
        creation spec — field state merges with (and preempts) the durable
        snapshot's deferred named-actor replay."""
        resync = body.get("resync") or {}
        raw_actor = resync.get("actor_id")
        if not raw_actor:
            return
        aid = ActorID(raw_actor)
        actor = self.actors.get(aid)
        if actor is None:
            creation = dict(resync.get("creation_spec") or {})
            meta = creation.pop("actor_meta", None) or {}
            spec = {
                "actor_id": raw_actor,
                "class_name": meta.get("class_name")
                or str(creation.get("name", "")).split(".", 1)[0],
                "name": meta.get("name"),
                "namespace": meta.get("namespace"),
                "max_restarts": meta.get("max_restarts", 0),
                "max_task_retries": meta.get("max_task_retries", 0),
                "method_names": meta.get("method_names", []),
                "method_defaults": meta.get("method_defaults", {}),
                "lifetime": meta.get("lifetime"),
                "creation_task": creation,
            }
            actor = ActorRecord(aid, spec)
            self.actors[aid] = actor
            name = spec.get("name")
            if name:
                # The live instance wins over the snapshot's replay: drop
                # the deferred re-creation and any tombstone for the name.
                self.named_actors[name] = aid
                self._restore_named_pending.pop(name, None)
                self.named_tombstones.pop(name, None)
                self._mark_dirty()
            # A later worker death restarts the adopted actor through the
            # normal path: the shipped creation spec is complete (func_key,
            # args), so _handle_worker_death can resubmit it.
            self._event("actor_adopted", actor=aid.hex(),
                        worker=w.worker_id.hex())
        actor.state = "ALIVE"
        actor.worker_id = w.worker_id
        actor.node_id = w.node_id
        w.state = ACTOR
        w.actor_id = aid
        await self._publish(f"actor:{aid.hex()}", {"state": "ALIVE"})
        # Refresh client route caches with the (unchanged) peer address —
        # clients that dropped the route during the outage re-learn it
        # without a resolve round trip.
        await self._publish_actor_event(actor, "ALIVE")
        # Submissions that raced ahead of this adoption were parked: they
        # re-enter now, in arrival order, ahead of anything newer.
        await self._drain_parked_unknown_actor_tasks()
        if actor.pending_tasks:
            await self._drain_actor_queue(actor)

    async def _on_disconnect(self, conn: Connection):
        # Non-detached placement groups die with their creator's connection
        # (reference: PGs are destroyed when the creating job exits unless
        # lifetime="detached" — gcs_placement_group_manager job scoping).
        owned = [p for p, owner in self.pg_owner_conn.items()
                 if owner == conn.conn_id]
        for pg_id in owned:
            self.pg_owner_conn.pop(pg_id, None)
            self.pg_bodies.pop(pg_id, None)
            self.pending_pgs.pop(pg_id, None)
            self._notify_pg_ready(pg_id)
            self.scheduler.remove_placement_group(pg_id)
            self._mark_dirty()
        if owned:
            self._kick()  # freed reservations: retry pending PGs/tasks
        # A proxy driver that died mid-upload leaves unsealed segments in
        # the head store; reclaim them (gets on those ids keep blocking
        # until their own timeouts, same as a never-sealed put).
        for oid in conn.meta.pop("proxy_uploads", ()):  # type: ignore[misc]
            self._proxy_uploads.pop(oid, None)
            try:
                self.store.free(oid, pool=False)
            except Exception:
                pass
        # Leases owned by a departing client release immediately (their
        # resources and workers return to the pool — the driver-disconnect
        # analog of lease return).
        for lease_id, lease in list(self.leases.items()):
            if lease["conn_id"] == conn.conn_id:
                self._finalize_lease(lease_id, "owner_disconnected")
        worker_id = self.conn_to_worker.pop(conn.conn_id, None)
        if conn.meta.get("pid") is not None:
            self._retire_metrics(conn.meta["pid"])
        if worker_id is not None:
            w = self.workers.get(worker_id)
            if w is not None:
                self._retire_metrics(w.pid)
            if w is not None:
                # Exited zygote-forked worker: drop the pid now so a later
                # shutdown can't signal a recycled pid.
                with self._pids_lock:
                    if w.pid in self.worker_pids:
                        self.worker_pids.remove(w.pid)
            await self._handle_worker_death(worker_id)
        node_id = conn.meta.get("node_id")
        if node_id is not None and conn.meta.get("kind") == "node":
            self._log_mark_dead(node_id.hex())
            self.node_daemons.pop(node_id, None)
            self.node_object_addrs.pop(node_id, None)
            self.node_bulk_addrs.pop(node_id, None)
            self.node_last_ack.pop(node_id, None)
            # Fold the dead node's cumulative store counters into the
            # retained baseline first — the cluster-wide *_total store
            # gauges must not drop when a node leaves (same monotonicity
            # rule as _retire_metrics).
            st = self.node_stats.pop(node_id, None)
            for k, v in (((st or {}).get("store")) or {}).items():
                if k.endswith("_total") or k.startswith("gets_"):
                    if isinstance(v, (int, float)):
                        self._store_retired[k] = \
                            self._store_retired.get(k, 0) + v
            damaged = self.scheduler.remove_node(node_id)
            if damaged:
                # Bundles lost with the node get re-placed on survivors
                # (reference: gcs_placement_group_scheduler.h reschedules on
                # node death); until then tasks targeting them stay queued.
                self.pgs_needing_bundles.update(damaged)
            # Tasks committed to the dead node go back to the global queue
            # (their resources died with the node — release is a no-op).
            for task in self.node_parked.pop(node_id, ()):
                if task.state == PENDING:
                    task.parked_node = None
                    self._enqueue_task(task)
            # Objects whose only copy lived there are gone; purge locations
            # and recompute referenced ones from lineage (reference:
            # object_recovery_manager.h:90 recovers on location loss).
            lost: List[ObjectID] = []
            for o, rec in self.objects.items():
                if node_id in rec.locations:
                    rec.locations.discard(node_id)
                    if rec.sealed and rec.inline is None and not rec.locations:
                        lost.append(o)
            for o in lost:
                self._maybe_reconstruct(o)
            # The dead node may have had zero registered workers (the sticky-
            # placement case: parked task, worker still spawning) — the
            # per-worker death path below won't run, so kick explicitly for
            # the requeued tasks and lost-bundle rescheduling.
            self._kick()
            for w in [w for w in self.workers.values() if w.node_id == node_id]:
                # The daemon is gone but its worker processes may still be
                # alive (e.g. simulated node removal): tell them to exit.
                if w.conn.alive:
                    try:
                        await w.conn.push("exit", {})
                    except Exception:
                        pass
                await self._handle_worker_death(w.worker_id)
        for topic_subs in self.subs.values():
            topic_subs.discard(conn.conn_id)

    # -- KV (reference: gcs_kv_manager.h) -------------------------------------

    def _mark_dirty(self):
        self._state_dirty = True

    async def h_kv_put(self, conn, body):
        key = body["key"]
        if body.get("overwrite", True) or key not in self.kv:
            self.kv[key] = body["value"]
            self._mark_dirty()
            return {"added": True}
        return {"added": False}

    async def h_kv_get(self, conn, body):
        return {"value": self.kv.get(body["key"])}

    async def h_kv_del(self, conn, body):
        deleted = self.kv.pop(body["key"], None) is not None
        if deleted:
            self._mark_dirty()
        return {"deleted": deleted}

    async def h_kv_keys(self, conn, body):
        prefix = body.get("prefix", "")
        return {"keys": [k for k in self.kv if k.startswith(prefix)]}

    # -- objects ---------------------------------------------------------------

    async def h_put_object(self, conn, body):
        """Driver/worker ray.put: object already written to shm (or inline)."""
        oid = ObjectID(body["object_id"])
        if body.get("from_pull") and oid not in self.objects:
            # The object's last reference was dropped mid-pull: registering
            # the new copy would resurrect a freed record with no remaining
            # owner.  Drop the copy instead: adopt it into its node's store
            # (so the daemon owns the segment) and free it immediately.
            node_id = NodeID(body["node_id"])
            if node_id == self.local_node_id:
                try:
                    self.store.adopt(oid)
                except (FileNotFoundError, MemoryError):
                    pass
                self.store.free(oid)
            else:
                daemon = self.node_daemons.get(node_id)
                if daemon is not None:
                    await daemon.push("adopt_object", {"object_id": oid.binary()})
                    await daemon.push("free_objects", {"object_ids": [oid.binary()]})
            return {"freed": True}
        rec = self._obj(oid)
        if body.get("error") is not None:
            # Deferred registration of a direct-call failure result: the
            # submitter shares the ref with another process, which must see
            # the same exception a local get() raises.
            rec.error = body["error"]
        elif body.get("inline") is not None:
            rec.inline = body["inline"]
            rec.size = len(rec.inline)
        else:
            rec.size = body["size"]
            node_id = NodeID(body["node_id"])
            rec.locations.add(node_id)
            self._adopt_local(oid, node_id)
        rec.sealed = True
        rec.ref_count = max(rec.ref_count, 1)
        self._notify_object_ready(oid)
        return {}

    async def h_proxy_put(self, conn, body):
        """Chunked upload from a proxied (off-host) driver into the head's
        store — the Ray Client put path (reference: util/client/dataclient.py
        streams puts to the proxy server in chunks)."""
        oid = ObjectID(body["object_id"])
        total = body["total"]
        view = self._proxy_uploads.get(oid)
        if view is None:
            view = self._proxy_uploads[oid] = self.store.create(oid, total)
            # Track per connection: a proxy driver dying mid-upload must
            # not leak the unsealed segment (cleaned in _on_disconnect).
            conn.meta.setdefault("proxy_uploads", set()).add(oid)
        data = body["data"]
        off = body["offset"]
        if len(data) >= (1 << 20):
            from ray_tpu_torch import _native

            _native.copy(view[off:off + len(data)], data)
        else:
            view[off:off + len(data)] = data
        if body.get("done"):
            self._proxy_uploads.pop(oid, None)
            conn.meta.get("proxy_uploads", set()).discard(oid)
            self.store.seal(oid)
            rec = self._obj(oid)
            rec.size = total
            rec.locations.add(self.local_node_id)
            rec.sealed = True
            rec.ref_count = max(rec.ref_count, 1)
            self._notify_object_ready(oid)
        return {}

    # -- persistence (reference: redis_store_client.h — GCS tables survive a
    # head restart; raylets/workers reconnect and replay) -------------------

    def persist_state(self):
        """Snapshot durable control-plane state: the KV table and the specs
        of live named actors (recreated — fresh — on restore; their in-memory
        state is the application's to checkpoint).  Only when dirty, and the
        pickle+write runs off the event loop (a large KV must not stall
        dispatch)."""
        path = self.config.head_state_path
        if not path or not self._state_dirty:
            return
        self._state_dirty = False
        named = {}
        for name, aid in self.named_actors.items():
            actor = self.actors.get(aid)
            if actor is not None and actor.state != "DEAD":
                named[name] = actor.spec
        # Restored-but-not-yet-replayed named actors (resync grace window
        # still open) must survive a crash-during-restore: carry them
        # through verbatim.
        for name, spec in self._restore_named_pending.items():
            named.setdefault(name, spec)
        # Durable tables: KV, named/detached actor specs, and every live
        # placement group's creation body (reserved or still pending) —
        # the reference persists these in Redis-backed GCS tables
        # (gcs_table_storage.h) and replays on restart.
        # Only detached PGs are durable: a non-detached PG's owner (its
        # driver connection) cannot survive a head restart anyway, and
        # persisting it would leak its reservation forever.
        pgs = {pg_id.binary(): body
               for pg_id, body in self.pg_bodies.items()
               if body.get("lifetime") == "detached"}
        snapshot = {"kv": dict(self.kv), "named_actors": named,
                    "pgs": pgs,
                    # Bounded task-event tail: `status`/timeline keep their
                    # RECENT history across restarts (reference:
                    # gcs_task_manager.h:86 task-event store in GCS).  The
                    # snapshot carries a small tail, never the full 100k
                    # ring — any kv/actor/PG dirty-flush would otherwise
                    # re-pickle a multi-MB event blob every time.
                    "task_events": list(self.task_events)[-2000:],
                    "tombstones": dict(self.named_tombstones)}

        def dump():
            # The dirty bit was cleared BEFORE this off-loop write and the
            # executor future is never awaited — so a failed write (disk
            # full, ENOSPC, permissions) must re-arm it itself, or the
            # snapshot stays silently stale forever while the head keeps
            # reporting itself durable.
            try:
                import cloudpickle

                blob = cloudpickle.dumps(snapshot)
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)
            except BaseException:
                import traceback

                self._state_dirty = True  # retry on the next periodic tick
                print(
                    "ray_tpu_torch head: persist_state write to "
                    f"{path!r} FAILED — on-disk snapshot is stale and will "
                    "be retried:\n" + traceback.format_exc(),
                    file=sys.stderr, flush=True,
                )

        try:
            asyncio.get_running_loop().run_in_executor(None, dump)
        except RuntimeError:
            dump()  # no loop (e.g. called from stop() teardown path)

    async def restore_state(self):
        """Load a snapshot: KV merges in; named actors are re-created by
        resubmitting their creation specs (args that lived in the old shm
        session are gone — only inline-args actors restore)."""
        # Open the resync grace window unconditionally at boot: a head
        # restarted WITHOUT a snapshot (crash before the first persist, or
        # no state path configured) still receives field reports and
        # reconnected-driver replays in arbitrary order — unknown-actor
        # submissions and orphan completions must park/seal during the
        # window regardless of snapshot presence.  Harmless on a genuinely
        # fresh cluster: legitimate submissions always follow their
        # create_actor on the same connection.
        self._resync_grace_until = (
            time.monotonic() + self.config.head_resync_grace_s
        )
        path = self.config.head_state_path
        if not path or not os.path.exists(path):
            return
        # Disk read + unpickle off-loop: a multi-MB snapshot parsed on the
        # loop would block the very first registrations after a restart
        # (RT001 — the handlers-never-block contract applies at boot too).
        def _load():
            import cloudpickle

            with open(path, "rb") as f:
                return cloudpickle.loads(f.read())

        state = await asyncio.get_running_loop().run_in_executor(None, _load)
        self.kv.update(state.get("kv", {}))
        # Event history first, so restart markers sort after it.
        for ev in state.get("task_events", []):
            self.task_events.append(ev)
        self._event("head_restarted")
        self.builtin_metrics.head_restarts.inc()
        self.named_tombstones.update(state.get("tombstones", {}))
        # PGs first: restored actors may target them.  Replaying the
        # creation body re-reserves bundles on the current node set; with
        # no nodes registered yet the PG queues in pending_pgs and is
        # satisfied when daemons (re)join — exactly the pending-PG path.
        for raw, body in state.get("pgs", {}).items():
            pg_id = PlacementGroupID(raw)
            if pg_id in self.pg_bodies:
                continue
            try:
                await self.h_create_placement_group(None, body)
            except Exception as e:
                # A skipped PG must be VISIBLE: post-mortems need to know
                # what did not come back, not infer it from a hang.
                self._event("head_restore_skipped", entity="placement_group",
                            id=pg_id.hex(), reason=repr(e))
                print(
                    "ray_tpu_torch head: restore skipped placement group "
                    f"{pg_id.hex()}: {e!r}",
                    file=sys.stderr, flush=True,
                )
        # Named actors do NOT replay immediately: the field may still hold
        # the live instances (workers survive a head restart in headless
        # mode and re-register carrying their actors).  Stage the specs and
        # let the periodic loop replay whatever the resync grace window
        # leaves unclaimed — adoption of a live actor always beats
        # re-creating it fresh.
        staged = 0
        for name, spec in state.get("named_actors", {}).items():
            if name in self.named_actors:
                continue
            self._restore_named_pending[name] = spec
            staged += 1
        if staged:
            self._restore_named_deadline = (
                time.monotonic() + self.config.head_resync_grace_s
            )

    async def _replay_named_actor(self, name: str, spec: dict):
        """Re-create one snapshot-restored named actor that no field report
        claimed within the resync grace window."""
        if name in self.named_actors:
            return  # adopted (or re-created by a client) meanwhile
        ct = spec.get("creation_task", {})
        if ct.get("arg_ids") or ct.get("args_ref"):
            # Constructor args lived in the old session's shm — a
            # resubmit would dep-block forever and wedge the name.
            # Tombstone it so get_actor(name) explains the loss
            # instead of a bare "no actor with name".
            self.named_tombstones[name] = (
                "lost in head restart: the actor's constructor "
                "arguments lived in the previous session's object "
                "store and are not durable; re-create it with "
                "inline-serializable arguments to survive restarts"
            )
            self._event("head_restore_skipped", entity="named_actor",
                        id=name, reason="constructor args not durable")
            self._mark_dirty()
            return
        try:
            await self.h_create_actor(None, spec)
        except Exception as e:
            self._event("head_restore_skipped", entity="named_actor",
                        id=name, reason=repr(e))
            print(
                f"ray_tpu_torch head: restore skipped named actor {name!r}: "
                f"{e!r}",
                file=sys.stderr, flush=True,
            )

    async def h_batch(self, conn, body):
        """Mixed fire-and-forget batch: one RPC carries many submissions /
        task_done reports (clients batch bursts; per-message head processing
        is the control-plane throughput bound)."""
        for entry in body["entries"]:
            fn = self.server.handlers.get(entry["method"])
            if fn is None:
                continue
            try:
                result = fn(conn, entry["body"])
                if asyncio.iscoroutine(result):
                    await result
            except Exception:
                # Per-entry isolation: one bad spec must not drop the rest
                # of the batch (their callers would block forever).
                import traceback

                traceback.print_exc()
        return {}

    async def h_metrics_report(self, conn, body):
        """Per-process metric snapshots; the head keeps the latest rows per
        reporting pid and aggregates on read (reference: stats exported to
        the node metrics agent, src/ray/stats/metric_exporter.h)."""
        pid = body["pid"]
        stale = None
        if conn.meta.get("reconnected_pid") == pid:
            # Register-declared: only a driver that re-dialed with
            # reconnect=True (same process, same cumulative counters) may
            # un-retire its rows — a bare-pid match would let an unrelated
            # process with a recycled/colliding pid permanently decrement
            # the retired baseline.  The marker is consumed only once a
            # retired snapshot actually exists: on a half-open connection
            # the NEW conn's first report can land before the OLD conn's
            # disconnect is processed (which is when _retire_metrics folds
            # the rows in) — popping the marker early would leave that
            # later-retired copy permanently double-counted.
            stale = self._retired_by_pid.pop(pid, None)
            if stale is not None:
                conn.meta.pop("reconnected_pid", None)
        if stale:
            # The driver came back: its cumulative rows were folded into
            # the retired baseline at disconnect and are about to be
            # re-reported live — subtract the retired copy or every series
            # it owns doubles.
            for r in stale:
                neg = dict(r)
                neg["value"] = -r.get("value", 0)
                if "sum" in r:
                    neg["sum"] = -r["sum"]
                    neg["count"] = -r.get("count", 0)
                if r.get("buckets"):
                    neg["buckets"] = [-b for b in r["buckets"]]
                self._merge_metric_row(self._metrics_retired, neg)
        self.metrics_by_pid[pid] = body["rows"]
        return {}

    def _sample_telemetry(self):
        """One telemetry tick: refresh the head's built-in gauges and append
        a sample per live series to the retained history ring (the feed
        behind list_state(kind="metrics_history") and the dashboard's
        sparkline panels).  Skipped entirely inside the history's
        min-interval: the cross-process aggregation isn't free and the
        ring would drop the sample anyway."""
        now = time.time()
        if now - getattr(self, "_last_telemetry_sample", 0.0) \
                < self.metrics_history.min_interval_s:
            return
        self._last_telemetry_sample = now
        parked = sum(len(q) for q in self.node_parked.values())
        self.builtin_metrics.queue_depth.set(
            float(len(self.queued_tasks) + parked))
        try:
            # Cluster-wide store totals: the head's own store plus every
            # remote daemon's latest stats push (h_node_stats) — remote
            # nodes have no head-side ObjectStore object, only these dicts.
            totals = dict(self.store.stats())
            for k, v in self._store_retired.items():
                totals[k] = totals.get(k, 0) + v
            for st in self.node_stats.values():
                remote = (st or {}).get("store") or {}
                for k, v in remote.items():
                    if isinstance(v, (int, float)):
                        totals[k] = totals.get(k, 0) + v
            self.builtin_metrics.sample_store(totals)
        except Exception:
            pass
        rows = self.metrics_rows()
        self.metrics_history.record(rows)
        if self.config.health_enabled:
            try:
                self._health_tick(now, rows)
            except Exception:
                logger.exception("health tick failed")

    # -- health / incident plane (util/health.py) -----------------------------

    def _timed(self, name: str, fn):
        """Wrap one registered RPC handler with the per-method wall-time
        histogram (head self-observability: when the loop-lag detector
        fires, these rows say which handler ate the loop)."""
        hist = self.builtin_metrics.rpc_handler
        tags = {"method": name}

        async def timed(conn, body):
            t0 = time.perf_counter()
            try:
                return await fn(conn, body)
            finally:
                hist.observe(time.perf_counter() - t0, tags)

        return timed

    def _health_tick(self, now: float, rows: List[dict]) -> None:
        """One detector pass: hand the aggregated metric rows plus the
        in-window step records / devmem reports to the HealthEngine."""
        cfg = self.config
        horizon = now - max(cfg.health_window_s,
                            cfg.health_slo_slow_window_s / 4)
        steps: List[dict] = []
        for ring in self.engine_steps.values():
            steps.extend(r for r in ring
                         if isinstance(r.get("t"), (int, float))
                         and r["t"] >= horizon)
        profiles: List[dict] = []
        for st in self.gang_rounds.values():
            profiles.extend(pr for pr in st["profiles"]
                            if isinstance(pr.get("t"), (int, float))
                            and pr["t"] >= horizon)
        self.health.tick(
            now, rows, steps, self.devmem_by_pid, self._loop_lag_s,
            slo_targets=self._serve_slo_targets(),
            evidence=self._gather_evidence,
            gang_profiles=profiles)

    def _serve_slo_targets(self) -> Dict[str, float]:
        """TTFT/ITL targets for the burn-rate detector: explicit config
        wins; otherwise the strictest target any serve deployment declared
        (controller publishes them under kv 'serve_slo:<deployment>')."""
        cfg = self.config
        targets = {"ttft": cfg.health_slo_ttft_s, "itl": cfg.health_slo_itl_s}
        declared: Dict[str, List[float]] = {"ttft": [], "itl": []}
        for key, raw in self.kv.items():
            if not key.startswith("serve_slo:"):
                continue
            try:
                spec = json.loads(bytes(raw).decode())
            except Exception:
                continue
            for sig in ("ttft", "itl"):
                t = spec.get(sig)
                if isinstance(t, (int, float)) and t > 0:
                    declared[sig].append(float(t))
        for sig, vals in declared.items():
            if targets[sig] <= 0 and vals:
                targets[sig] = min(vals)
        return {k: v for k, v in targets.items() if v > 0}

    # Evidence callback handed to HealthEngine.tick — runs synchronously
    # inside _health_tick on the head loop.
    def _gather_evidence(self, f: dict, now: float) -> dict:  # rt-role: loop
        """Evidence chain captured when an incident opens: trace ids from
        the timeline ring (newest spans in the suspicion window), recent
        failure-shaped task events, the detector's own counter deltas /
        window stats, and — for head-pressure — the slowest RPC handlers."""
        window = max(60.0, self.config.health_window_s * 2)
        trace_ids: List[str] = []
        events: List[dict] = []
        for ev in reversed(self.task_events):
            if ev.get("ts", 0) < now - window:
                break
            kind = ev.get("kind", "")
            if kind == "span":
                tid = ev.get("trace_id")
                if tid and tid not in trace_ids and len(trace_ids) < 8:
                    trace_ids.append(tid)
            elif len(events) < 8 and any(
                    t in kind for t in ("fail", "death", "timeout",
                                        "lost", "oom", "quarantine")):
                events.append({k: v for k, v in ev.items()
                               if isinstance(v, (str, int, float, bool,
                                                 type(None)))})
        ev_chain: dict = {
            "window_s": window,
            "trace_ids": trace_ids,
            "task_events": events,
        }
        data = f.get("data") or {}
        if "deltas" in data:
            ev_chain["counter_deltas"] = data["deltas"]
        if f["kind"] in ("stall_pressure", "step_jitter"):
            ev_chain["step_window"] = {
                k: v for k, v in data.items() if k != "engine"}
        if f["kind"].startswith("gang_"):
            # Gang incidents: the offending rank/phase plus the worst
            # joined rounds from the suspicion window (the detector
            # already ranked them) — what `ray_tpu_torch doctor` replays.
            for k in ("rank", "phase", "gang", "worst_rounds",
                      "skew_frac", "data_frac", "coll_frac"):
                if k in data:
                    ev_chain[k] = data[k]
        if f["kind"] == "head_pressure":
            rows = self.builtin_metrics.rpc_handler._snapshot()
            slow = sorted(
                ((r.get("tags", {}).get("method", "?"),
                  r.get("sum", 0.0), r.get("count", 0)) for r in rows),
                key=lambda x: -x[1])[:5]
            ev_chain["slowest_handlers"] = [
                {"method": m, "total_s": round(s, 3), "calls": c}
                for m, s, c in slow if c]
        return ev_chain

    # Both incident sinks are HealthEngine callbacks invoked only from
    # _health_tick, i.e. on the head loop inside _periodic_loop.
    def _on_incident_open(self, inc: dict) -> None:  # rt-role: loop
        self.builtin_metrics.incidents_opened.inc(
            1.0, {"kind": inc["kind"]})
        self._event("incident_open", id=inc["id"], incident_kind=inc["kind"],
                    severity=inc["severity"], summary=inc["summary"])
        self._alert("opened", inc)

    def _on_incident_resolve(self, inc: dict) -> None:  # rt-role: loop
        self.builtin_metrics.incidents_resolved.inc(1.0)
        self._event("incident_resolve", id=inc["id"],
                    incident_kind=inc["kind"])
        self._alert("resolved", inc)

    def _alert(self, transition: str, inc: dict) -> None:
        """Push-style alerting: 'log' -> head log WARNING; http(s) URL ->
        fire-and-forget JSON POST on a daemon thread (a dead webhook must
        never block the head loop)."""
        sink = self.config.alert_sink
        if not sink:
            return
        if sink == "log":
            logger.warning("incident %s [%s/%s] %s: %s", transition,
                           inc["kind"], inc["severity"], inc["id"],
                           inc["summary"])
            return
        if sink.startswith("http"):
            payload = json.dumps({
                "transition": transition, "id": inc["id"],
                "kind": inc["kind"], "severity": inc["severity"],
                "summary": inc["summary"], "opened": inc["opened"],
            }).encode()

            def _post():
                import urllib.request
                try:
                    urllib.request.urlopen(urllib.request.Request(
                        sink, data=payload,
                        headers={"Content-Type": "application/json"}),
                        timeout=2.0)
                except Exception:
                    pass  # alerting is best-effort by design

            threading.Thread(target=_post, name="alert-sink",
                             daemon=True).start()

    @staticmethod
    def _merge_metric_row(agg: Dict[tuple, dict], r: dict) -> None:
        key = (r["name"], tuple(sorted(r.get("tags", {}).items())))
        cur = agg.get(key)
        if cur is None:
            agg[key] = dict(r)
        elif r["kind"] == "gauge":
            cur["value"] = r["value"]  # last writer wins
        else:
            cur["value"] = cur.get("value", 0) + r.get("value", 0)
            if "sum" in r:
                cur["sum"] = cur.get("sum", 0) + r["sum"]
                cur["count"] = cur.get("count", 0) + r["count"]
                if r.get("buckets") and cur.get("buckets"):
                    cur["buckets"] = [
                        a + b for a, b in
                        zip(cur["buckets"], r["buckets"])
                    ]

    def _retire_metrics(self, pid: int) -> None:
        """A reporting process disconnected: its counters/histograms must
        stay in the cluster totals (a counter vanishing reads as a negative
        rate to any scraper) — fold them into the retired accumulator.
        Gauges are point-in-time and die with the process."""
        rows = self.metrics_by_pid.pop(pid, None)
        if not rows:
            return
        kept = [r for r in rows if r.get("kind") in ("counter", "histogram")]
        for r in kept:
            self._merge_metric_row(self._metrics_retired, r)
        if kept:
            self._retired_by_pid[pid] = kept
            while len(self._retired_by_pid) > 1000:  # bound: evict oldest
                self._retired_by_pid.pop(next(iter(self._retired_by_pid)))

    def metrics_rows(self) -> List[dict]:
        """Aggregate across processes: counters/histogram counts sum, gauges
        keep the per-process latest.  The head's own built-in instruments
        (pid-less) and the counters of departed processes merge in
        alongside."""
        agg: Dict[tuple, dict] = {}
        for r in self._metrics_retired.values():
            self._merge_metric_row(agg, r)
        sources = dict(self.metrics_by_pid)
        sources[-1] = self.builtin_metrics.rows()  # head-internal builtins
        for pid, rows in sources.items():
            for r in rows:
                self._merge_metric_row(agg, r)
        return list(agg.values())

    async def h_put_object_batch(self, conn, body):
        """Registration batch for inline objects (client-side put buffering:
        one RPC per ~64 small puts instead of one each).  Entries may also
        carry an error blob or a shm descriptor (size + node) — the
        direct-call result registration path rides the same batch so a
        registration can never overtake the submission that references it."""
        for entry in body["objects"]:
            oid = ObjectID(entry["object_id"])
            rec = self._obj(oid)
            if entry.get("error") is not None:
                rec.error = entry["error"]
            elif entry.get("inline") is not None:
                rec.inline = entry["inline"]
                rec.size = len(rec.inline)
            elif entry.get("size") is not None:
                rec.size = entry["size"]
                node_id = NodeID(entry["node_id"])
                rec.locations.add(node_id)
                if not (entry.get("resync") and node_id != self.local_node_id):
                    # Resync manifests come FROM the owning node's daemon —
                    # it already accounts these segments; pushing adopt
                    # back at it for a whole manifest is pure noise.
                    self._adopt_local(oid, node_id)
            rec.sealed = True
            rec.ref_count = max(rec.ref_count, 1)
            self._notify_object_ready(oid)
        return {}

    def _adopt_local(self, oid: ObjectID, node_id: Optional[NodeID]):
        """Account a shm object with its node's store daemon (enables
        eviction, spilling, and shutdown cleanup): local objects go into the
        head's own store; remote ones get an adopt push to the node daemon."""
        if node_id == self.local_node_id:
            try:
                self.store.adopt(oid)
            except (FileNotFoundError, MemoryError):
                pass
            return
        daemon = self.node_daemons.get(node_id)
        if daemon is not None:
            asyncio.ensure_future(
                daemon.push("adopt_object", {"object_id": oid.binary()})
            )

    async def h_restore_object(self, conn, body):
        """Re-materialize a spilled object into shm so a reader can attach."""
        view = self.store.get(ObjectID(body["object_id"]))
        return {"ok": view is not None}

    async def h_store_stats(self, conn, body):
        return self.store.stats()

    async def h_add_object_ref(self, conn, body):
        for raw in body["object_ids"]:
            self._obj(ObjectID(raw)).ref_count += 1
        return {}

    async def h_free_objects(self, conn, body):
        items = []
        for raw in body["object_ids"]:
            oid = ObjectID(raw)
            rec = self.objects.get(oid)
            if rec is None:
                continue
            rec.ref_count -= 1
            if rec.ref_count <= 0:
                self.objects.pop(oid, None)
                self._drop_lineage_for(oid)
                items.append((raw, set(rec.locations)))
        if items:
            await self._deferred_free(items)
        return {"num_freed": len(items)}

    async def _deferred_free(self, items: List[tuple]):
        """Two-phase free: tell the processes that could hold a copy to drop
        it; release (and pool) the segments only after they ack a clean
        detach.  A reader whose user code still holds zero-copy views acks
        *dirty* and the inode is unlinked instead of pooled, so the views
        stay valid on the orphaned inode (reference: plasma keeps a buffer
        alive while any client holds a reference; here the detach-ack is the
        release edge).  Un-acked frees expire conservatively (no pooling)."""
        raws = [raw for raw, _ in items]
        locations: Set[NodeID] = set()
        for _, locs in items:
            locations.update(locs)
        conns = [
            c for c in self.server.connections.values()
            if c.meta.get("kind") in ("driver", "worker")
            and (c.meta.get("reader_node") in locations
                 # Proxy drivers have no node identity but may hold pulled
                 # private copies of anything — always notify them.
                 or c.meta.get("proxy"))
        ]
        if not conns:
            self._finalize_free(items, dirty=set())
            return
        self._free_token += 1
        token = self._free_token
        pf = {
            "items": items,
            "waiting": {c.conn_id for c in conns},
            "dirty": set(),
            "deadline": time.monotonic() + 2.0,
        }
        self._pending_frees[token] = pf
        body = {"object_ids": raws, "ack_token": token}
        for c in conns:
            try:
                await c.push("object_free", body)
            except Exception:
                pf["waiting"].discard(c.conn_id)
        if not pf["waiting"]:
            self._pending_frees.pop(token, None)
            self._finalize_free(items, dirty=set())

    async def h_object_free_ack(self, conn, body):
        pf = self._pending_frees.get(body["token"])
        if pf is None:
            return {}
        pf["waiting"].discard(conn.conn_id)
        pf["dirty"].update(body.get("dirty", ()))
        if not pf["waiting"]:
            self._pending_frees.pop(body["token"], None)
            self._finalize_free(pf["items"], pf["dirty"])
        return {}

    def _expire_pending_frees(self):
        now = time.monotonic()
        for token in list(self._pending_frees):
            pf = self._pending_frees[token]
            if now >= pf["deadline"]:
                self._pending_frees.pop(token, None)
                # Unknown reader state: never pool (views may be live).
                self._finalize_free(
                    pf["items"], dirty={raw for raw, _ in pf["items"]}
                )

    def _finalize_free(self, items: List[tuple], dirty: set):
        no_pool_by_node: Dict[NodeID, List[bytes]] = {}
        by_node: Dict[NodeID, List[bytes]] = {}
        for raw, locs in items:
            oid = ObjectID(raw)
            pool = raw not in dirty
            if not locs or self.local_node_id in locs:
                self.store.free(oid, pool=pool)
            for node_id in locs:
                if node_id == self.local_node_id:
                    continue
                by_node.setdefault(node_id, []).append(raw)
                if not pool:
                    no_pool_by_node.setdefault(node_id, []).append(raw)
        for node_id, raws in by_node.items():
            daemon = self.node_daemons.get(node_id)
            if daemon is not None:
                asyncio.ensure_future(daemon.push("free_objects", {
                    "object_ids": raws,
                    "no_pool": no_pool_by_node.get(node_id, []),
                }))

    def _object_wire(self, rec: ObjectRecord,
                     prefer: Optional[NodeID] = None) -> dict:
        if rec.error is not None:
            return {"error": rec.error}
        if rec.inline is not None:
            return {"inline": rec.inline}
        # Prefer a copy on the reader's own node (shm attach, zero-copy);
        # otherwise a RANDOM live location: each completed pull registers a
        # new replica (from_pull), so a hot object's readers fan out across
        # replicas and a broadcast forms an organic distribution tree
        # instead of hammering the origin node (reference:
        # object_manager.h:125-139 spreads pulls over known locations).
        if prefer is not None and prefer in rec.locations:
            loc = prefer
        elif len(rec.locations) > 1:
            import random as _random

            loc = _random.choice(list(rec.locations))
        else:
            loc = next(iter(rec.locations), None)
        return {
            "size": rec.size,
            "session": self.node_sessions.get(loc, self.session),
            "node_id": loc.binary() if loc else None,
            "addr": self.node_object_addrs.get(loc),
            "bulk_addr": self.node_bulk_addrs.get(loc),
        }

    async def h_get_objects(self, conn, body):
        timeout = body.get("timeout", -1.0)
        deadline = None if timeout < 0 else time.monotonic() + timeout
        prefer = conn.meta.get("reader_node")
        out = []
        for raw in body["object_ids"]:
            oid = ObjectID(raw)
            rec = self._obj(oid)
            while not rec.sealed:
                ev = asyncio.Event()
                self.object_waiters.setdefault(oid, []).append(ev)
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    out.append({"timeout": True})
                    break
                try:
                    await asyncio.wait_for(ev.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    out.append({"timeout": True})
                    break
            else:
                out.append(self._object_wire(rec, prefer))
        return {"objects": out}

    async def h_object_sizes(self, conn, body):
        """Sizes of sealed objects (None while unsealed) — lets the Data
        executor's byte-budget backpressure learn block sizes without
        fetching them (reference: BlockMetadata.size_bytes feeding
        execution/resource_manager.py budgets)."""
        out = []
        for raw in body["object_ids"]:
            rec = self.objects.get(ObjectID(raw))
            out.append(rec.size if rec is not None and rec.sealed else None)
        return {"sizes": out}

    async def h_wait_objects(self, conn, body):
        oids = [ObjectID(raw) for raw in body["object_ids"]]
        num_returns = body.get("num_returns", 1)
        timeout = body.get("timeout", -1.0)
        deadline = None if timeout < 0 else time.monotonic() + timeout

        def ready_ids():
            return [o for o in oids if self.objects.get(o) and self.objects[o].sealed]

        while len(ready_ids()) < num_returns:
            evs = []
            for o in oids:
                rec = self._obj(o)
                if not rec.sealed:
                    ev = asyncio.Event()
                    self.object_waiters.setdefault(o, []).append(ev)
                    evs.append(ev)
            if not evs:
                break
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            waits = [asyncio.ensure_future(e.wait()) for e in evs]
            done, pending = await asyncio.wait(
                waits, timeout=remaining, return_when=asyncio.FIRST_COMPLETED
            )
            for p in pending:
                p.cancel()
            if not done:
                break
        ready = set(ready_ids())
        return {
            "ready": [o.binary() for o in oids if o in ready],
            "not_ready": [o.binary() for o in oids if o not in ready],
        }

    # -- tasks -----------------------------------------------------------------

    def _register_task(self, task: TaskRecord):
        """Common bookkeeping: return-object lineage, dependency tracking, and
        pinning of argument objects for the task's lifetime (the simplified
        analog of the reference's borrowed-reference pinning,
        reference_count.h:61)."""
        self.tasks[task.task_id] = task
        for raw in task.spec.get("return_ids", []):
            if task.spec.get("_reconstruct"):
                # Freed sibling returns stay freed: resurrecting them via
                # _obj would create unowned records nothing ever decrefs.
                rec = self.objects.get(ObjectID(raw))
                if rec is not None:
                    rec.task_id = task.task_id
            else:
                self._obj(ObjectID(raw)).task_id = task.task_id
        for raw in task.spec.get("arg_ids", []):
            oid = ObjectID(raw)
            rec = self._obj(oid)
            rec.ref_count += 1  # unpinned at task finalization
            if not rec.sealed:
                task.pending_deps.add(oid)
                self.tasks_waiting_on.setdefault(oid, set()).add(task.task_id)

    def _lineage_eligible(self, task: TaskRecord) -> bool:
        retries = task.spec.get(
            "max_retries", self.config.default_task_max_retries
        )
        if not (
            task.state == FINISHED
            and self.config.lineage_max_entries > 0
            and retries != 0  # max_retries=0: reconstruction disabled anyway
            and not task.spec.get("actor_id")
            and not task.spec.get("is_actor_creation")
            and task.spec.get("num_returns") != "streaming"
        ):
            return False
        # Inline returns live in head memory and survive node death — no
        # reconstruction needed, so don't pin args for them.
        return any(
            ObjectID(raw) in self.objects
            and self.objects[ObjectID(raw)].inline is None
            for raw in task.spec.get("return_ids", [])
        )

    def _unpin_spec(self, spec: dict, include_args_ref: bool = True):
        """Release the arg pins held by a lineage entry."""
        for raw in spec.get("arg_ids", []):
            self._decref(ObjectID(raw))
        if include_args_ref and spec.get("args_ref") is not None:
            self._decref(ObjectID(spec["args_ref"]))

    def _drop_lineage_for(self, oid: ObjectID):
        """Drop a task's lineage entry once none of its return objects are
        referenced anymore (the entry exists to recompute exactly those)."""
        tid = oid.task_id()
        spec = self.lineage.get(tid)
        if spec is None:
            return
        if any(ObjectID(raw) in self.objects
               for raw in spec.get("return_ids", [])):
            return
        del self.lineage[tid]
        self.reconstruction_counts.pop(tid, None)
        self._unpin_spec(spec)

    def _fail_object(self, oid: ObjectID, exc: Exception):
        rec = self._obj(oid)
        rec.error = serialization.pack(exc)
        rec.sealed = True
        self._notify_object_ready(oid)

    def _maybe_reconstruct(self, oid: ObjectID, depth: int = 0) -> bool:
        """Recompute a lost object by re-running its creating task (the
        ObjectID embeds it).  Returns True when the object is available, in
        flight, or now being reconstructed; False when it was failed with
        ObjectReconstructionFailedError (reference:
        object_recovery_manager.h:90 RecoverObject)."""
        from ..exceptions import ObjectReconstructionFailedError

        rec = self.objects.get(oid)
        if rec is None:
            return False  # freed: nothing to recover, nobody waiting
        if rec.inline is not None or rec.locations:
            return True
        tid = oid.task_id()
        live = self.tasks.get(tid)
        if live is not None and live.state in (PENDING, RUNNING):
            rec.sealed = False  # already being (re)computed: getters block
            rec.error = None
            return True
        spec = self.lineage.get(tid)
        if spec is None or depth > 8:
            self._fail_object(oid, ObjectReconstructionFailedError(
                f"object {oid.hex()} lost and "
                + ("reconstruction depth limit reached" if spec is not None
                   else "no lineage is available (task spec dropped, "
                        "put object, or max_retries=0)")
            ))
            return False
        retries = spec.get("max_retries", self.config.default_task_max_retries)
        count = self.reconstruction_counts.get(tid, 0)
        if retries >= 0 and count >= max(retries, 0):
            self._fail_object(oid, ObjectReconstructionFailedError(
                f"object {oid.hex()} lost and reconstruction attempts "
                f"exhausted ({count}/{retries})"
            ))
            return False
        self.reconstruction_counts[tid] = count + 1
        # Unseal the still-referenced LOST returns of the task (the re-run
        # recomputes them); freed siblings stay freed — resurrecting them
        # via _obj would create unowned records nothing ever decrefs — and
        # siblings with a live copy (or inline data) must stay readable
        # (a failed re-run must not overwrite them with an error).
        for raw in spec.get("return_ids", []):
            r = self.objects.get(ObjectID(raw))
            if r is not None and r.inline is None and not r.locations:
                r.sealed = False
                r.error = None
        # Recursively recover lost inputs first (their specs are pinned by
        # this entry); the resubmitted task dep-blocks on them via
        # _register_task until they reseal.
        for raw in spec.get("arg_ids", []):
            self._maybe_reconstruct(ObjectID(raw), depth + 1)
        if spec.get("args_ref") is not None:
            self._maybe_reconstruct(ObjectID(spec["args_ref"]), depth + 1)
        run_spec = spec
        strat = spec.get("strategy")
        if strat and strat.get("kind") == "node_affinity":
            nid = NodeID(strat["node_id"])
            node = self.scheduler.nodes.get(nid)
            if node is None or not node.alive:
                # The anchor died with the object; a hard affinity would make
                # the re-run unschedulable forever.
                run_spec = {**spec, "strategy": None}
        if run_spec is spec:
            run_spec = dict(spec)
        run_spec["_reconstruct"] = True
        task = TaskRecord(run_spec)
        self._register_task(task)
        self._event("task_reconstruction", task=tid.hex(),
                    object=oid.hex(), attempt=count + 1)
        if not task.pending_deps:
            self._enqueue_task(task)
        self._kick()
        return True

    async def h_reconstruct_object(self, conn, body):
        """Client-requested recovery (its pull found every location gone)."""
        oid = ObjectID(body["object_id"])
        rec = self.objects.get(oid)
        if rec is not None and rec.sealed and not rec.inline:
            # Drop locations the client proved stale (node died unannounced).
            dead = {
                loc for loc in rec.locations
                if loc != self.local_node_id and loc not in self.node_daemons
            }
            rec.locations -= dead
        return {"queued": self._maybe_reconstruct(oid)}

    def _decref(self, oid: ObjectID):
        rec = self.objects.get(oid)
        if rec is None:
            return
        rec.ref_count -= 1
        if rec.ref_count <= 0:
            self.objects.pop(oid, None)
            self._drop_lineage_for(oid)
            asyncio.ensure_future(
                self._deferred_free([(oid.binary(), set(rec.locations))])
            )

    def _unpin_task_args(self, task: TaskRecord):
        for raw in task.spec.get("arg_ids", []):
            oid = ObjectID(raw)
            self._decref(oid)
            waiting = self.tasks_waiting_on.get(oid)
            if waiting is not None:
                waiting.discard(task.task_id)
                if not waiting:
                    self.tasks_waiting_on.pop(oid, None)

    def _finalize_task(self, task: TaskRecord):
        """Terminal-state cleanup: either transfer the task's arg pins to a
        lineage entry (so a lost output can be recomputed by re-running the
        spec — reference: reference_count.h:75 lineage pinning) or unpin."""
        if self._lineage_eligible(task):
            old = self.lineage.pop(task.task_id, None)
            self.lineage[task.task_id] = task.spec
            if old is not None:
                # Re-recorded after reconstruction: the fresh registration
                # re-pinned arg_ids (but never args_ref — _register_task
                # doesn't pin it), so release only the re-pinned part.
                self._unpin_spec(old, include_args_ref=False)
            while len(self.lineage) > self.config.lineage_max_entries:
                etid, evicted = self.lineage.popitem(last=False)
                self.reconstruction_counts.pop(etid, None)
                self._unpin_spec(evicted)
        else:
            self._unpin_task_args(task)
            # The large-args spill object is pinned only by its creation
            # reference; it dies with the task — except for the creation task
            # of a live actor, whose restart resubmits the same spec and must
            # be able to re-read the args (freed at permanent actor death).
            args_ref = task.spec.get("args_ref")
            # A lineage entry for this task still holds the args_ref pin
            # (e.g. a failed reconstruction re-run): leave it to the entry.
            if args_ref is not None and task.task_id not in self.lineage:
                keep = False
                if task.spec.get("is_actor_creation"):
                    actor = self.actors.get(ActorID(task.spec["actor_id"]))
                    keep = actor is not None and actor.state != "DEAD"
                if not keep:
                    self._decref(ObjectID(args_ref))
        self.finished_tasks.append(
            {
                "task_id": task.task_id.hex(),
                "name": task.spec.get("name", ""),
                "state": task.state,
                "start_time": task.start_time,
                "end_time": task.end_time,
                "error": task.error,
            }
        )
        # Streaming task records stay (next_stream_item consults their state);
        # creation task records stay while the actor lives (its death releases
        # the creation resources via this record).
        if not (
            task.spec.get("num_returns") == "streaming"
            or task.spec.get("is_actor_creation")
        ):
            self.tasks.pop(task.task_id, None)

    async def h_submit_task(self, conn, body):
        task = TaskRecord(body)
        self._register_task(task)
        self._task_transition(task, "SUBMITTED")
        self._event("task_submitted", task=task.task_id.hex(), name=body.get("name", ""))
        if not task.pending_deps:
            self._enqueue_task(task)
            self._kick()
        return {}

    def _enqueue_task(self, task: "TaskRecord", front: bool = False):
        if front:
            self.queued_tasks.appendleft(task)
        else:
            self.queued_tasks.append(task)
        k = task.shape_key()
        self.queue_shapes[k] = self.queue_shapes.get(k, 0) + 1

    def _dequeue_shape(self, task: "TaskRecord"):
        k = task.shape_key()
        n = self.queue_shapes.get(k, 0) - 1
        if n <= 0:
            self.queue_shapes.pop(k, None)
        else:
            self.queue_shapes[k] = n

    async def _dispatch_loop(self):
        """Single dispatch pass: match queued tasks to idle workers.

        The analog of LocalTaskManager::ScheduleAndDispatchTasks
        (reference: src/ray/raylet/local_task_manager.h:58).  Placement is
        *sticky*: once the scheduler picks a node the task acquires that
        node's resources and parks in its per-node queue until a worker
        there is idle — a warm node's workers must not drain the queue while
        a cold node's workers are still starting (reference:
        spread_scheduling_policy.h + local_task_manager.h keep the lease on
        the chosen raylet while its worker pool spins up)."""
        if self._shutdown:
            return
        if self.pgs_needing_bundles:
            self._try_reschedule_bundles()
        if self.pending_pgs:
            self._try_pending_pgs()
        await self._drain_parked()
        made_progress = True
        while made_progress and self.queued_tasks:
            made_progress = False
            requeue: List[TaskRecord] = []
            # Resource shapes that already failed to place this pass: later
            # tasks with the same shape fail identically, so skip them — a
            # 10k-task homogeneous burst costs one placement failure per
            # pass, not 10k (reference: cluster_task_manager.h groups tasks
            # by SchedulingClass for exactly this reason).
            failed_shapes: set = set()
            while self.queued_tasks:
                task = self.queued_tasks.popleft()
                self._dequeue_shape(task)
                if task.state != PENDING:
                    continue
                shape = task.shape_key()
                if shape in failed_shapes:
                    requeue.append(task)
                    if all(k in failed_shapes for k in self.queue_shapes):
                        break  # nothing left in the queue can place
                    continue
                node_id = self.scheduler.pick_node(task.resources, task.strategy)
                if node_id is None:
                    failed_shapes.add(shape)
                    requeue.append(task)
                    if all(k in failed_shapes for k in self.queue_shapes):
                        break  # nothing left in the queue can place
                    continue
                if not self.scheduler.acquire(node_id, task.resources, task.strategy):
                    failed_shapes.add(shape)
                    requeue.append(task)
                    if all(k in failed_shapes for k in self.queue_shapes):
                        break  # nothing left in the queue can place
                    continue
                self._task_transition(task, "SCHEDULED", node=node_id)
                worker = self._find_idle_worker(
                    node_id, fresh=self._needs_gpu_grant(task)
                )
                if worker is None:
                    # Commit to the picked node: hold the resources, park
                    # until a worker registers or frees up there.  Actors get
                    # dedicated processes beyond the task-worker cap; plain
                    # tasks respect the cap.
                    self._maybe_spawn(
                        node_id,
                        force=bool(task.spec.get("is_actor_creation"))
                        or self._needs_gpu_grant(task),
                    )
                    task.parked_node = node_id
                    task.park_time = time.monotonic()
                    self.node_parked.setdefault(node_id, deque()).append(task)
                    made_progress = True  # resource state changed
                    continue
                if not await self._dispatch(task, worker):
                    # GPU-starved: floats freed up but no concrete GPU IDs
                    # yet (a blocked holder's process still holds them).
                    self.scheduler.release(
                        node_id, task.resources, task.strategy
                    )
                    failed_shapes.add(shape)
                    requeue.append(task)
                    continue
                made_progress = True
            # Requeue at the FRONT (reversed) so submission order within a
            # shape survives an early-exit pass.
            for t in reversed(requeue):
                self._enqueue_task(t, front=True)
        if self.queued_tasks and self.leases:
            # Queued work that couldn't place while slots are leased out:
            # preempt the stalest lease so head-scheduled shapes (gangs,
            # GPU grants, bigger bundles) can't be starved by direct-plane
            # reservations.  Age-gated (a momentary queue blip during a
            # burst must not revoke a lease the burst is about to use),
            # one per pass, with a cooldown.
            now = time.monotonic()
            oldest_wait = max(
                (time.time() - t.submit_time for t in self.queued_tasks
                 if t.state == PENDING), default=0.0)
            if oldest_wait > 0.5 and now - self._last_lease_preempt > 0.2:
                candidates = [
                    (lease["expires"], lid)
                    for lid, lease in self.leases.items()
                    if lease["revoke_deadline"] is None
                ]
                if candidates:
                    self._last_lease_preempt = now
                    await self._revoke_lease(min(candidates)[1], "preempted")

    async def _drain_parked(self):
        """Dispatch node-committed tasks to workers that have become idle.
        Resources were acquired at park time — no re-acquire here."""
        for node_id in list(self.node_parked):
            q = self.node_parked.get(node_id)
            while q:
                task = q[0]
                if task.state != PENDING:
                    q.popleft()
                    continue
                worker = self._find_idle_worker(
                    node_id, fresh=self._needs_gpu_grant(task)
                )
                if worker is None:
                    self._maybe_spawn(
                        node_id,
                        force=bool(task.spec.get("is_actor_creation"))
                        or self._needs_gpu_grant(task),
                    )
                    break
                # Pop BEFORE the dispatch await: a concurrent pass must not
                # see an already-dispatched task at q[0] (it would pop it
                # and this coroutine's pop would then drop the next task).
                q.popleft()
                task.parked_node = None
                if not await self._dispatch(task, worker):
                    # GPU-starved: _dispatch refused before any await, so
                    # no other pass ran in between — put it back at the
                    # front and stay parked (resources held) until the
                    # retiring holder's process exits and frees the IDs.
                    task.parked_node = node_id
                    q.appendleft(task)
                    break
            if not q:
                self.node_parked.pop(node_id, None)

    def _unpark(self, task: TaskRecord, release: bool = True):
        """Pull a task out of its node's parked queue (cancable/stale paths),
        optionally releasing the committed resources."""
        node_id = task.parked_node
        if node_id is None:
            return
        task.parked_node = None
        q = self.node_parked.get(node_id)
        if q is not None:
            try:
                q.remove(task)
            except ValueError:
                pass
        if release:
            self.scheduler.release(node_id, task.resources, task.strategy)

    def _try_reschedule_bundles(self):
        for pg_id in list(self.pgs_needing_bundles):
            if self.scheduler.reschedule_lost_bundles(pg_id):
                self.pgs_needing_bundles.discard(pg_id)

    @staticmethod
    def _needs_gpu_grant(task: TaskRecord) -> bool:
        # Actor METHOD tasks run in the actor's process, which got its grant
        # at creation.  Fractional (<1) requests are admission-only time
        # sharing: no grant, so such a task sees no card.
        return (int(task.resources.get("GPU", 0)) >= 1
                and not task.is_actor_task)

    def _find_idle_worker(
        self, node_id: NodeID, fresh: bool = False
    ) -> Optional[WorkerState]:
        for w in self.workers.values():
            if w.node_id == node_id and w.state == IDLE and w.conn.alive \
                    and not (fresh and w.used):
                return w
        return None

    def _maybe_spawn(self, node_id: NodeID, force: bool = False):
        cap = self.node_worker_caps.get(node_id, 0)
        # Actor-dedicated workers don't count against the task-worker pool cap
        # (reference: worker_pool.h tracks dedicated vs shared workers).
        count = 0
        blocked = 0
        for w in self.workers.values():
            if w.node_id != node_id:
                continue
            if w.state in (STARTING, IDLE, LEASED):
                count += 1
            elif w.state in (BLOCKED, DIRECT):
                # Direct-leased workers are spoken for by a client's lease,
                # not by this pool: like blocked workers, each permits one
                # extra spawn (else a driver leasing the whole pool would
                # starve head-scheduled tasks of processes), bounded by the
                # same hard cap.
                blocked += 1
        pending = self._spawn_pending.get(node_id, 0)
        # Blocked workers each permit one extra pool slot (their task's
        # resources were released), but total live processes are hard-capped
        # so a deeply nested get chain can't fork without bound.
        hard_cap = max(cap, 1) * self.config.worker_pool_hard_cap_multiple
        if count + blocked + pending >= hard_cap:
            return
        if count + pending < cap:
            self._spawn_worker(node_id)
            return
        if force:
            # Actor-creation tasks get dedicated processes: spawn one per
            # parked creation so a burst of actors starts in parallel instead
            # of one process per spawn-roundtrip (reference: worker_pool.h
            # maximum_startup_concurrency governs parallel worker startup).
            # `current_parked`: the caller's task is already in node_parked
            # (_drain_parked) or about to be parked (_dispatch_loop) — count
            # it exactly once either way.
            parked_creations = sum(
                1 for t in self.node_parked.get(node_id, ())
                if t.spec.get("is_actor_creation")
                or self._needs_gpu_grant(t)
            )
            needed = max(parked_creations, 1)
            for _ in range(min(needed - pending,
                               hard_cap - (count + blocked + pending))):
                self._spawn_worker(node_id)

    async def _dispatch(self, task: TaskRecord, worker: WorkerState) -> bool:
        # Tasks that hold scheduler resources and request whole cards get
        # concrete GPU IDs so the worker can set CUDA_VISIBLE_DEVICES at
        # task start.  No IDs free (a blocked GPU-holder released its float
        # but its process still holds the cards): refuse to dispatch —
        # running the task without a grant would leave it no card.
        n_gpu = int(task.resources.get("GPU", 0))
        if n_gpu >= 1 and not task.is_actor_task:
            task.gpus = self.scheduler.allocate_gpus(worker.node_id, n_gpu)
            if task.gpus is None:
                return False
            worker.gpus.extend(task.gpus)
            task.spec["gpus"] = task.gpus
        else:
            task.spec.pop("gpus", None)
        task.state = RUNNING
        task.worker_id = worker.worker_id
        task.node_id = worker.node_id
        worker.used = True
        # Scheduling latency counts only up to the FIRST dispatch: a retry
        # after a worker death would otherwise fold the failed attempt's
        # execution time into the histogram.
        if task.start_time == 0.0:
            self.builtin_metrics.submit_to_start.observe(
                max(0.0, time.time() - task.submit_time))
        task.start_time = time.time()
        self.builtin_metrics.tasks_dispatched.inc()
        worker.last_seen = time.monotonic()
        is_actor_creation = task.spec.get("is_actor_creation", False)
        worker.state = ACTOR if is_actor_creation else LEASED
        worker.inflight.add(task.task_id)
        self._task_transition(task, "RUNNING")
        self._event("task_dispatched", task=task.task_id.hex(),
                    worker=worker.worker_id.hex())
        if is_actor_creation:
            actor_id = ActorID(task.spec["actor_id"])
            actor = self.actors[actor_id]
            actor.worker_id = worker.worker_id
            actor.node_id = worker.node_id
            worker.actor_id = actor_id
            # Log-index linkage: `ray_tpu_torch logs <actor_id>` resolves to the
            # hosting worker's file (retained after the actor dies).
            log_entry = self.log_index.get(worker.worker_id.hex())
            if log_entry is not None:
                log_entry["actor_id"] = actor_id.hex()
        await worker.conn.push("execute_task", task.spec)
        return True

    async def h_task_done(self, conn, body):
        task_id = TaskID(body["task_id"])
        task = self.tasks.get(task_id)
        worker_id = self.conn_to_worker.get(conn.conn_id)
        worker = self.workers.get(worker_id) if worker_id else None
        if task is None:
            # Unknown task: either a stale duplicate, or a completion that
            # outlived a HEAD RESTART (the worker kept executing headless
            # and replayed the report after resync — the task record died
            # with the old head).  Only the restart case may seal: the
            # resync grace window is the discriminator.  A same-head blip
            # replay (task already requeued, run elsewhere, maybe freed)
            # must be DROPPED — sealing would resurrect freed records with
            # a ref nothing owns.
            if time.monotonic() < self._resync_grace_until:
                self._seal_orphan_returns(body, worker)
            return {}
        failed = body.get("error") is not None
        actor_creation = task.spec.get("is_actor_creation", False)

        # Application-level retryable error: resubmit.
        if failed and task.retries_left != 0 and body.get("retryable", False):
            task.retries_left -= 1
            task.state = PENDING
            self._release_task_resources(task, worker)
            self._task_transition(task, "RETRYING",
                                  error=body.get("error_repr", ""))
            task.worker_id = None
            task.node_id = None
            if task.is_actor_task:
                actor = self.actors.get(ActorID(task.spec["actor_id"]))
                if actor is not None and actor.state != "DEAD":
                    actor.pending_tasks.appendleft(task)
                    if actor.state == "ALIVE":
                        await self._drain_actor_queue(actor)
                    return {}
                # fall through: actor gone, give up and record the failure
                task.retries_left = 0
            else:
                self._enqueue_task(task)
                self._kick()
                return {}

        task.state = FAILED if failed else FINISHED
        task.end_time = time.time()
        if failed:
            task.error = body.get("error_repr", "")
            self._task_transition(
                task, FAILED, error=task.error,
                traceback_text=body.get("error_tb")
                or body.get("error_repr", ""),
            )
        else:
            self._task_transition(task, FINISHED)
        for ret in body.get("returns", []):
            oid = ObjectID(ret["object_id"])
            if task.spec.get("_reconstruct") and oid not in self.objects:
                # A freed sibling recomputed during reconstruction: nobody
                # references it — drop the stored copy instead of
                # resurrecting the record (mirrors the from_pull guard).
                if not failed and ret.get("inline") is None and worker:
                    self._adopt_local(oid, worker.node_id)
                    if worker.node_id == self.local_node_id:
                        self.store.free(oid)
                    else:
                        daemon = self.node_daemons.get(worker.node_id)
                        if daemon is not None:
                            asyncio.ensure_future(daemon.push(
                                "free_objects", {"object_ids": [ret["object_id"]]}
                            ))
                continue
            rec = self._obj(oid)
            if failed:
                if rec.sealed and (rec.inline is not None or rec.locations):
                    # A live sibling a reconstruction re-run didn't need:
                    # the failure must not clobber its valid data.
                    continue
                rec.error = body["error"]
            elif ret.get("inline") is not None:
                rec.error = None  # e.g. re-sealed by a restarted actor creation
                rec.inline = ret["inline"]
                rec.size = len(rec.inline)
            else:
                rec.error = None
                rec.size = ret["size"]
                loc = worker.node_id if worker else self.local_node_id
                rec.locations.add(loc)
                self._adopt_local(oid, loc)
            rec.sealed = True
            self._notify_object_ready(oid)
        if task.spec.get("num_returns") == "streaming":
            self.stream_done[task_id] = body.get("stream_count", 0)
            for key, evs in list(self.stream_waiters.items()):
                if key[0] == task_id.binary():
                    for ev in self.stream_waiters.pop(key):
                        ev.set()
        self._event("task_done", task=task_id.hex(), failed=failed)

        if actor_creation:
            actor_id = ActorID(task.spec["actor_id"])
            actor = self.actors.get(actor_id)
            if actor:
                if failed:
                    actor.state = "DEAD"
                    self._mark_dirty()  # drop from the snapshot
                    actor.death_cause = body.get("error_repr", "creation failed")
                    await self._fail_actor_queue(actor, body.get("error"))
                    await self._publish_actor_event(actor, "DEAD")
                    if worker:
                        worker.state = IDLE
                        worker.actor_id = None
                else:
                    actor.state = "ALIVE"
                    await self._publish(
                        f"actor:{actor_id.hex()}", {"state": "ALIVE"}
                    )
                    # Route broadcast with the hosting worker's peer
                    # address: creating clients pre-dial during creation
                    # dispatch (no first-call handshake cliff).
                    await self._publish_actor_event(actor, "ALIVE")
                    await self._drain_actor_queue(actor)
            self._release_task_resources(task, worker, keep_worker_busy=not failed)
        elif task.spec.get("actor_id"):
            actor = self.actors.get(ActorID(task.spec["actor_id"]))
            if actor:
                actor.num_executed += 1
            self._release_task_resources(task, worker, keep_worker_busy=True)
        else:
            self._release_task_resources(task, worker)
        self._finalize_task(task)
        self._kick()
        return {}

    def _seal_orphan_returns(self, body, worker: Optional[WorkerState]):
        """Seal return objects of a task this head has no record of (a
        completion replayed across a head restart).  Only objects someone
        can still reach matter, but the creator's ref is alive by
        construction (the submitting driver survived the head, or the
        report wouldn't have been replayed) — so register unconditionally;
        the creator's eventual free reclaims the record."""
        returns = body.get("returns") or []
        if not returns:
            return
        failed = body.get("error") is not None
        sealed = 0
        for ret in returns:
            oid = ObjectID(ret["object_id"])
            rec = self._obj(oid)
            if failed:
                if rec.sealed and (rec.inline is not None or rec.locations):
                    continue  # never clobber live data with a late failure
                rec.error = body["error"]
            elif ret.get("inline") is not None:
                rec.error = None
                rec.inline = ret["inline"]
                rec.size = len(rec.inline)
            elif ret.get("size") is not None:
                rec.error = None
                rec.size = ret["size"]
                loc = worker.node_id if worker else self.local_node_id
                rec.locations.add(loc)
                self._adopt_local(oid, loc)
            else:
                continue
            rec.sealed = True
            sealed += 1
            self._notify_object_ready(oid)
        if sealed:
            self._event("task_done", task=TaskID(body["task_id"]).hex(),
                        failed=failed, orphan=True)

    def _retire_worker(self, worker: WorkerState):
        """Tell a GPU-granted pooled worker to exit: its process keeps its
        CUDA context on the cards, so the GPU IDs only become reusable at
        process death (reference: raylet kills GPU workers whose
        CUDA_VISIBLE_DEVICES grant must be reclaimed rather than re-leasing
        the process)."""
        if worker.state in (DEAD, RETIRING):
            return
        worker.state = RETIRING
        if worker.conn.alive:
            async def _push_exit():
                try:
                    await worker.conn.push("exit", {})
                except Exception:
                    pass  # racing the SIGTERM below is expected

            asyncio.ensure_future(_push_exit())
        if worker.node_id == self.local_node_id:
            # Belt and braces for wedged processes; remote nodes reap via
            # their daemon when the connection drops.
            try:
                os.kill(worker.pid, 15)
            except (ProcessLookupError, PermissionError):
                pass

    def _release_task_resources(self, task, worker, keep_worker_busy=False):
        if task.is_actor_task:
            release = False  # actor method tasks hold no scheduler resources
        elif task.spec.get("is_actor_creation"):
            # A live actor keeps its creation resources until death.
            release = task.state in (FAILED, PENDING)
        else:
            release = True
        # A task still flagged blocked already released its resources in
        # h_task_blocked (e.g. its unblock RPC was lost).
        if release and task.node_id is not None and not task.blocked:
            self.scheduler.release(task.node_id, task.resources, task.strategy)
        if release and task.gpus and worker is not None:
            # The worker ran with a GPU grant; the grant dies with the
            # process (GPUs freed in _handle_worker_death).
            self._retire_worker(worker)
        task.blocked = False
        if worker:
            worker.inflight.discard(task.task_id)
            worker.last_seen = time.monotonic()
            if not keep_worker_busy and worker.state not in (RETIRING, DEAD):
                worker.state = IDLE

    # -- blocked workers (reference: raylet releases the CPU lease while a
    # worker blocks in ray.get; worker_pool.h spawns past the cap for it) ----

    async def h_task_blocked(self, conn, body):
        worker_id = self.conn_to_worker.get(conn.conn_id)
        worker = self.workers.get(worker_id) if worker_id else None
        task = self.tasks.get(TaskID(body["task_id"]))
        if (task is None or worker is None or task.blocked
                or task.state != RUNNING or worker.state != LEASED
                or task.is_actor_task):
            return {}
        task.blocked = True
        worker.state = BLOCKED
        self.scheduler.release(task.node_id, task.resources, task.strategy)
        self._kick()  # freed resources may unblock queued tasks
        return {}

    async def h_task_unblocked(self, conn, body):
        worker_id = self.conn_to_worker.get(conn.conn_id)
        worker = self.workers.get(worker_id) if worker_id else None
        task = self.tasks.get(TaskID(body["task_id"]))
        if task is None or not task.blocked:
            return {}
        task.blocked = False
        if worker is not None and worker.state == BLOCKED:
            worker.state = LEASED
        # Oversubscribes transiently if the freed resources were re-used;
        # self-corrects as running tasks finish.
        self.scheduler.acquire_force(task.node_id, task.resources, task.strategy)
        return {}

    async def h_health_ack(self, conn, body):
        worker_id = self.conn_to_worker.get(conn.conn_id)
        w = self.workers.get(worker_id) if worker_id else None
        if w is not None:
            w.last_ack = time.monotonic()
        return {}

    async def h_span_batch(self, conn, body):
        """Batched finished tracing spans from any process -> timeline
        ring (reference: task events flow to GcsTaskManager via
        task_event_buffer.h in batches; `ray timeline` reads them back).
        One RPC carries a whole ring flush — the span plane never pays a
        head dispatch per span; malformed entries are skipped so one bad
        emitter can't drop a process's whole batch."""
        for span in body["spans"]:
            if not isinstance(span, dict) or not span.get("trace_id") \
                    or not span.get("span_id"):
                continue
            self._event("span", **{k: span.get(k) for k in (
                "trace_id", "span_id", "parent_id", "name", "start", "end",
                "pid", "attrs",
            )})
            # Task execution spans feed the built-in duration histogram —
            # the trace↔metrics link: the same span that draws the
            # timeline bar contributes to ray_tpu_task_duration_seconds.
            start, end = span.get("start"), span.get("end")
            if (str(span.get("name", "")).startswith("task:")
                    and isinstance(start, (int, float))
                    and isinstance(end, (int, float)) and end >= start):
                self.builtin_metrics.task_duration.observe(end - start)
        return {}

    async def h_engine_step_batch(self, conn, body):
        """Batched flight-recorder step records from inference engines
        (util/steprec ring flush, riding the same coalesced-batch path as
        span_batch/task_done).  Per-engine bounded rings: the head keeps
        the recent window, the worker's black-box sidecar keeps the
        crash-proof copy.  Malformed entries are skipped so one bad
        record can't drop an engine's whole batch."""
        cap = max(16, self.config.engine_steps_max_records)
        for rec in body["steps"]:
            if not isinstance(rec, dict) or not rec.get("engine") \
                    or not isinstance(rec.get("step"), int):
                continue
            eid = str(rec["engine"])
            ring = self.engine_steps.get(eid)
            if ring is None:
                # Bound the engine table itself (worker churn must not
                # grow it forever): evict the least-recently-fed engine.
                while len(self.engine_steps) >= 64:
                    self.engine_steps.popitem(last=False)
                ring = self.engine_steps[eid] = deque(maxlen=cap)
            else:
                self.engine_steps.move_to_end(eid)
            ring.append(rec)
        return {}

    async def h_gang_round_batch(self, conn, body):
        """Batched gang round records (util/gangrec ring flush, the train
        session's per-rank flight recorder).  Joined by (gang, round):
        the moment a round holds a record from EVERY rank it collapses
        into one skew profile (gangrec.skew_profile) — which rank arrived
        last and which phase made it late — retained in a bounded
        per-gang ring for list_state("gang_rounds") / `ray_tpu_torch gang` and
        the gang health detectors.  Malformed entries are skipped so one
        bad record can't drop a gang's whole batch."""
        from ..util import gangrec as _gangrec
        cap = max(16, self.config.gang_rounds_max_records)
        for rec in body["rounds"]:
            if not isinstance(rec, dict) or not rec.get("gang") \
                    or not isinstance(rec.get("round"), int) \
                    or not isinstance(rec.get("rank"), int):
                continue
            gid = str(rec["gang"])
            st = self.gang_rounds.get(gid)
            if st is None:
                # Bound the gang table itself (gang churn must not grow
                # it forever): evict the least-recently-fed gang.
                while len(self.gang_rounds) >= max(
                        1, self.config.gang_rounds_max_gangs):
                    self.gang_rounds.popitem(last=False)
                st = self.gang_rounds[gid] = {
                    "pending": OrderedDict(),  # round -> {rank: rec}
                    "profiles": deque(maxlen=cap),
                    "world": 0, "last_t": 0.0,
                    "latest_by_rank": {},
                }
            else:
                self.gang_rounds.move_to_end(gid)
            world = rec.get("world")
            if isinstance(world, int) and world > 0:
                st["world"] = world
            t = rec.get("t")
            if isinstance(t, (int, float)):
                st["last_t"] = max(st["last_t"], float(t))
            st["latest_by_rank"][rec["rank"]] = rec
            pend = st["pending"]
            rnd = pend.get(rec["round"])
            if rnd is None:
                # Bound the join buffer: a rank that died mid-round leaves
                # a forever-incomplete round behind — evict oldest-first.
                while len(pend) >= 64:
                    pend.popitem(last=False)
                rnd = pend[rec["round"]] = {}
            rnd[rec["rank"]] = rec
            if st["world"] and len(rnd) >= st["world"]:
                del pend[rec["round"]]
                prof = _gangrec.skew_profile(rnd)
                if prof is not None:
                    st["profiles"].append(prof)
                    self.builtin_metrics.gang_round_skew.observe(
                        prof["skew_s"])
        return {}

    async def h_devmem_report(self, conn, body):
        """Device-memory snapshot from a worker (util/devmem pools +
        per-device stats + compile observability), identity-joined here
        so list_state("devmem") / `ray_tpu_torch top` can group by node."""
        pid = int(body["pid"])
        worker_id = self.conn_to_worker.get(conn.conn_id)
        w = self.workers.get(worker_id) if worker_id else None
        self.devmem_by_pid[pid] = {
            "pid": pid,
            "worker_id": worker_id.hex() if worker_id else None,
            "node_id": w.node_id.hex() if w is not None else None,
            "devmem": body["devmem"],
            "time": time.time(),
        }
        while len(self.devmem_by_pid) > 256:
            oldest = min(self.devmem_by_pid,
                         key=lambda p: self.devmem_by_pid[p]["time"])
            del self.devmem_by_pid[oldest]
        return {}

    async def h_node_stats(self, conn, body):
        node_id = NodeID(body["node_id"])
        self.node_stats[node_id] = {
            "store": body.get("store"),
            "load1": body.get("load1"),
            "mem_used_frac": body.get("mem_used_frac"),
            "num_worker_procs": body.get("num_worker_procs"),
            "headless_s": body.get("headless_s"),
            "time": time.time(),
        }
        if body.get("headless_s") is not None:
            self.builtin_metrics.headless_seconds.set(
                float(body["headless_s"]), tags={"node": node_id.hex()})
        return {}

    async def h_node_health_ack(self, conn, body):
        self.node_last_ack[NodeID(body["node_id"])] = time.monotonic()
        return {}

    async def h_node_drain(self, conn, body):
        """Announced preemption (spot/maintenance SIGTERM with a grace
        window): the node daemon reports DRAINING before it goes away.  The
        scheduler stops leasing onto the node immediately, and every
        subscribed process (train sessions subscribe at worker setup) gets a
        ``node_events`` drain notification so gangs can checkpoint inside
        the grace window (reference: GcsNodeManager DrainNode + the
        autoscaler's drain-before-terminate; TorchTitan-style graceful
        drain on SIGTERM)."""
        node_id = NodeID(body["node_id"])
        grace_s = float(body.get("grace_s", 0.0))
        marked = self.scheduler.mark_draining(node_id)
        self._event("node_drain", node=node_id.hex(), grace_s=grace_s)
        # Revoke the draining node's task leases: clients stop routing new
        # work there, in-flight specs drain inside the grace window, and
        # the slots' resources free for the exclusion accounting.
        for lease_id, lease in list(self.leases.items()):
            if lease["node_id"] == node_id:
                await self._revoke_lease(lease_id, "node_draining")
        await self._publish("node_events", {
            "event": "drain",
            "node_id": node_id.hex(),
            "grace_s": grace_s,
        })
        # Idle workers on a draining node have nothing to finish: shut them
        # down now so the daemon (which exits early once its last worker is
        # gone) doesn't sit out the full grace window for an idle node —
        # the autoscaler's scale-down path stays fast.  Leased/actor
        # workers keep running: they are what the grace window is FOR.
        for w in list(self.workers.values()):
            if w.node_id == node_id and w.state == IDLE and w.conn.alive:
                try:
                    await w.conn.push("shutdown", {})
                except Exception:
                    pass
        return {"draining": marked}

    async def h_stream_item(self, conn, body):
        task_id = body["task_id"]
        idx = body["index"]
        oid = ObjectID(body["object_id"])
        rec = self._obj(oid)
        worker_id = self.conn_to_worker.get(conn.conn_id)
        worker = self.workers.get(worker_id) if worker_id else None
        if body.get("inline") is not None:
            rec.inline = body["inline"]
            rec.size = len(rec.inline)
        else:
            rec.size = body["size"]
            loc = worker.node_id if worker else self.local_node_id
            rec.locations.add(loc)
            self._adopt_local(oid, loc)
        rec.sealed = True
        self.stream_items[(task_id, idx)] = {"object_id": body["object_id"]}
        for ev in self.stream_waiters.pop((task_id, idx), []):
            ev.set()
        self._notify_object_ready(oid)
        return {}

    async def h_next_stream_item(self, conn, body):
        task_id_raw = body["task_id"]
        idx = body["index"]
        key = (task_id_raw, idx)
        tid = TaskID(task_id_raw)
        while key not in self.stream_items:
            if tid in self.stream_done and idx >= self.stream_done[tid]:
                task = self.tasks.get(tid)
                if task and task.state == FAILED:
                    ret_ids = task.spec.get("return_ids") or []
                    if ret_ids:
                        rec = self.objects.get(ObjectID(ret_ids[0]))
                        if rec is not None and rec.error is not None:
                            return {"error": rec.error}
                return {"done": True}
            ev = asyncio.Event()
            self.stream_waiters.setdefault(key, []).append(ev)
            await ev.wait()
        return {"object_id": self.stream_items[key]["object_id"]}

    async def h_cancel_task(self, conn, body):
        task_id = TaskID(body["task_id"])
        task = self.tasks.get(task_id)
        if task is None:
            return {"cancelled": False}
        if task.state == PENDING:
            task.state = FAILED
            task.error = "cancelled"
            self._task_transition(task, FAILED, error="cancelled")
            err = serialization.pack(TaskCancelledError(task_id.hex()))
            for raw in task.spec.get("return_ids", []):
                rec = self._obj(ObjectID(raw))
                rec.error = err
                rec.sealed = True
                self._notify_object_ready(rec.object_id)
            try:
                self.queued_tasks.remove(task)
                self._dequeue_shape(task)
            except ValueError:
                pass
            self._unpark(task)  # releases node-committed resources, if any
            self._finalize_task(task)
            return {"cancelled": True}
        if task.state == RUNNING and task.worker_id:
            w = self.workers.get(task.worker_id)
            if w and w.conn.alive:
                await w.conn.push("cancel", {"task_id": body["task_id"],
                                             "force": body.get("force", False)})
                return {"cancelled": True}
        return {"cancelled": False}

    # -- actors ----------------------------------------------------------------

    async def h_create_actor(self, conn, body):
        actor_id = ActorID(body["actor_id"])
        actor = ActorRecord(actor_id, body)
        if actor.name:
            if actor.name in self.named_actors:
                raise ValueError(f"actor name {actor.name!r} already taken")
            self.named_actors[actor.name] = actor_id
            # A fresh creation supersedes any restart-loss tombstone.
            self.named_tombstones.pop(actor.name, None)
            self._mark_dirty()
        # Stamp the actor-level metadata into the creation task the worker
        # will receive and RETAIN: it is the worker's field-state report
        # after a head restart, and the restarted head rebuilds this exact
        # ActorRecord from it (see _resync_worker_adopt).
        body["creation_task"]["actor_meta"] = {
            k: body.get(k)
            for k in ("class_name", "name", "namespace", "max_restarts",
                      "max_task_retries", "method_names", "method_defaults",
                      "lifetime")
        }
        self.actors[actor_id] = actor
        await self.h_submit_task(conn, body["creation_task"])
        return {}

    async def _drain_parked_unknown_actor_tasks(self, force: bool = False):
        """Re-run parked unknown-actor submissions whose actor is now
        known (adoption or snapshot replay landed).  With ``force`` (grace
        window closed) everything re-runs — still-unknown actors then take
        the normal typed ActorDiedError path."""
        if not self._parked_unknown_actor_tasks:
            return
        parked, self._parked_unknown_actor_tasks = \
            self._parked_unknown_actor_tasks, []
        keep: List[dict] = []
        for body in parked:
            if force or ActorID(body["actor_id"]) in self.actors:
                try:
                    await self.h_submit_actor_task(None, body)
                except Exception:
                    pass
            else:
                keep.append(body)
        # Preserve arrival order for specs still waiting on their adoption
        # (anything parked by the re-runs above lands after them, which
        # matches submission order per actor).
        self._parked_unknown_actor_tasks[:0] = keep

    async def h_submit_actor_task(self, conn, body):
        actor_id = ActorID(body["actor_id"])
        actor = self.actors.get(actor_id)
        if actor is None and time.monotonic() < self._resync_grace_until:
            # Head-restart resync race: a reconnected driver's buffered
            # submissions can replay BEFORE the hosting worker's field
            # report adopts the actor.  Park the spec for the grace window;
            # adoption (or named replay) drains it, expiry fails it typed.
            self._parked_unknown_actor_tasks.append(body)
            return {}
        if actor is None or actor.state == "DEAD":
            err = serialization.pack(
                ActorDiedError(actor_id.hex(), actor.death_cause if actor else "unknown actor")
            )
            for raw in body.get("return_ids", []):
                rec = self._obj(ObjectID(raw))
                rec.error = err
                rec.sealed = True
                self._notify_object_ready(rec.object_id)
            return {}
        task = TaskRecord(body)
        self._register_task(task)
        self._task_transition(task, "SUBMITTED")
        # Strict per-actor FIFO: anything already queued keeps its place
        # (reference: sequential_actor_submit_queue.h).
        if actor.state != "ALIVE" or task.pending_deps or actor.pending_tasks:
            actor.pending_tasks.append(task)
            if actor.state == "ALIVE":
                await self._drain_actor_queue(actor)
            return {}
        await self._push_actor_task(actor, task)
        return {}

    async def _push_actor_task(
        self, actor: ActorRecord, task: TaskRecord
    ) -> bool:
        """Dispatch one task to the actor's worker.  Returns False when the
        task could not be dispatched now: re-queued (worker gone, actor
        restarting) or terminally failed (actor DEAD) — callers draining a
        queue must stop on False instead of spinning."""
        if task.state != PENDING:  # e.g. cancelled while queued
            return True
        if actor.state == "DEAD":
            # The death handler already failed whatever was queued at the
            # time; a task resurfacing later (e.g. a drain snapshot that
            # raced the death) must fail the same way, never be orphaned on
            # a queue nothing will drain again.
            actor.pending_tasks.append(task)
            await self._fail_actor_queue(actor, None)
            return False
        worker = self.workers.get(actor.worker_id)
        if worker is None or not worker.conn.alive:
            # Back to the FRONT: the FIFO drain popped this task from the
            # head of the queue, and a tail re-append would reorder it
            # behind later submissions across a restart.
            actor.pending_tasks.appendleft(task)
            return False
        task.state = RUNNING
        task.worker_id = worker.worker_id
        task.node_id = worker.node_id
        worker.used = True
        if task.start_time == 0.0:  # first dispatch only (see _dispatch)
            self.builtin_metrics.submit_to_start.observe(
                max(0.0, time.time() - task.submit_time))
        task.start_time = time.time()
        self.builtin_metrics.tasks_dispatched.inc()
        worker.inflight.add(task.task_id)
        self._task_transition(task, "RUNNING")
        await worker.conn.push("execute_task", task.spec)
        return True

    async def _drain_actor_queue(self, actor: ActorRecord):
        if (actor.spec.get("creation_task") or {}).get(
                "execute_out_of_order"):
            # Out-of-order submit queue: dependency-READY tasks dispatch
            # past dep-blocked ones; relative order among ready tasks is
            # preserved (reference: out_of_order_actor_submit_queue.h —
            # dispatch reordering only; the worker still bounds execution
            # concurrency by max_concurrency).
            ready = [t for t in actor.pending_tasks
                     if t.state == PENDING and not t.pending_deps]
            # Replace the queue BEFORE awaiting: _push_actor_task may
            # re-append (dead worker), and new submissions may land
            # mid-await — both must go to the live deque, not a snapshot.
            actor.pending_tasks = deque(
                t for t in actor.pending_tasks
                if t.state == PENDING and t.pending_deps)
            for i, task in enumerate(ready):
                if not await self._push_actor_task(actor, task):
                    # Worker vanished mid-drain: requeue the untried rest
                    # (the failed one was already re-appended or failed).
                    actor.pending_tasks.extend(ready[i + 1:])
                    if actor.state == "DEAD":
                        # The death handler's queue-fail already ran; these
                        # stragglers must fail too, not sit orphaned.
                        await self._fail_actor_queue(actor, None)
                    return
            return
        while actor.pending_tasks:
            task = actor.pending_tasks[0]
            if task.state != PENDING:  # cancelled: drop and move on
                actor.pending_tasks.popleft()
                continue
            if task.pending_deps:
                break  # FIFO order: a dep-blocked head blocks the queue
            actor.pending_tasks.popleft()
            if not await self._push_actor_task(actor, task):
                # Not dispatchable now (worker died / actor DEAD): the task
                # is back on the queue or failed.  Stop — looping again
                # would pop and re-append the same head in a tight,
                # never-yielding spin that starves the event loop (incl.
                # the death handler that would break the cycle).
                break

    async def _fail_actor_queue(self, actor: ActorRecord, error: Optional[bytes]):
        err = error or serialization.pack(
            ActorDiedError(actor.actor_id.hex(), actor.death_cause or "actor died")
        )
        while actor.pending_tasks:
            task = actor.pending_tasks.popleft()
            task.state = FAILED
            for raw in task.spec.get("return_ids", []):
                rec = self._obj(ObjectID(raw))
                rec.error = err
                rec.sealed = True
                self._notify_object_ready(rec.object_id)

    async def h_kill_actor(self, conn, body):
        actor_id = ActorID(body["actor_id"])
        actor = self.actors.get(actor_id)
        if actor is None:
            return {"killed": False}
        if body.get("no_restart", True):
            actor.restarts_left = 0
        worker = self.workers.get(actor.worker_id) if actor.worker_id else None
        if worker is not None and worker.conn.alive:
            # Push-based kill: works across nodes (the worker's RPC thread
            # calls os._exit even if the main thread is busy).  Local workers
            # also get a SIGKILL in case the process is wedged.
            try:
                await worker.conn.push("exit", {})
            except Exception:
                pass
            if worker.node_id == self.local_node_id:
                try:
                    os.kill(worker.pid, 9)
                except (ProcessLookupError, PermissionError):
                    pass
            # The worker is doomed by OUR signal — process the death now
            # instead of waiting for the connection EOF.  Otherwise a
            # direct-call client whose peer connection broke first
            # re-submits the in-flight call (retry budget already charged)
            # and the resubmission races the EOF: dispatched to the
            # still-registered dead worker, it dies with retries_left=0.
            # The later EOF-driven death handler no-ops (worker popped).
            await self._handle_worker_death(worker.worker_id)
        else:
            if actor.state != "DEAD":
                actor.state = "DEAD"
                self._mark_dirty()  # drop from the snapshot
                actor.death_cause = "killed via kill_actor"
                if actor.name:
                    self.named_actors.pop(actor.name, None)
                await self._publish_actor_event(actor, "DEAD")
                await self._fail_actor_queue(actor, None)
                self._free_actor_creation_args(actor)
        return {"killed": True}

    async def h_worker_ready(self, conn, body):
        worker_id = self.conn_to_worker.get(conn.conn_id)
        w = self.workers.get(worker_id) if worker_id else None
        if w is not None and w.state == STARTING:
            w.state = IDLE
            self._kick()
        return {}

    async def h_get_actor_by_name(self, conn, body):
        actor_id = self.named_actors.get(body["name"])
        if actor_id is None:
            reply = {"found": False}
            tomb = self.named_tombstones.get(body["name"])
            if tomb:
                reply["tombstone"] = tomb
            return reply
        actor = self.actors[actor_id]
        return {
            "found": True,
            "actor_id": actor_id.binary(),
            "spec": {
                k: actor.spec.get(k)
                for k in ("class_name", "method_names", "max_task_retries",
                          "method_defaults")
            },
        }

    async def h_list_named_actors(self, conn, body):
        return {"names": sorted(self.named_actors)}

    # -- dataplane: direct actor calls + node-local task leases ---------------
    # (reference: Ray's core workers submit actor tasks directly to each
    # other and lease execution slots from the per-node raylet so
    # steady-state submission never touches the GCS — core_worker.proto
    # PushTask, node_manager.proto RequestWorkerLease.  The head stays the
    # lessor and the address directory; the per-call traffic moves to the
    # workers' peer servers.)

    def _actor_route_wire(self, actor: ActorRecord) -> Optional[dict]:
        """Peer-route descriptor for an ALIVE actor's hosting worker, or
        None when the worker has no reachable peer server."""
        worker = self.workers.get(actor.worker_id) if actor.worker_id else None
        if worker is None or not worker.conn.alive or not worker.peer_addr:
            return None
        return {
            "addr": worker.peer_addr,
            "worker_id": worker.worker_id.binary(),
            "node_id": worker.node_id.binary(),
            "session": self.node_sessions.get(worker.node_id, self.session),
            # Object-plane endpoints of the worker's node: direct-result
            # descriptors stamp these so cross-node readers can pull
            # without a directory lookup.
            "object_addr": self.node_object_addrs.get(worker.node_id),
            "bulk_addr": self.node_bulk_addrs.get(worker.node_id),
        }

    async def h_resolve_actor(self, conn, body):
        """Address resolution for direct actor calls.  `busy` reports
        whether the actor has head-queued or in-flight tasks: a client that
        already routed calls through the head must not switch to the peer
        plane while any could still be ahead (per-submitter FIFO has to
        survive the switch); a client with no prior traffic to this actor
        may dial regardless of other submitters."""
        actor = self.actors.get(ActorID(body["actor_id"]))
        if actor is None or actor.state == "DEAD":
            return {"ready": False, "dead": True}
        if (actor.spec.get("creation_task") or {}).get("execute_out_of_order"):
            # Out-of-order dispatch is a head-side reordering feature; a
            # FIFO peer connection cannot express it.
            return {"ready": False, "unsupported": True}
        if actor.state != "ALIVE":
            return {"ready": False}
        route = self._actor_route_wire(actor)
        if route is None:
            return {"ready": False}
        worker = self.workers[actor.worker_id]
        busy = bool(actor.pending_tasks) or bool(worker.inflight)
        return {"ready": True, "busy": busy, **route}

    async def _publish_actor_event(self, actor: ActorRecord, state: str):
        """Actor lifecycle broadcast for client route caches: ALIVE carries
        the peer route (pre-warm — subscribers dial during creation
        dispatch instead of paying the handshake on the first call);
        RESTARTING/DEAD invalidate cached addresses."""
        data = {"actor_id": actor.actor_id.hex(), "state": state}
        if state == "ALIVE":
            route = self._actor_route_wire(actor)
            if route is not None:
                data.update(route)
        await self._publish("actor_events", data)

    async def h_direct_done(self, conn, body):
        """Batched completion report for a directly-executed task (peer
        actor call or leased submission): keeps the task history, the
        timeline, and actor accounting complete without per-call head
        dispatch.  Return-object registration rides the submitter's put
        batch, not this report."""
        task_id = TaskID(body["task_id"])
        failed = bool(body.get("failed"))
        state = FAILED if failed else FINISHED
        cap = self.config.task_history_max_tasks
        worker_id = self.conn_to_worker.get(conn.conn_id)
        if cap > 0:
            hexid = task_id.hex()
            rec = self.task_history.get(hexid)
            if rec is None:
                rec = self.task_history[hexid] = {
                    "task_id": hexid,
                    "name": body.get("name", ""),
                    "actor_id": (ActorID(body["actor_id"]).hex()
                                 if body.get("actor_id") else None),
                    "state": state,
                    "node_id": None,
                    "worker_id": None,
                    "error": None,
                    "traceback": None,
                    "events": [],
                }
                while len(self.task_history) > cap:
                    self.task_history.popitem(last=False)
            ev: Dict[str, Any] = {"state": state,
                                  "ts": body.get("end") or time.time(),
                                  "direct": True}
            if worker_id is not None:
                rec["worker_id"] = ev["worker"] = worker_id.hex()
                w = self.workers.get(worker_id)
                if w is not None:
                    rec["node_id"] = ev["node"] = w.node_id.hex()
            if failed:
                rec["error"] = ev["error"] = body.get("error_repr", "")
                rec["traceback"] = (body.get("error_tb")
                                    or body.get("error_repr", ""))
            rec["state"] = state
            rec["events"].append(ev)
            if len(rec["events"]) > self.config.task_history_max_events:
                del rec["events"][1]
        self.finished_tasks.append({
            "task_id": task_id.hex(),
            "name": body.get("name", ""),
            "state": state,
            "start_time": body.get("start", 0.0),
            "end_time": body.get("end", 0.0),
            "error": body.get("error_repr") if failed else None,
        })
        self._event("task_done", task=task_id.hex(), failed=failed,
                    direct=True)
        if body.get("actor_id"):
            actor = self.actors.get(ActorID(body["actor_id"]))
            if actor is not None and not failed:
                actor.num_executed += 1
        if worker_id is not None:
            w = self.workers.get(worker_id)
            if w is not None:
                w.last_seen = time.monotonic()
        return {}

    async def h_lease_request(self, conn, body):
        """Grant direct-submission slots: idle peer-reachable workers whose
        node can hold the shape's resources.  Never grants while the head
        itself has unplaced work — leased-out capacity must not starve
        queued tasks or pending gangs.  Scheduler invariants hold because a
        slot IS a resource acquisition (scheduler.lease_slot), released at
        return/revoke/disconnect."""
        cfg = self.config
        resources = {k: float(v)
                     for k, v in (body.get("resources") or {}).items()}
        count = max(0, min(int(body.get("count", 1)), cfg.lease_max_slots))
        slots: List[dict] = []
        starved = bool(self.pending_pgs) or any(
            q for q in self.node_parked.values())
        if not starved and self.queued_tasks:
            # Queued head work only blocks grants once it has genuinely
            # waited (a burst's own in-flight submissions must not deny
            # the lease that would carry the next burst).
            starved = max(
                (time.time() - t.submit_time for t in self.queued_tasks
                 if t.state == PENDING), default=0.0) > 0.25
        if not starved and int(resources.get("GPU", 0)) < 1:
            now = time.monotonic()
            # Fairness: one cold client must not vacuum the whole idle pool
            # in a single grant (multi-client warm-up would starve the
            # rest onto the head path) — leave half the idle workers for
            # other requesters; growth requests can take more later.
            n_idle = sum(1 for w in self.workers.values()
                         if w.state == IDLE and w.conn.alive and w.peer_addr)
            count = min(count, max(1, n_idle // 2)) if n_idle else 0
            for w in self.workers.values():
                if len(slots) >= count:
                    break
                if w.state != IDLE or not w.conn.alive or not w.peer_addr:
                    continue
                if not self.scheduler.lease_slot(w.node_id, resources):  # rt-owns: sched_slot
                    continue
                lease_id = os.urandom(8)
                self.leases[lease_id] = {
                    "worker_id": w.worker_id,
                    "node_id": w.node_id,
                    "conn_id": conn.conn_id,
                    "resources": resources,
                    "expires": now + cfg.lease_ttl_s,
                    "revoke_deadline": None,
                }
                w.state = DIRECT
                w.used = True
                w.last_seen = now
                slots.append({
                    "lease_id": lease_id,
                    "worker_id": w.worker_id.binary(),
                    "node_id": w.node_id.binary(),
                    "addr": w.peer_addr,
                    "session": self.node_sessions.get(w.node_id,
                                                      self.session),
                    "object_addr": self.node_object_addrs.get(w.node_id),
                    "bulk_addr": self.node_bulk_addrs.get(w.node_id),
                })
        return {"slots": slots, "ttl_s": cfg.lease_ttl_s}

    def _finalize_lease(self, lease_id: bytes, reason: str,
                        revoked: bool = False):
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        self.scheduler.release_slot(lease["node_id"], lease["resources"])
        w = self.workers.get(lease["worker_id"])
        if w is not None and w.state == DIRECT:
            w.state = IDLE
            w.last_seen = time.monotonic()
        if revoked:
            self.builtin_metrics.lease_revocations.inc(
                tags={"reason": reason})
        self._kick()

    async def _revoke_lease(self, lease_id: bytes, reason: str):
        """Ask the owner to stop using (and return) a lease; force-reclaim
        after a short deadline so a wedged client can't pin the slot.
        The grant only frees at lease_return (or the deadline): in-flight
        specs already pipelined to the worker drain first."""
        lease = self.leases.get(lease_id)
        if lease is None or lease["revoke_deadline"] is not None:
            return
        lease["revoke_deadline"] = time.monotonic() + 2.0
        self._event("lease_revoke", lease=lease_id.hex(), reason=reason)
        c = self.server.connections.get(lease["conn_id"])
        if c is None:
            self._finalize_lease(lease_id, reason, revoked=True)
            return
        try:
            await c.push("lease_revoke",
                         {"lease_id": lease_id, "reason": reason})
        except Exception:
            self._finalize_lease(lease_id, reason, revoked=True)

    async def h_lease_return(self, conn, body):
        for raw in body.get("lease_ids", []):
            lease = self.leases.get(bytes(raw))
            # Only the owner returns a lease: a confused client must not
            # release someone else's slot.
            if lease is not None and lease["conn_id"] == conn.conn_id:
                revoked = lease["revoke_deadline"] is not None
                self._finalize_lease(bytes(raw), "revoked" if revoked
                                     else "returned", revoked=revoked)
        return {}

    async def h_lease_renew(self, conn, body):
        now = time.monotonic()
        for raw in body.get("lease_ids", []):
            lease = self.leases.get(bytes(raw))
            if lease is not None and lease["conn_id"] == conn.conn_id \
                    and lease["revoke_deadline"] is None:
                lease["expires"] = now + self.config.lease_ttl_s
        return {}

    # -- worker death / fault tolerance ---------------------------------------

    async def _handle_worker_death(self, worker_id: WorkerID):
        worker = self.workers.pop(worker_id, None)
        if worker is None:
            return
        worker.state = DEAD
        self._event("worker_died", worker=worker_id.hex(),
                    actor=worker.actor_id.hex() if worker.actor_id else None,
                    inflight=len(worker.inflight))
        # A leased slot dies with its worker: release the resources now and
        # tell the owner so it drops the slot (its in-flight specs fail on
        # the peer connection and fall back to the head path).
        for lease_id, lease in list(self.leases.items()):
            if lease["worker_id"] == worker_id:
                c = self.server.connections.get(lease["conn_id"])
                self._finalize_lease(lease_id, "worker_died", revoked=True)
                if c is not None:
                    try:
                        await c.push("lease_revoke", {
                            "lease_id": lease_id, "reason": "worker_died",
                        })
                    except Exception:
                        pass
        self._log_mark_dead(worker_id.hex())
        oom_killed = self._oom_kills.pop(worker_id, None) is not None
        self.node_worker_counts[worker.node_id] = max(
            0, self.node_worker_counts.get(worker.node_id, 1) - 1
        )
        if worker.gpus:
            # The process is gone, so its cards are actually free now.
            self.scheduler.free_gpus(worker.node_id, worker.gpus)
            worker.gpus = []
            self._kick()  # GPU-starved parked tasks can dispatch
        # If this worker hosted an actor that will restart, its creation task
        # must not seal error objects (the restarted creation reuses them).
        will_restart_actor = False
        creation_tid = None
        if worker.actor_id is not None:
            actor = self.actors.get(worker.actor_id)
            if actor is not None and actor.state != "DEAD":
                creation_tid = TaskID(actor.spec["creation_task"]["task_id"])
                will_restart_actor = actor.restarts_left != 0

        requeued_actor_tasks: List[TaskRecord] = []
        for tid in list(worker.inflight):
            task = self.tasks.get(tid)
            if task is None or task.state != RUNNING:
                continue
            if tid == creation_tid and will_restart_actor:
                # The restart path below resubmits this spec; the resubmitted
                # copy re-acquires at dispatch, so the running copy's
                # resources must be released here or the node leaks them.
                if not task.blocked:
                    self.scheduler.release(
                        task.node_id, task.resources, task.strategy
                    )
                continue
            # Actor tasks don't hold scheduler resources (the actor does);
            # a blocked task already released its resources in h_task_blocked.
            if (not task.spec.get("actor_id") or task.spec.get("is_actor_creation")) \
                    and not task.blocked:
                self.scheduler.release(task.node_id, task.resources, task.strategy)
            task.blocked = False
            if task.is_actor_task and will_restart_actor and task.retries_left != 0:
                # In-flight actor tasks survive the restart: requeue them at
                # the front so the restarted actor re-executes them in order
                # (reference: task_manager.cc resubmits actor tasks honoring
                # max_task_retries after actor restart).
                task.retries_left -= 1
                task.state = PENDING
                self._task_transition(task, "RETRYING",
                                      error="worker process died")
                task.worker_id = None
                task.node_id = None
                self._event("task_retry", task=task.task_id.hex())
                requeued_actor_tasks.append(task)
            elif task.retries_left != 0 and not task.spec.get("actor_id"):
                task.retries_left -= 1
                task.state = PENDING
                self._task_transition(task, "RETRYING",
                                      error="worker process died")
                task.worker_id = None
                self._event("task_retry", task=task.task_id.hex())
                self._enqueue_task(task)
            else:
                task.state = FAILED
                cause = (
                    " (killed by the memory monitor: host memory usage "
                    "crossed memory_usage_threshold)"
                    if oom_killed else ""
                )
                crash_msg = (
                    f"worker {worker_id.hex()[:8]} died while running "
                    f"task{cause}"
                )
                task.error = crash_msg
                # The FAILED record outlives the dead worker (and its node):
                # it lives in the head's task history, not the worker.
                self._task_transition(task, FAILED, error=crash_msg,
                                      traceback_text=crash_msg)
                err = serialization.pack(WorkerCrashedError(crash_msg))
                for raw in task.spec.get("return_ids", []):
                    rec = self._obj(ObjectID(raw))
                    rec.error = err
                    rec.sealed = True
                    self._notify_object_ready(rec.object_id)
                if task.spec.get("num_returns") == "streaming":
                    self.stream_done.setdefault(task.task_id, 0)
                    for key, evs in list(self.stream_waiters.items()):
                        if key[0] == task.task_id.binary():
                            for ev in self.stream_waiters.pop(key):
                                ev.set()
                task.end_time = time.time()
                self._finalize_task(task)

        if worker.actor_id is not None:
            actor = self.actors.get(worker.actor_id)
            if actor is not None and actor.state != "DEAD":
                # Surviving in-flight tasks go back to the front of the
                # actor's queue in submission order.
                for task in sorted(requeued_actor_tasks, key=lambda t: -t.seq):
                    actor.pending_tasks.appendleft(task)
                # Release the actor's creation resources (unless the creation
                # task itself was still running — handled in the loop above).
                ct = self.tasks.get(TaskID(actor.spec["creation_task"]["task_id"]))
                if ct is not None and ct.node_id is not None and ct.state == FINISHED:
                    self.scheduler.release(ct.node_id, ct.resources, ct.strategy)
                if actor.restarts_left != 0:
                    actor.restarts_left -= 1
                    actor.state = "RESTARTING"
                    actor.worker_id = None
                    await self._publish(
                        f"actor:{actor.actor_id.hex()}", {"state": "RESTARTING"}
                    )
                    # Invalidate cached peer routes: the restarted actor
                    # lands on a NEW worker (stale-incarnation calls to the
                    # old address also self-detect, this is the fast path).
                    await self._publish_actor_event(actor, "RESTARTING")
                    # Re-submit the creation task
                    # (reference: gcs_actor_manager.cc RestartActor).  The
                    # orphaned running record shares the task id; drop its
                    # arg pins first or re-registration double-pins them.
                    old_ct = self.tasks.get(
                        TaskID(actor.spec["creation_task"]["task_id"])
                    )
                    if old_ct is not None:
                        self._unpin_task_args(old_ct)
                    ct2 = TaskRecord(dict(actor.spec["creation_task"]))
                    self._register_task(ct2)
                    if not ct2.pending_deps:
                        self._enqueue_task(ct2)
                else:
                    actor.state = "DEAD"
                    self._mark_dirty()  # drop from the snapshot
                    actor.death_cause = "worker process died"
                    if actor.name:
                        self.named_actors.pop(actor.name, None)
                    await self._publish(
                        f"actor:{actor.actor_id.hex()}", {"state": "DEAD"}
                    )
                    await self._publish_actor_event(actor, "DEAD")
                    await self._fail_actor_queue(actor, None)
                    self._free_actor_creation_args(actor)
        self._kick()

    def _free_actor_creation_args(self, actor: ActorRecord):
        """Drop the creation-task large-args pin at permanent actor death
        (the creation task itself finalized long ago with keep=True)."""
        args_ref = actor.spec["creation_task"].get("args_ref")
        if args_ref is not None:
            self._decref(ObjectID(args_ref))

    # -- placement groups ------------------------------------------------------

    async def h_create_placement_group(self, conn, body):
        pg_id = PlacementGroupID(body["pg_id"])
        self.pg_bodies[pg_id] = body
        if conn is not None and body.get("lifetime") != "detached":
            self.pg_owner_conn[pg_id] = conn.conn_id
        self._mark_dirty()
        strategy = body.get("strategy", "PACK")
        ok = self.scheduler.create_placement_group(
            pg_id, body["bundles"], strategy, body.get("name", "")
        )
        if ok:
            self._notify_pg_ready(pg_id)
            return {"created": True}
        # Not placeable right now — either resources are busy or the bundles
        # don't fit the current node set at all.  Both queue (reference:
        # gcs_placement_group_manager keeps infeasible PGs pending so they
        # are satisfied when nodes join later); `infeasible_now` lets the
        # client warn that ready() will block until the cluster grows.
        feasible = self.scheduler.check_feasible_ever(body["bundles"], strategy)
        self.pending_pgs[pg_id] = body
        return {"created": False, "queued": True, "infeasible_now": not feasible}

    def _notify_pg_ready(self, pg_id: PlacementGroupID):
        for ev in self.pg_waiters.pop(pg_id, []):
            ev.set()

    def _try_pending_pgs(self):
        for pg_id in list(self.pending_pgs):
            body = self.pending_pgs[pg_id]
            if self.scheduler.create_placement_group(
                pg_id, body["bundles"], body.get("strategy", "PACK"),
                body.get("name", ""),
            ):
                del self.pending_pgs[pg_id]
                self._notify_pg_ready(pg_id)
            else:
                break  # FIFO fairness: head-of-line blocks later PGs

    async def h_pg_ready(self, conn, body):
        pg_id = PlacementGroupID(body["pg_id"])
        timeout = body.get("timeout", 30.0)
        deadline = time.monotonic() + timeout
        while pg_id in self.pending_pgs:
            ev = asyncio.Event()
            waiters = self.pg_waiters.setdefault(pg_id, [])
            waiters.append(ev)
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"ready": False}
                try:
                    await asyncio.wait_for(ev.wait(), timeout=remaining)
                except asyncio.TimeoutError:
                    return {"ready": False}
            finally:
                # Drop our event on timeout so repeated ready() polls on a
                # long-pending PG don't accumulate waiters.
                cur = self.pg_waiters.get(pg_id)
                if cur is not None and ev in cur:
                    cur.remove(ev)
        pg = self.scheduler.placement_groups.get(pg_id)
        return {"ready": pg is not None and pg.created}

    async def h_remove_placement_group(self, conn, body):
        pg_id = PlacementGroupID(body["pg_id"])
        self.pg_bodies.pop(pg_id, None)
        self.pg_owner_conn.pop(pg_id, None)
        self._mark_dirty()
        self.pending_pgs.pop(pg_id, None)
        self._notify_pg_ready(pg_id)
        self.scheduler.remove_placement_group(pg_id)
        self._kick()
        return {}

    # -- pubsub (reference: src/ray/pubsub/publisher.h) ------------------------

    async def h_publish(self, conn, body):
        await self._publish(body["topic"], body["data"])
        return {}

    async def _publish(self, topic: str, data):
        for conn_id in list(self.subs.get(topic, ())):
            c = self.server.connections.get(conn_id)
            if c is None:
                self.subs[topic].discard(conn_id)
                continue
            try:
                await c.push("pubsub", {"topic": topic, "data": data})
            except Exception:
                pass

    async def h_subscribe(self, conn, body):
        self.subs.setdefault(body["topic"], set()).add(conn.conn_id)
        return {}

    # -- introspection ---------------------------------------------------------

    async def h_cluster_resources(self, conn, body):
        total: Dict[str, float] = {}
        for n in self.scheduler.nodes.values():
            for k, v in n.total.items():
                total[k] = total.get(k, 0.0) + v
        return {"resources": total}

    async def h_available_resources(self, conn, body):
        total: Dict[str, float] = {}
        for n in self.scheduler.nodes.values():
            for k, v in n.available.items():
                total[k] = total.get(k, 0.0) + v
        return {"resources": total}

    # -- debugging plane: log retrieval + stack dumps --------------------------

    async def _node_call(self, addr: str, method: str, body: dict,
                         timeout: float = 10.0):
        """One-shot async RPC to a node daemon's server (the head is a
        *server* to daemons — their Connection only supports pushes — so
        routed reads like get_log dial the node's object-plane endpoint)."""
        from .rpc import ERR, REQ, RESP, RpcError, RpcServer, _encode, _read_msg

        host, port = addr.rsplit(":", 1)
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port),
                                    limit=RpcServer.STREAM_LIMIT),
            timeout=timeout,
        )
        try:
            writer.write(_encode([REQ, 1, method, body]))
            await writer.drain()
            while True:
                mtype, _seq, _m, rbody = await asyncio.wait_for(
                    _read_msg(reader), timeout=timeout
                )
                if mtype == RESP:
                    return rbody
                if mtype == ERR:
                    raise RpcError(rbody)
        finally:
            writer.close()

    async def h_get_log(self, conn, body):
        """Ranged log read routed head -> owning node -> file.  Works for
        live AND exited processes (the index retains dead entries): the
        crash post-mortem path of `ray_tpu_torch logs` and the dashboard."""
        query = str(body["proc_id"])
        entry, resolve_error = self._resolve_log_entry(query)
        if entry is None:
            return {"found": False, "error": resolve_error}
        if not entry["log_path"]:
            return {"found": False, "alive": entry["alive"],
                    "error": f"process {query!r} registered no log file"}
        offset = body.get("offset", 0)
        max_bytes = body.get("max_bytes", 65536)
        from .node_main import read_log_range

        node_hex = entry["node_id"]
        local_hex = self.local_node_id.hex() if self.local_node_id else ""
        reply: Optional[dict] = None
        if node_hex != local_hex:
            # Route to the owning node's daemon; a dead/unreachable node
            # falls back to a direct read (single-host clusters share the
            # filesystem, so post-mortems still work after node death).
            nid = next((n for n in self.node_object_addrs
                        if n.hex() == node_hex), None)
            addr = self.node_object_addrs.get(nid) if nid else None
            if addr is not None:
                try:
                    reply = await self._node_call(
                        addr, "read_log",
                        {"path": entry["log_path"], "offset": offset,
                         "max_bytes": max_bytes},
                    )
                except Exception:
                    reply = None
        if reply is None:
            reply = await asyncio.get_running_loop().run_in_executor(
                None, read_log_range, entry["log_path"], offset, max_bytes
            )
        reply["alive"] = entry["alive"]
        reply["proc"] = {k: entry[k] for k in
                         ("proc_id", "kind", "node_id", "pid", "actor_id")}
        return reply

    def _resolve_live_worker(self, query: str):
        """Resolve a worker by id hex prefix (or by hosting-actor id
        prefix) for the introspection round trips (stack dump, profile).
        Prefix resolution requires UNIQUENESS: during an incident,
        picking an arbitrary first match would silently debug the wrong
        process.  Returns (worker, None) or (None, error_reply)."""
        matches = [w for wid, w in self.workers.items()
                   if wid.hex() == query or wid.hex().startswith(query)]
        if not matches:
            # Accept an actor id: resolve to its hosting worker.
            matches = [
                self.workers[actor.worker_id]
                for aid, actor in self.actors.items()
                if actor.worker_id in self.workers
                and (aid.hex() == query or aid.hex().startswith(query))
            ]
        if len(matches) > 1:
            return None, {"found": False,
                          "error": f"{query!r} is ambiguous: matches "
                                   f"{len(matches)} workers — use a longer "
                                   "prefix (see `list workers`)"}
        worker = matches[0] if matches else None
        if worker is None or not worker.conn.alive:
            return None, {"found": False,
                          "error": f"no live worker matches {query!r}"}
        return worker, None

    async def h_stack_dump(self, conn, body):
        """All-thread Python stacks from a live worker, on demand and
        without interrupting the running task (the worker collects them on
        its rpc thread) — the hung-gang diagnosis tool (`ray_tpu_torch stack`)."""
        worker, err = self._resolve_live_worker(str(body["worker_id"]))
        if worker is None:
            return err
        self._stack_token += 1
        token = self._stack_token
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._stack_waiters[token] = fut
        try:
            await worker.conn.push("stack_dump", {"token": token})
            reply = await asyncio.wait_for(
                fut, timeout=float(body.get("timeout", 10.0))
            )
        except asyncio.TimeoutError:
            return {"found": True, "ok": False,
                    "worker_id": worker.worker_id.hex(),
                    "error": "worker did not reply in time (rpc thread "
                             "wedged? try SIGUSR1 for a faulthandler dump "
                             "to its log file)"}
        except Exception as e:
            return {"found": True, "ok": False,
                    "worker_id": worker.worker_id.hex(), "error": str(e)}
        finally:
            self._stack_waiters.pop(token, None)
        return {
            "found": True, "ok": True,
            "worker_id": worker.worker_id.hex(),
            "node_id": worker.node_id.hex(),
            "pid": reply.get("pid", worker.pid),
            "threads": reply.get("threads", 0),
            "dump": reply.get("dump", ""),
        }

    async def h_stack_dump_reply(self, conn, body):
        fut = self._stack_waiters.get(body.get("token"))
        if fut is not None and not fut.done():
            fut.set_result(body)
        return {}

    async def h_profile(self, conn, body):
        """On-demand device-trace capture on a live worker (`ray_tpu_torch
        profile`): a stack_dump-shaped token round trip, except the
        worker sleeps through an N-second torch.profiler capture before
        replying with the TensorBoard trace dir — so the wait deadline
        scales with the requested capture length."""
        worker, err = self._resolve_live_worker(str(body["worker_id"]))
        if worker is None:
            return err
        seconds = float(body["seconds"])
        self._stack_token += 1
        token = self._stack_token
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._profile_waiters[token] = fut
        push = {"token": token, "seconds": seconds}
        if body.get("logdir"):
            push["logdir"] = str(body["logdir"])
        try:
            await worker.conn.push("profile", push)
            reply = await asyncio.wait_for(
                fut, timeout=float(body.get("timeout", seconds + 30.0))
            )
        except asyncio.TimeoutError:
            return {"found": True, "ok": False,
                    "worker_id": worker.worker_id.hex(),
                    "error": f"worker did not finish the {seconds:.0f}s "
                             "capture in time (profiler wedged? check the "
                             "worker log)"}
        except Exception as e:
            return {"found": True, "ok": False,
                    "worker_id": worker.worker_id.hex(), "error": str(e)}
        finally:
            self._profile_waiters.pop(token, None)
        out = {
            "found": True, "ok": "error" not in reply,
            "worker_id": worker.worker_id.hex(),
            "node_id": worker.node_id.hex(),
            "pid": reply.get("pid", worker.pid),
        }
        if reply.get("logdir"):
            out["logdir"] = reply["logdir"]
        if reply.get("error"):
            out["error"] = reply["error"]
        return out

    async def h_profile_reply(self, conn, body):
        fut = self._profile_waiters.get(body.get("token"))
        if fut is not None and not fut.done():
            fut.set_result(body)
        return {}

    async def h_list_state(self, conn, body):
        kind = body["kind"]
        if kind == "nodes":
            return {"items": [
                {"node_id": nid.hex(), **info}
                for nid, info in (
                    (n.node_id, {"resources": n.total, "available": n.available,
                                 "alive": n.alive, "draining": n.draining,
                                 "labels": n.labels,
                                 "pending_spawns":
                                     self._spawn_pending.get(n.node_id, 0),
                                 "stats": self.node_stats.get(n.node_id)})
                    for n in self.scheduler.nodes.values()
                )
            ]}
        if kind == "actors":
            return {"items": [
                {
                    "actor_id": a.actor_id.hex(),
                    "class_name": a.spec.get("class_name", ""),
                    "state": a.state,
                    "name": a.name,
                    "pid": (self.workers[a.worker_id].pid
                            if a.worker_id in self.workers else None),
                    "num_executed_tasks": a.num_executed,
                }
                for a in self.actors.values()
            ]}
        if kind == "tasks":
            live = [
                {
                    "task_id": t.task_id.hex(),
                    "name": t.spec.get("name", ""),
                    "state": t.state,
                    "dep_blocked": bool(t.pending_deps),
                    "start_time": t.start_time,
                    "end_time": t.end_time,
                    "error": t.error,
                }
                for t in self.tasks.values()
                if t.state in (PENDING, RUNNING)  # terminal ones are in the ring
            ]
            return {"items": live + list(self.finished_tasks)}
        if kind == "objects":
            return {"items": [
                {
                    "object_id": o.object_id.hex(),
                    "size": o.size,
                    "sealed": o.sealed,
                    "inline": o.inline is not None,
                    "ref_count": o.ref_count,
                }
                for o in self.objects.values()
            ]}
        if kind == "workers":
            return {"items": [
                {
                    "worker_id": w.worker_id.hex(),
                    "node_id": w.node_id.hex(),
                    "state": w.state,
                    "pid": w.pid,
                }
                for w in self.workers.values()
            ]}
        if kind == "placement_groups":
            items = list(
                self.scheduler.snapshot()["placement_groups"].values()
            )
            # Queued (not-yet-placeable) PGs are cluster DEMAND — the
            # autoscaler keys off them, so they must be visible here
            # (reference: gcs_placement_group_manager pending queue feeds
            # the autoscaler's resource demand report).
            for pg_id, body in self.pending_pgs.items():
                items.append({
                    "pg_id": pg_id.hex(),
                    "strategy": body.get("strategy", "PACK"),
                    "created": False,
                    "pending": True,
                    # Current-node-set feasibility: lets demand consumers
                    # (autoscaler) distinguish "needs more nodes" from
                    # "waiting for busy resources to free".
                    "infeasible_now": not self.scheduler.check_feasible_ever(
                        body.get("bundles", []),
                        body.get("strategy", "PACK")),
                    "bundles": [
                        {"resources": dict(r), "node": None}
                        for r in body.get("bundles", [])
                    ],
                })
            return {"items": items}
        if kind == "timeline":
            return {"items": list(self.task_events)}
        if kind == "traces":
            # Span plane query surface: with trace_id (hex prefix ok),
            # the trace's raw spans; without, per-trace summary rows —
            # what `ray_tpu_torch trace` and the dashboard's traces tab read.
            spans = [e for e in self.task_events if e.get("kind") == "span"]
            tid = body.get("trace_id")
            if tid:
                matched: Dict[str, list] = {}
                for s in spans:
                    sid = str(s.get("trace_id", ""))
                    if sid.startswith(str(tid)):
                        matched.setdefault(sid, []).append(s)
                if not matched:
                    return {"items": []}
                # A short hex prefix can match several traces: NEVER merge
                # them into one bogus tree — serve the most recent match
                # and name the others so the caller can disambiguate.
                pick = max(
                    matched,
                    key=lambda t: max(
                        (s.get("start") or 0) for s in matched[t]),
                ) if len(matched) > 1 else next(iter(matched))
                reply: Dict[str, Any] = {"items": matched[pick]}
                if len(matched) > 1:
                    reply["ambiguous_matches"] = sorted(matched)
                return reply
            from ..util import trace_analysis

            limit = body.get("limit")
            return {"items": trace_analysis.summarize(
                spans, limit=int(limit) if limit else 100)}
        if kind == "logs":
            # Cluster-wide log index, exited processes included (their
            # entries are what crash post-mortems route through).
            return {"items": [dict(e) for e in self.log_index.values()]}
        if kind == "task_events":
            items = list(self.task_history.values())
            tid = body.get("task_id")
            if tid:
                items = [r for r in items if r["task_id"].startswith(tid)]
            if body.get("errors"):
                items = [r for r in items if r["state"] == FAILED]
            return {"items": items}
        if kind == "metrics":
            return {"items": self.metrics_rows()}
        if kind == "metrics_history":
            return {"items": self.metrics_history.snapshot(
                body.get("name_prefix", ""))}
        if kind == "engine_steps":
            # Flight-recorder view: one row per engine with its latest
            # step record plus the retained window (optionally trimmed by
            # ``limit`` and filtered by an ``engine`` id prefix).
            engine = body.get("engine")
            limit = int(body.get("limit") or 0)
            items = []
            for eid, ring in self.engine_steps.items():
                if engine and not eid.startswith(str(engine)):
                    continue
                recs = list(ring)
                if limit > 0:
                    recs = recs[-limit:]
                items.append({
                    "engine": eid,
                    "latest": recs[-1] if recs else None,
                    "records": recs,
                })
            return {"items": items}
        if kind == "gang_rounds":
            # Gang observability view: one row per gang with its latest
            # joined skew profile plus the retained profile window
            # (optionally trimmed by ``limit`` and filtered by a ``gang``
            # id prefix) and the newest raw record per rank.
            gang = body.get("gang")
            limit = int(body.get("limit") or 0)
            items = []
            for gid, st in self.gang_rounds.items():
                if gang and not gid.startswith(str(gang)):
                    continue
                profs = list(st["profiles"])
                if limit > 0:
                    profs = profs[-limit:]
                items.append({
                    "gang": gid,
                    "world": st["world"],
                    "last_t": st["last_t"],
                    "latest": profs[-1] if profs else None,
                    "profiles": profs,
                    "ranks": {str(r): rec for r, rec in
                              sorted(st["latest_by_rank"].items())},
                })
            return {"items": items}
        if kind == "devmem":
            return {"items": sorted(
                self.devmem_by_pid.values(), key=lambda r: r["pid"])}
        if kind == "incidents":
            # Health plane: newest-first incident ring + the cluster grade
            # (`status`/`top` print the grade line from this same reply).
            mgr = self.health.manager
            items = mgr.snapshot()
            iid = body.get("id")
            if iid:
                items = [i for i in items if i["id"].startswith(str(iid))]
            return {"items": items, "grade": mgr.grade(),
                    "open": mgr.open_count()}
        raise ValueError(f"unknown state kind {kind!r}")

    async def h_shutdown_cluster(self, conn, body):
        asyncio.get_running_loop().call_soon(
            lambda: asyncio.ensure_future(self.stop())
        )
        return {}


def _validated(name: str, handler):
    """Boundary validation: malformed control-plane messages answer with a
    field-level error instead of a KeyError mid-handler (the protobuf-
    schema role — see core/schema.py)."""
    from . import schema as wire_schema
    from .rpc import RpcError

    async def wrapped(conn, body):
        try:
            wire_schema.validate(name, body)
        except wire_schema.SchemaError as e:
            raise RpcError(str(e)) from None
        return await handler(conn, body)

    wrapped.__name__ = f"validated_{name}"
    return wrapped
