"""Central configuration flag table.

Equivalent in role to the reference's RAY_CONFIG macro table
(reference: src/ray/common/ray_config_def.h — 215 flags, overridable via
RAY_<flag> env vars): one declarative registry, env-var overridable with the
``RT_`` prefix, plus per-``init()`` overrides via ``system_config={...}``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict


#: Spawn-env contract: every ``RT_*`` environment variable the package
#: reads AD HOC (raw ``os.environ``, outside this module).  These are the
#: process-boundary half of the config surface — the head exports them
#: into node-daemon envs, node daemons into worker envs, operators into
#: CLI/driver envs — and a key that drifts on one side fails silently
#: (``environ.get`` defaults kick in).  rtlint RT009 reconciles this
#: catalog against the package's actual reads and spawn-site exports
#: (missing / stale / orphan-write, mirroring RT003's three-way shape).
#: ``Config`` fields need no entry: ``RT_<FIELD>`` overrides resolve
#: through ``_env_override`` below and ad-hoc reads of them are flagged.
SPAWN_ENV_CONTRACT = {
    # -- cluster topology (spawner -> child) ----------------------------------
    "RT_TORCH_ADDRESS": "head address for attach paths: CLI, autoscaler, "
                        "job-submission drivers, Cluster.attach (the JAX "
                        "package's is RT_ADDRESS)",
    "RT_HEAD_ADDR": "head address exported to spawned node daemons and "
                    "workers (their Client dials it at boot)",
    "RT_NODE_ID": "pre-assigned node id for spawned daemons/workers; also "
                  "read by train sessions for rank placement metadata",
    "RT_SESSION": "store session namespace a worker's object writes land "
                  "in (set by the node daemon / head spawner)",
    "RT_NODE_SESSION": "store session a spawned node daemon serves "
                       "(cluster_utils launches daemons with the cluster "
                       "session; unset daemons mint their own)",
    "RT_PEER_HOST": "host the worker's peer RPC server binds (defaults "
                    "to loopback; multi-host spawners set the node IP)",
    "RT_LOG_PATH": "log file the spawner redirected this process into; "
                   "registered in the head's cluster log index",
    "RT_NODE_RESOURCES": "JSON resource map for a spawned node daemon",
    "RT_NODE_LABELS": "JSON label map for a spawned node daemon",
    "RT_NODE_NUM_WORKERS": "worker-pool cap for a spawned node daemon",
    "RT_NODE_HOST": "bind host for a spawned node daemon's servers",
    "RT_DRAIN_GRACE_S": "SIGTERM drain grace window for node daemons "
                        "(cluster_utils preemption uses the same knob)",
    # -- driver/operator knobs ------------------------------------------------
    "RT_GPUS": "GPU-inventory override for accelerator detection",
    "RT_PARENT_CUDA_VISIBLE_DEVICES": "the spawner's CUDA_VISIBLE_DEVICES, "
                                      "through which a worker maps its "
                                      "GPU grant (set by the runtime)",
    "RT_PRESTART_WORKERS": "cap on workers pre-started at init()",
    "RT_LOG_TO_DRIVER": "0 = don't mirror worker stdout/stderr to the "
                        "driver via pubsub",
    "RT_FORCE_PROXY_DRIVER": "1 = force the off-host proxy driver path "
                             "(tests; hosts without usable /dev/shm)",
    # -- standalone head (core/head_main.py) ----------------------------------
    "RT_HEAD_PORT": "fixed listen port for a standalone head daemon — a "
                    "restarted head must rebind the SAME port so headless "
                    "nodes/workers/drivers can redial it",
    "RT_HEAD_SESSION": "stable session name for a standalone head — a "
                       "restart keeps the store namespace so pre-crash "
                       "segments stay addressable",
    # -- fault injection (util/netfault.py) -----------------------------------
    "RT_NETFAULT": "network fault schedule DSL; every process that opens "
                   "an RPC endpoint arms it (children inherit the env, so "
                   "one export perturbs the whole cluster)",
    "RT_NETFAULT_SEED": "integer seed making the armed schedule's fault "
                        "sequence replayable (chaos_soak.sh --netfault "
                        "rotates it and prints the failing value)",
    "RT_CHAOS_STRAGGLER": "gang straggler schedule DSL (util/chaos."
                          "StragglerSchedule): phase=data|compute|"
                          "checkpoint,ms=,ranks= — the seeded rank "
                          "sleeps ms in that phase each round; train "
                          "workers inherit it via the gang runtime_env",
    "RT_CHAOS_SEED": "integer seed for chaos victim selection — the "
                     "straggler schedule's rank pick and the kill-"
                     "cadence tests' RNGs (chaos_soak.sh rotates it)",
    # -- debug switches -------------------------------------------------------
    "RT_DEBUG_PUSH": "worker-side push/exec tracing to stderr",
    "RT_DEBUG_RPC_ERR": "server-side RPC handler error dumps to stderr",
    "RT_DEBUG_LOCKS": "lock sentinel level: 1 = ordering checks, 2 = + "
                      "guard-map race sentinel (devtools.locks)",
    "RT_DEBUG_LOCKS_HOLD_S": "long-hold warning threshold for the lock "
                             "sentinel",
    "RT_DEBUG_JIT": "recompile sentinel: after the engine/learner warmup "
                    "arms it, any post-warmup retrace of a registered jit "
                    "program raises RecompileError with the arg "
                    "shape/dtype delta (devtools.jitguard)",
    "RT_NATIVE_SANITIZE": "build the _native helper with a sanitizer",
}


#: The environment variable holding the head address a driver attaches to.
#: The JAX package reads ``RT_ADDRESS``, and its workers inherit it, so the
#: port keeps its own: ``init()`` in a process of a JAX cluster starts a
#: port head instead of dialing the JAX one.
ADDRESS_ENV = "RT_TORCH_ADDRESS"


def tmp_root(name: str) -> str:
    """``<temp dir>/ray_tpu_torch_<name>``: one of the port's scratch roots
    (spill, logs, function cache, ...).  The temp dir honours ``TMPDIR``,
    so two checkouts with their own ``TMPDIR`` share nothing, and the
    ``ray_tpu_torch`` name keeps the port's roots apart from the JAX
    package's."""
    return os.path.join(tempfile.gettempdir(), f"ray_tpu_torch_{name}")


def address_file() -> str:
    """Where ``init()`` and ``head_main`` write the newest head address
    for out-of-process tooling."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                        "latest_address")


def _env_override(name: str, default):
    raw = os.environ.get(f"RT_{name.upper()}")
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclasses.dataclass
class Config:
    # -- object store ---------------------------------------------------------
    # Objects smaller than this are inlined in RPC messages instead of going
    # through shared memory (analog of Ray's in-process memory store for small
    # objects, reference: src/ray/core_worker/store_provider/memory_store).
    inline_object_max_bytes: int = 100 * 1024
    # Per-process in-process store budget for small objects (the analog of
    # the reference's CoreWorkerMemoryStore): owned puts and read inline
    # values are cached here so repeated gets skip the control plane.
    local_store_max_bytes: int = 128 * 1024 * 1024
    # Total shared-memory budget per node before eviction/spilling kicks in.
    # 0 = auto: 30% of system RAM (the reference's default share), capped at
    # 32 GiB (resolved in __post_init__).
    object_store_memory: int = 0
    # Directory used for spilling objects under memory pressure
    # (reference: python/ray/_private/external_storage.py FileSystemStorage).
    spill_dir: str = dataclasses.field(
        default_factory=lambda: tmp_root("spill"))
    # -- scheduler ------------------------------------------------------------
    # Hybrid policy: pack onto low-index nodes until utilization crosses this
    # threshold, then spread (reference:
    # src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h spread_threshold).
    scheduler_spread_threshold: float = 0.5
    # -- workers --------------------------------------------------------------
    num_workers: int = 0  # 0 => num_cpus
    # A spawned worker process that hasn't registered within this window is
    # presumed dead; its spawn slot is reclaimed so the pool can retry.
    worker_register_timeout_s: float = 30.0
    # Idle task-workers older than this are reaped by the head's periodic
    # loop (reference: worker_pool.h idle worker killing).
    idle_worker_killing_time_s: float = 300.0
    # Absolute ceiling on live workers per node, as a multiple of the pool
    # cap.  Blocked workers (parked in nested ray.get) each permit one extra
    # spawn so nested gets don't deadlock, but a deeply nested chain must not
    # fork unboundedly (reference: worker_pool.h maximum_startup_concurrency
    # bounds concurrent startup).
    worker_pool_hard_cap_multiple: int = 4
    # Fresh (never-used) idle workers to keep pre-forked per node: actor
    # creations grab one instantly instead of waiting out a fork+boot+
    # register cycle (reference: worker_pool.h prestart /
    # num_prestart_python_workers).  Opt-in (0 disables): on small hosts
    # the spare forks tax every init; production heads enable it via
    # system_config={"prestart_spare_workers": 2} or RT_PRESTART_SPARE_WORKERS.
    prestart_spare_workers: int = 0
    # -- memory pressure --------------------------------------------------------
    # Kill a worker when its node's host memory usage crosses this fraction
    # (reference: src/ray/common/memory_monitor.h:52 MemoryMonitor +
    # raylet/worker_killing_policy_group_by_owner.h).  Victims: retriable
    # leased tasks first, newest first; their tasks retry.  0 disables.
    memory_usage_threshold: float = 0.95
    # -- fault tolerance ------------------------------------------------------
    default_task_max_retries: int = 3
    # Finished task specs kept for object lineage reconstruction (their args
    # stay pinned while kept — the analog of the reference's lineage pinning,
    # reference_count.h:75).  0 disables reconstruction.
    lineage_max_entries: int = 10_000
    default_actor_max_restarts: int = 0
    # Liveness probing of worker/node processes whose TCP connection is still
    # open but whose event loop has wedged (reference:
    # gcs_health_check_manager.h).  Probes every period; declared dead after
    # `threshold` consecutive missed acks.  The 30s default window is
    # deliberately generous: a worker mid-way through one long GIL-holding
    # C call (huge unpickle, big numpy ufunc) can't ack from its rpc thread
    # and must not be shot for it.
    health_check_period_s: float = 5.0
    health_check_failure_threshold: int = 6
    # -- RPC ------------------------------------------------------------------
    rpc_connect_timeout_s: float = 10.0
    rpc_max_message_bytes: int = 512 * 1024 * 1024
    # Unified retry/backoff policy (core/deadline.py): EVERY retry loop —
    # idempotent head reads, node/worker reconnect, peer re-dials — backs
    # off on one jittered exponential curve built from these two knobs,
    # instead of per-call-site constants (reference:
    # src/ray/rpc/retryable_grpc_client.h shares one backoff across all
    # GCS calls).
    rpc_retry_base_s: float = 0.05
    rpc_retry_cap_s: float = 0.5
    rpc_retry_attempts: int = 3
    # -- dataplane (peer-to-peer calls + node-local task leases) --------------
    # Direct actor calls: after a head-mediated address resolution the
    # driver dials the owning worker's peer RPC server and submits actor
    # tasks peer-to-peer — the head sees liveness, restart events, and
    # batched telemetry, never per-call traffic (reference: core workers
    # submit actor tasks directly to each other, core_worker.proto
    # PushTask).  RT_DIRECT_CALLS=0 force-disables (every call falls back
    # to the head-mediated path).
    direct_calls: bool = True
    # Node-local task leasing: drivers lease execution slots (idle workers)
    # per resource shape from the head and submit stateless tasks straight
    # to the leased workers' peer servers (reference: raylet worker leasing,
    # node_manager.proto RequestWorkerLease).  RT_TASK_LEASES=0 disables.
    task_leases: bool = True
    # Leases are bounded: count per (client, shape) ...
    lease_max_slots: int = 8
    # ... and TTL (seconds).  Clients renew active leases in the background;
    # the head revokes unrenewed ones so a wedged client can't hold
    # capacity forever.
    lease_ttl_s: float = 10.0
    # Client-side: return a lease that served no task for this long, so
    # idle-held slots (and their reserved resources) flow back to the
    # cluster promptly.
    lease_idle_return_s: float = 2.0
    # Per-slot pipelining window: specs in flight on one leased worker
    # before the client queues locally.  Deep enough that a whole burst
    # ships in one coalesced flush (a shallow window dribbles the tail out
    # one send per completion, paying a loop wakeup each); bounded so a
    # runaway submit loop can't grow worker queues without limit.
    direct_inflight_per_slot: int = 256
    # Peer dials fail fast (a dead worker's address must not stall the
    # caller for the full control-plane connect timeout).
    peer_connect_timeout_s: float = 2.0
    # In-flight deadline budget for a direct peer call: a submitted call
    # that hasn't completed within this window is re-routed via the head
    # and its route quarantined — the gray-failure net that
    # peer_connect_timeout_s (dial only) cannot catch.  Generous by
    # default: a legitimately slow actor method must not trip it (the
    # worker-side dedup cache makes an early re-route harmless, but not
    # free).
    peer_call_deadline_s: float = 30.0
    # How long a quarantined peer route stays degraded to the head path
    # before the next dial re-probes it.
    peer_quarantine_probe_s: float = 5.0
    # Control-plane persistence: when set, the head snapshots its durable
    # state (KV table + named-actor specs) here and restores on startup —
    # the analog of GCS fault tolerance via Redis-backed tables
    # (reference: src/ray/gcs/store_client/redis_store_client.h:33).
    head_state_path: str = ""
    # -- head fault tolerance (headless degraded mode) ------------------------
    # How long a node daemon / worker keeps redialing a lost head before
    # giving up and self-terminating.  While headless, in-flight tasks,
    # direct actor calls, peer streaming, and granted leases keep running;
    # the deadline guarantees an orphaned cluster (head never restarted)
    # still dies instead of leaking forkserver/worker processes
    # (reference: GCS FT — raylets reconnect with a bounded
    # gcs_rpc_server_reconnect_timeout_s, ray_config_def.h).
    head_reconnect_deadline_s: float = 45.0
    # Client-side: how long idempotent head reads keep retrying (with
    # reconnect attempts between tries) across a head restart window
    # before surfacing the connection error — the "bounded pause" on
    # head-routed ops while the head is down.
    head_restart_retry_window_s: float = 20.0
    # Head-side: after a restart, how long the head waits for field-state
    # resync reports (workers re-registering with their live actors)
    # before replaying unclaimed named actors from the durable snapshot —
    # adopting a live actor must win over re-creating it fresh.  Also the
    # window during which submissions to not-yet-reported actors park
    # instead of failing.  Must comfortably exceed the reconnect loops'
    # max backoff (2 s), or adoptions lose the race to driver replays.
    head_resync_grace_s: float = 5.0
    # -- observability --------------------------------------------------------
    task_events_buffer_size: int = 100_000
    enable_timeline: bool = True
    # Root-trace sampling rate, handed to every registering process in the
    # register reply (the head is the config source, so ONE knob governs
    # the whole cluster): 1.0 traces every root span, 0 disables tracing;
    # tracing.trace(..., force=True) is the per-call override.
    trace_sample_rate: float = 1.0
    # Per-process bounded span ring (util/tracing.py): finished spans
    # buffer here and flush as one batched span_batch RPC on the
    # background-report cadence; overflow drops (counted in
    # ray_tpu_spans_dropped_total), never blocks the emitting thread.
    span_ring_size: int = 4096
    # Per-process bounded engine step-record ring (util/steprec.py): the
    # serve engine's flight recorder appends one fixed-size record per
    # decode step here; records flush as one batched engine_step_batch RPC
    # on the background-report cadence.  Overflow drops (counted in
    # ray_tpu_step_records_dropped_total), never blocks the decode loop.
    step_ring_size: int = 2048
    # Black-box sidecar: the last N step records are mirrored to a
    # *.steps.log file next to the worker's log on every flush, so a
    # SIGKILLed worker leaves its final steps on disk for
    # `ray_tpu_torch logs --post-mortem`.  0 disables the sidecar.
    step_dump_records: int = 256
    # Minimum seconds between sidecar rewrites (the dump is a whole-file
    # rewrite of <= step_dump_records compact JSON lines).
    step_dump_interval_s: float = 1.0
    # Head-side retention: step records kept per engine for
    # list_state(kind="engine_steps") / `ray_tpu_torch top`.
    engine_steps_max_records: int = 1024
    # Per-process bounded gang round-record ring (util/gangrec.py): the
    # train session appends one fixed-size record per training round
    # (step wall, data/collective/ack/checkpoint waits, tokens, MFU);
    # records flush as one batched gang_round_batch RPC on the
    # background-report cadence.  Overflow drops (counted in
    # ray_tpu_gang_rounds_dropped_total), never blocks report().
    gang_ring_size: int = 2048
    # Black-box sidecar: the last N round records are mirrored to a
    # *.rounds.log file next to the worker's log, so a SIGKILLed rank
    # leaves its final rounds on disk for `ray_tpu_torch logs --post-mortem`.
    # 0 disables the sidecar.
    gang_dump_records: int = 256
    # Minimum seconds between rounds-sidecar rewrites.
    gang_dump_interval_s: float = 1.0
    # Head-side retention for the gang join: joined rounds kept per gang
    # for list_state(kind="gang_rounds") / `ray_tpu_torch gang`, and the cap on
    # distinct gangs tracked at once (oldest-idle gang evicts first).
    gang_rounds_max_records: int = 512
    gang_rounds_max_gangs: int = 64
    # Per-process metrics flusher cadence (util/metrics.py).  An atexit hook
    # ships the final window regardless, so short-lived workers don't lose
    # their last deltas.
    metrics_flush_interval_s: float = 2.0
    # Head-side time-series retention: each (metric, tags) series keeps a
    # downsampled ring of this many samples, appended at most once per
    # min-interval (reference: the dashboard's time-series panels read the
    # GCS-aggregated OpenCensus views; here the head IS the store).
    metrics_history_max_samples: int = 360
    metrics_history_min_interval_s: float = 1.0
    # Ceiling on distinct retained series — a tag-cardinality explosion
    # must not grow head memory without bound; new series beyond the cap
    # are dropped (the ones already retained keep recording).
    metrics_history_max_series: int = 1024
    # -- health / incident plane (util/health.py, head wiring) ----------------
    # Master switch for the head's detector pass.  Detectors run on the
    # telemetry sampling cadence; the pass is O(watched series) and adds
    # no RPCs, so it stays on by default.
    health_enabled: bool = True
    # Suspicion window the counter-delta detectors (partition, drops,
    # stall pressure, head loop lag) evaluate over.
    health_window_s: float = 30.0
    # Hysteresis: an open incident whose detector stays quiet this long
    # flips to resolved (and stays in the bounded ring for `doctor`).
    health_resolve_after_s: float = 20.0
    # Bounded incident ring on the head (head-volatile, like the
    # timeline): oldest-resolved evict first.
    health_max_incidents: int = 256
    # SLO availability goal for the serve burn-rate detector: the error
    # budget is 1 - goal (0.95 -> 5% of requests may breach the latency
    # target before the budget burns).
    health_slo_goal: float = 0.95
    # Explicit TTFT/ITL targets (seconds) for the burn-rate detector.
    # 0 = take the targets serve deployments declare (autoscaling
    # target_ttft_s, published to the head at deploy); with neither, the
    # SLO detector stays silent — no target means no budget to burn.
    health_slo_ttft_s: float = 0.0
    health_slo_itl_s: float = 0.0
    # Multi-window burn evaluation spans (Google-SRE shape: BOTH windows
    # must burn above threshold for a firing).
    health_slo_fast_window_s: float = 60.0
    health_slo_slow_window_s: float = 300.0
    # Push-style alerting for incident open/resolve transitions:
    # "" disables, "log" writes WARNING lines to the head log, an
    # http(s):// URL gets a JSON POST per transition (fire-and-forget on
    # a daemon thread — a dead webhook never blocks the head loop).
    alert_sink: str = ""
    # -- debugging plane ------------------------------------------------------
    # Cluster-wide log index: every worker/daemon registers its log file at
    # startup; entries of exited processes are RETAINED for crash
    # post-mortems (`get_log` on a dead worker) until this bound evicts
    # them, dead-oldest first (reference: the GCS keeps worker table
    # entries past death for `ray logs`).
    log_index_max_entries: int = 2000
    # Per-task lifecycle histories (SUBMITTED/SCHEDULED/RUNNING/FINISHED/
    # FAILED transitions + failure traceback) retained for
    # list_state(kind="task_events") (reference: gcs_task_manager.h task
    # event store).  0 disables recording.
    task_history_max_tasks: int = 10_000
    # Transition events kept per task record (retry loops must not grow a
    # record without bound; the oldest post-SUBMITTED events drop first).
    task_history_max_events: int = 64

    def __post_init__(self):
        if self.object_store_memory == 0:
            try:
                ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
            except (ValueError, OSError):
                ram = 8 * 1024**3
            self.object_store_memory = min(int(ram * 0.30), 32 * 1024**3)

    def apply_env_overrides(self) -> "Config":
        for f in dataclasses.fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))
        self.__post_init__()
        return self

    def apply_overrides(self, overrides: Dict[str, Any] | None) -> "Config":
        for k, v in (overrides or {}).items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown system_config key: {k}")
            setattr(self, k, v)
        self.__post_init__()  # re-resolve auto (0) values
        return self


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_env_overrides()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg


def host_memory_used_frac() -> float:
    """This host's memory pressure from /proc/meminfo (the MemoryMonitor
    input — reference: src/ray/common/memory_monitor.h:52 reads the same
    kernel counters)."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                info[key] = int(rest.strip().split()[0])
        total = info["MemTotal"]
        avail = info.get("MemAvailable", total)
        return 1.0 - avail / total
    except (OSError, KeyError, ValueError, ZeroDivisionError):
        return 0.0
