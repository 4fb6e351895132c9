"""Metric instruments: Counter / Gauge / Histogram (port of
``ray_tpu/util/metrics.py``).

Instruments are process-local: each keeps its values per tag set, and
``_snapshot()`` hands back one row per tag set in the JAX package's row
format, which ``prometheus_text(rows)`` renders in the Prometheus exposition
format (same escaping, same number format, cumulative histogram buckets).
``get_counter`` / ``get_gauge`` / ``get_histogram`` return one process-wide
instrument per name (first call wins), so hot paths hoist them once.

As in the JAX package, the first instrument a process registers starts a
background flusher (``_ensure_flusher``): every ``metrics_flush_interval_s``
(``_cfg()``, the runtime's config) it ships every row as one
``metrics_report`` call through the runtime's client (``ctx.client``), which
the head aggregates across processes, and an atexit hook ships the last
window (``_final_flush``).  ``flush_metrics(client)`` is one such round;
with no client, and no runtime started, it returns 0.  This module imports
nothing of JAX and nothing of ``ray_tpu``.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: Catalog of every built-in ``ray_tpu_*`` metric the framework emits,
#: name -> kind.  This is the contract operators wire dashboards and
#: alerts against; rtlint rule RT006 asserts the package's emitters and
#: this catalog agree (an uncataloged emission is invisible
#: infrastructure, a row nothing emits is a panel that never populates).
#: Adding a built-in metric means adding its row here in the same PR.
BUILTIN_METRICS: Dict[str, str] = {
    # scheduler / tasks (core/telemetry.py)
    "ray_tpu_scheduler_submit_to_start_seconds": "histogram",
    "ray_tpu_scheduler_queue_depth": "gauge",
    "ray_tpu_scheduler_tasks_dispatched_total": "counter",
    "ray_tpu_task_duration_seconds": "histogram",
    # object store (core/telemetry.py)
    "ray_tpu_object_store_used_bytes": "gauge",
    "ray_tpu_object_store_capacity_bytes": "gauge",
    "ray_tpu_object_store_bytes_stored_total": "gauge",
    "ray_tpu_object_store_bytes_transferred_total": "gauge",
    "ray_tpu_object_store_hit_rate": "gauge",
    # train goodput (train/telemetry.py)
    "ray_tpu_train_step_seconds": "gauge",
    "ray_tpu_train_tokens_per_sec": "gauge",
    "ray_tpu_train_mfu": "gauge",
    "ray_tpu_train_compile_seconds": "gauge",
    # serve (serve/replica.py, serve/batching.py, serve/handle.py)
    "ray_tpu_serve_request_latency_seconds": "histogram",
    "ray_tpu_serve_replica_queue_depth": "gauge",
    "ray_tpu_serve_batch_size": "histogram",
    "ray_tpu_serve_batch_queue_depth": "gauge",
    "ray_tpu_serve_replica_retries_total": "counter",
    # LLM inference engine (serve/engine.py)
    "ray_tpu_gen_tokens_total": "counter",
    "ray_tpu_gen_prefill_tokens_total": "counter",
    "ray_tpu_gen_kv_pages_in_use": "gauge",
    "ray_tpu_serve_engine_queue_depth": "gauge",
    "ray_tpu_serve_engine_active_seqs": "gauge",
    "ray_tpu_serve_engine_shed_total": "counter",
    "ray_tpu_serve_engine_completed_total": "counter",
    "ray_tpu_serve_engine_cancelled_total": "counter",
    "ray_tpu_serve_engine_ttft_seconds": "histogram",
    "ray_tpu_serve_engine_itl_seconds": "histogram",
    # multi-tenant serving plane (serve/engine.py)
    "ray_tpu_serve_prefix_cache_hits_total": "counter",
    "ray_tpu_serve_prefix_cache_pages_shared": "gauge",
    "ray_tpu_serve_adapter_evictions_total": "counter",
    "ray_tpu_serve_tenant_shed_total": "counter",
    # data (data/dataset.py)
    "ray_tpu_data_rows_total": "counter",
    "ray_tpu_data_stage_seconds_total": "counter",
    "ray_tpu_data_rows_per_sec": "gauge",
    # autoscaler (autoscaler/__init__.py)
    "ray_tpu_autoscaler_demand": "gauge",
    "ray_tpu_autoscaler_decisions_total": "counter",
    # dataplane (core/dataplane.py client-side; core/telemetry.py head-side)
    "ray_tpu_direct_calls_total": "counter",
    "ray_tpu_leased_tasks_total": "counter",
    "ray_tpu_lease_revocations_total": "counter",
    # head fault tolerance (core/telemetry.py head-side)
    "ray_tpu_head_restarts_total": "counter",
    "ray_tpu_headless_seconds": "gauge",
    "ray_tpu_resync_reports_total": "counter",
    # network fault plane (util/netfault.py injection sites; core/deadline.py
    # retry/deadline sites; core/dataplane.py quarantines)
    "ray_tpu_netfaults_injected_total": "counter",
    "ray_tpu_rpc_retries_total": "counter",
    "ray_tpu_rpc_deadline_exceeded_total": "counter",
    "ray_tpu_peer_quarantines_total": "counter",
    # logging plane (core/worker_main.py)
    "ray_tpu_logs_dropped_total": "counter",
    # tracing span plane (util/tracing.py): batched flushes + visible drops
    "ray_tpu_spans_emitted_total": "counter",
    "ray_tpu_spans_dropped_total": "counter",
    # engine step flight recorder (util/steprec.py ring; serve/engine.py
    # records; core/head.py h_engine_step_batch joins)
    "ray_tpu_step_records_flushed_total": "counter",
    "ray_tpu_step_records_dropped_total": "counter",
    "ray_tpu_engine_stall_seconds_total": "counter",
    # device-memory accounting (util/devmem.py)
    "ray_tpu_devmem_pool_bytes": "gauge",
    # on-demand profiler capture (core/worker_main.py profile handler)
    "ray_tpu_profile_captures_total": "counter",
    # health / incident plane (core/head.py wiring over util/health.py;
    # loop-lag + handler histograms are the head's self-observability)
    "ray_tpu_incidents_opened_total": "counter",
    "ray_tpu_incidents_resolved_total": "counter",
    "ray_tpu_head_loop_lag_seconds": "gauge",
    "ray_tpu_head_rpc_handler_seconds": "histogram",
    # gang training observability (util/gangrec.py ring; train/session.py
    # round records; collective/collective.py per-op timing;
    # core/head.py h_gang_round_batch joins)
    "ray_tpu_gang_rounds_flushed_total": "counter",
    "ray_tpu_gang_rounds_dropped_total": "counter",
    "ray_tpu_gang_round_skew_seconds": "histogram",
    "ray_tpu_gang_data_wait_seconds": "histogram",
    "ray_tpu_collective_op_seconds": "histogram",
    "ray_tpu_collective_bytes_total": "counter",
    # put-path contention accounting (core/object_store.py stages + lock
    # waits; core/rpc.py outbox queue delay)
    "ray_tpu_store_lock_wait_seconds": "histogram",
    "ray_tpu_put_copy_seconds": "histogram",
    "ray_tpu_rpc_outbox_delay_seconds": "histogram",
}


def _cfg():
    """The runtime's config (tests may replace this hook)."""
    from ..core.config import get_config

    return get_config()


_registry_lock = threading.Lock()
_instruments: List["_Metric"] = []
_named: Dict[Tuple[str, str], "_Metric"] = {}  # (kind, name) -> instrument
_flusher_started = False


def _tags_key(tags: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((tags or {}).items()))


class _Metric:
    kind = "counter"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = (), register: bool = True):
        """``register=False`` keeps the instrument out of the process
        flusher — used by the head, which aggregates its own instruments
        directly instead of reporting to itself over RPC."""
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()
        if register:
            with _registry_lock:
                _instruments.append(self)
            _ensure_flusher()

    def _snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {"name": self.name, "kind": self.kind,
                 "description": self.description,
                 "tags": dict(k), "value": v}
                for k, v in self._values.items()
            ]


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        k = _tags_key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[_tags_key(tags)] = value


class Histogram(_Metric):
    """Fixed-boundary histogram; a row carries bucket counts and the sum."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (),
                 tag_keys: Sequence[str] = (), register: bool = True):
        super().__init__(name, description, tag_keys, register=register)
        self.boundaries = tuple(boundaries) or (
            0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10,
        )
        self._buckets: Dict[Tuple, List[float]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._counts: Dict[Tuple, int] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = _tags_key(tags)
        with self._lock:
            b = self._buckets.setdefault(
                k, [0.0] * (len(self.boundaries) + 1)
            )
            for i, bound in enumerate(self.boundaries):
                if value <= bound:
                    b[i] += 1
                    break
            else:
                b[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1

    def _snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {"name": self.name, "kind": self.kind,
                 "description": self.description, "tags": dict(k),
                 "boundaries": list(self.boundaries),
                 "buckets": list(self._buckets.get(k, [])),
                 "sum": self._sums.get(k, 0.0),
                 "count": self._counts.get(k, 0),
                 "value": self._counts.get(k, 0)}
                for k in self._counts
            ]


# -- memoized getters (auto-instrumentation call sites) -----------------------
# Hot paths must not create a new instrument per call: these return one
# process-wide instrument per name.


def _get_named(key: Tuple[str, str], make) -> "_Metric":
    """Lookup-or-create under ONE lock hold, so a racing first call cannot
    register a duplicate.  First call wins: description, boundaries and
    tag_keys passed by LATER calls for the same (kind, name) are ignored,
    so call sites for one metric must agree on its shape."""
    with _registry_lock:
        m = _named.get(key)
        if m is None:
            m = _named[key] = make()
            _instruments.append(m)
    _ensure_flusher()
    return m


def get_counter(name: str, description: str = "",
                tag_keys: Sequence[str] = ()) -> Counter:
    return _get_named(  # type: ignore[return-value]
        ("counter", name),
        lambda: Counter(name, description, tag_keys, register=False))


def get_gauge(name: str, description: str = "",
              tag_keys: Sequence[str] = ()) -> Gauge:
    return _get_named(  # type: ignore[return-value]
        ("gauge", name),
        lambda: Gauge(name, description, tag_keys, register=False))


def get_histogram(name: str, description: str = "",
                  boundaries: Sequence[float] = (),
                  tag_keys: Sequence[str] = ()) -> Histogram:
    return _get_named(  # type: ignore[return-value]
        ("histogram", name),
        lambda: Histogram(name, description, boundaries, tag_keys,
                          register=False))


def snapshot_rows() -> List[dict]:
    """Every registered instrument's rows, in registration order: what a
    flush ships and what ``prometheus_text`` renders."""
    with _registry_lock:
        instruments = list(_instruments)
    rows: List[dict] = []
    for m in instruments:
        rows.extend(m._snapshot())
    return rows


def flush_metrics(client=None) -> int:
    """Ship every row as one ``metrics_report`` call through ``client``
    (default: the runtime's, ``ctx.client``); returns the rows shipped.
    With no client this returns 0."""
    if client is None:
        from ..core.context import ctx

        client = ctx.client
    if client is None:
        return 0
    rows = snapshot_rows()
    if not rows:
        return 0
    try:
        client.call_bg("metrics_report", {"pid": os.getpid(), "rows": rows})
    except Exception:
        return 0
    return len(rows)


def _flush_once():
    flush_metrics()


def _flush_interval() -> float:
    try:
        return max(0.1, float(_cfg().metrics_flush_interval_s))
    except Exception:
        return 2.0


def _final_flush():
    """atexit hook: ship the last window of deltas so short-lived workers
    (a task-pool worker reaped right after its task, a driver script that
    exits immediately) don't lose their final metrics."""
    try:
        _flush_once()
        from ..core.context import ctx

        # Short drain bound: a wedged head must not stall process exit.
        if ctx.client is not None:
            ctx.client.drain_bg(timeout=2.0)
    except Exception:
        pass


def _ensure_flusher():
    global _flusher_started
    with _registry_lock:
        if _flusher_started:
            return
        _flusher_started = True

    def loop():
        while True:
            time.sleep(_flush_interval())
            _flush_once()

    threading.Thread(target=loop, daemon=True, name="metrics-flush").start()
    atexit.register(_final_flush)


# -- Prometheus exposition ----------------------------------------------------


def _escape_label(v) -> str:
    """Escape a label value per the exposition format: backslash, quote,
    and newline must be escaped inside the double-quoted value."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(tags: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in sorted(tags.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def prometheus_text(rows: List[dict]) -> str:
    """Render metric rows in the Prometheus exposition format.  Histograms
    emit the full spec shape: cumulative ``name_bucket{le="..."}`` series
    ending in ``le="+Inf"``, plus ``name_sum`` and ``name_count``."""
    out = []
    seen = set()
    for r in rows:
        name = r["name"]
        kind = r.get("kind", "counter")
        if name not in seen:
            seen.add(name)
            if r.get("description"):
                desc = str(r["description"]).replace("\\", "\\\\") \
                                            .replace("\n", "\\n")
                out.append(f"# HELP {name} {desc}")
            out.append(f"# TYPE {name} {kind}")
        tags = r.get("tags", {})
        if kind == "histogram" and r.get("boundaries") is not None:
            buckets = list(r.get("buckets") or [])
            bounds = list(r["boundaries"])
            # Per-bucket counts -> cumulative counts per the spec.
            cum = 0.0
            for bound, n in zip(bounds, buckets):
                cum += n
                le = _label_str(tags, f'le="{_fmt(bound)}"')
                out.append(f"{name}_bucket{le} {_fmt(cum)}")
            if len(buckets) > len(bounds):
                cum += buckets[-1]
            inf = _label_str(tags, 'le="+Inf"')
            count = r.get("count", cum)
            # +Inf must equal _count even when bucket data is missing.
            out.append(f"{name}_bucket{inf} {_fmt(max(cum, count))}")
            label = _label_str(tags)
            out.append(f"{name}_sum{label} {_fmt(r.get('sum', 0.0))}")
            out.append(f"{name}_count{label} {_fmt(count)}")
        else:
            label = _label_str(tags)
            out.append(f"{name}{label} {r['value']}")
    return "\n".join(out) + "\n"
