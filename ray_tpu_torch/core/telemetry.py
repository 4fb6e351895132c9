"""Head-side telemetry: built-in ``ray_tpu_*`` instruments and a bounded
time-series history of every cluster metric.

Role-equivalent to the reference's stats plane (reference:
src/ray/stats/metric_defs.cc — the built-in ray_* metric set; the dashboard
reads time series from the metrics agents via Prometheus).  Re-designed for
this framework's centralized head: the head already receives every
process's metric snapshots (``metrics_report``), so it *is* the natural
time-series store — a bounded, downsampled ring per (metric, tags) series,
served by ``list_state(kind="metrics_history")`` and the dashboard's
``/api/metrics/history`` endpoint, with sparkline panels in the HTML UI.

The head's own instruments (scheduler latency/queue depth, object-store
pressure, task durations) are plain ``util.metrics`` instruments created
with ``register=False``: they never ride the RPC flusher (the head would
be reporting to itself) — ``Head.metrics_rows()`` merges their snapshots
into the cluster aggregate directly.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..util.metrics import Counter, Gauge, Histogram


class MetricsHistory:
    """Bounded, downsampled ring per (metric name, tags) series.

    Appends are throttled to one sample per ``min_interval_s`` per series
    (the downsampling: a 2 s flusher cadence across 100 workers would
    otherwise burn the ring on near-duplicate timestamps), the ring holds
    ``max_samples`` points, and at most ``max_series`` distinct series are
    retained (tag-cardinality explosions drop new series, never grow
    memory)."""

    def __init__(self, max_samples: int = 360,
                 min_interval_s: float = 1.0, max_series: int = 1024):
        self.max_samples = max(2, int(max_samples))
        self.min_interval_s = float(min_interval_s)
        self.max_series = max(1, int(max_series))
        self._series: Dict[Tuple, dict] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(row: dict) -> Tuple:
        return (row["name"], tuple(sorted((row.get("tags") or {}).items())))

    def record(self, rows: List[dict], ts: Optional[float] = None) -> None:
        """Append one sample per series from aggregated metric rows.
        Histogram rows record their cumulative count (rate-of-change over
        the ring is the observation rate).

        Points are ``[ts, mean, min, max]``: samples arriving inside a
        series' ``min_interval_s`` bucket fold into the open point's
        running mean and min/max instead of being dropped — burn-rate and
        anomaly consumers need the extremes the mean would average away,
        and sparkline consumers keep reading indices 0/1 unchanged."""
        now = ts if ts is not None else time.time()
        with self._lock:
            for row in rows:
                value = row.get("value")
                if not isinstance(value, (int, float)):
                    continue
                key = self._key(row)
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self.max_series \
                            and not self._evict_stale(now):
                        continue  # cap reached, nothing stale to drop
                    s = self._series[key] = {
                        "name": row["name"],
                        "tags": dict(row.get("tags") or {}),
                        "kind": row.get("kind", "gauge"),
                        "points": deque(maxlen=self.max_samples),
                        "last_ts": 0.0,
                        "bucket_n": 0,
                    }
                v = float(value)
                if now - s["last_ts"] < self.min_interval_s and s["points"]:
                    p = s["points"][-1]
                    s["bucket_n"] += 1
                    p[1] += (v - p[1]) / s["bucket_n"]
                    p[2] = min(p[2], v)
                    p[3] = max(p[3], v)
                    continue
                s["last_ts"] = now
                s["bucket_n"] = 1
                s["points"].append([now, v, v, v])

    def _evict_stale(self, now: float) -> bool:
        """Make room at the series cap by dropping the longest-idle series,
        but only if it is genuinely dead (no sample for the stale window) —
        tag churn (per-pid replica gauges, per-rank train gauges) must not
        permanently crowd out freshly started live series, while an active
        series must never lose its ring to a newcomer."""
        stale_after = max(60.0, 30.0 * self.min_interval_s)
        oldest_key = min(self._series, key=lambda k: self._series[k]["last_ts"])
        if now - self._series[oldest_key]["last_ts"] < stale_after:
            return False
        del self._series[oldest_key]
        return True

    def snapshot(self, name_prefix: str = "") -> List[dict]:
        with self._lock:
            return [
                {"name": s["name"], "tags": s["tags"], "kind": s["kind"],
                 "points": [list(p) for p in s["points"]]}
                for s in self._series.values()
                if s["name"].startswith(name_prefix)
            ]


class HeadMetrics:
    """The head's built-in instrument set (all ``register=False``: snapshots
    are merged into the cluster aggregate by ``Head.metrics_rows()``)."""

    #: boundaries tuned for control-plane latencies (seconds).
    _LATENCY_BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10, 60)

    def __init__(self):
        self.submit_to_start = Histogram(
            "ray_tpu_scheduler_submit_to_start_seconds",
            "Latency from task submission to dispatch on a worker",
            boundaries=self._LATENCY_BOUNDS, register=False)
        self.queue_depth = Gauge(
            "ray_tpu_scheduler_queue_depth",
            "Tasks queued or parked awaiting dispatch", register=False)
        self.tasks_dispatched = Counter(
            "ray_tpu_scheduler_tasks_dispatched_total",
            "Tasks dispatched to workers", register=False)
        self.task_duration = Histogram(
            "ray_tpu_task_duration_seconds",
            "Execution-span durations of traced tasks",
            boundaries=self._LATENCY_BOUNDS, register=False)
        self.store_used = Gauge(
            "ray_tpu_object_store_used_bytes",
            "Shared-memory object store bytes in use across cluster nodes",
            register=False)
        self.store_capacity = Gauge(
            "ray_tpu_object_store_capacity_bytes",
            "Total shared-memory object store capacity across cluster nodes",
            register=False)
        self.store_stored = Gauge(
            "ray_tpu_object_store_bytes_stored_total",
            "Cumulative bytes written into cluster object stores",
            register=False)
        self.store_transferred = Gauge(
            "ray_tpu_object_store_bytes_transferred_total",
            "Cumulative bytes served to cross-node object pulls",
            register=False)
        self.store_hit_rate = Gauge(
            "ray_tpu_object_store_hit_rate",
            "Fraction of store reads served from shm (vs miss/spill), cluster-wide",
            register=False)
        self.lease_revocations = Counter(
            "ray_tpu_lease_revocations_total",
            "Task-lease revocations (TTL expiry, node drain, worker death, "
            "or scheduler preemption of idle-held slots)",
            tag_keys=("reason",), register=False)
        # -- head fault tolerance (headless mode + field-state resync) --------
        self.head_restarts = Counter(
            "ray_tpu_head_restarts_total",
            "Head restarts observed (durable snapshot restored at boot)",
            register=False)
        self.headless_seconds = Gauge(
            "ray_tpu_headless_seconds",
            "Cumulative seconds each node daemon has run without a head "
            "connection (reconnect loop active, field ops degraded)",
            tag_keys=("node",), register=False)
        self.resync_reports = Counter(
            "ray_tpu_resync_reports_total",
            "Field-state resync reports adopted at re-register (nodes "
            "replaying store manifests, workers re-binding live actors)",
            tag_keys=("kind",), register=False)
        # -- health / incident plane (util/health.py, wired in the head) ------
        self.incidents_opened = Counter(
            "ray_tpu_incidents_opened_total",
            "Incidents opened by the health detector pass",
            tag_keys=("kind",), register=False)
        self.incidents_resolved = Counter(
            "ray_tpu_incidents_resolved_total",
            "Incidents resolved after their detector went quiet",
            register=False)
        self.loop_lag = Gauge(
            "ray_tpu_head_loop_lag_seconds",
            "Head event-loop scheduling lag measured by the periodic-tick "
            "probe (how late the tick woke up)", register=False)
        self.rpc_handler = Histogram(
            "ray_tpu_head_rpc_handler_seconds",
            "Head RPC handler wall time per method",
            boundaries=self._LATENCY_BOUNDS, tag_keys=("method",),
            register=False)
        # -- gang training observability (h_gang_round_batch join) ------------
        self.gang_round_skew = Histogram(
            "ray_tpu_gang_round_skew_seconds",
            "Per-round gang skew (straggler's lead over the median rank) "
            "observed when a round joins across all ranks",
            boundaries=self._LATENCY_BOUNDS, register=False)
        self._all = [
            self.submit_to_start, self.queue_depth, self.tasks_dispatched,
            self.task_duration, self.store_used, self.store_capacity,
            self.store_stored, self.store_transferred, self.store_hit_rate,
            self.lease_revocations,
            self.head_restarts, self.headless_seconds, self.resync_reports,
            self.incidents_opened, self.incidents_resolved, self.loop_lag,
            self.rpc_handler, self.gang_round_skew,
        ]

    def sample_store(self, stats: dict) -> None:
        """Refresh object-store gauges from an ObjectStore.stats() dict."""
        self.store_used.set(float(stats.get("used_bytes", 0)))
        self.store_capacity.set(float(stats.get("capacity_bytes", 0)))
        self.store_stored.set(float(stats.get("bytes_stored_total", 0)))
        self.store_transferred.set(
            float(stats.get("bytes_transferred_total", 0)))
        hits = stats.get("gets_hit", 0)
        misses = stats.get("gets_miss", 0)
        if hits + misses > 0:
            self.store_hit_rate.set(hits / (hits + misses))

    def rows(self) -> List[dict]:
        out: List[dict] = []
        for m in self._all:
            out.extend(m._snapshot())
        return out
