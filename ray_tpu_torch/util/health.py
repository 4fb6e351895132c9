"""Cluster health plane: cross-signal incident detection on the head.

Role-equivalent to the monitoring-as-part-of-the-system posture TorchTitan
(PAPERS.md) argues for, layered over this framework's existing telemetry
streams.  The head already receives everything an operator would correlate
by hand — metric snapshots, spans, task events, netfault/quarantine
counters, step records, devmem pools — so it is the natural place to run
the correlation continuously.  This module supplies three layers:

1. **Pure detectors** — free functions over bounded windows of samples.
   Every detector takes explicit inputs and a params dict and returns a
   list of *firings*; none of them touch head state, clocks, or config, so
   each one unit-tests with a seeded window and a clean one.
2. **IncidentManager** — firings become typed, deduped ``Incident``
   records with hysteresis: a firing *opens* an incident (or re-arms the
   open one, state ``active``); an incident whose key stays quiet for
   ``resolve_after_s`` *resolves*.  Resolved incidents stay in the bounded
   ring for ``ray_tpu_torch doctor`` replay; nothing survives the head process
   (head-volatile by design, like the timeline ring).
3. **HealthEngine** — the head-facing facade: owns the sample windows,
   extracts the watched series from the aggregated metric rows each
   telemetry tick, runs every detector, and feeds the manager.  The whole
   tick is O(watched series + step records in window) and runs on the
   head loop — no locks needed, and a detector bug never breaks telemetry
   (the head wraps the tick in a try/except).

The SLO burn-rate detector follows the Google-SRE multi-window shape: the
error budget is ``1 - goal`` and an alert needs BOTH the fast and the slow
window burning above the threshold — the fast window gates detection
latency, the slow window stops a single bad batch from paging anyone.
"""

from __future__ import annotations

import itertools
import logging
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

# Incident severities, ordered.  A CRIT incident trips the cluster grade.
SEV_WARN = "warn"
SEV_CRIT = "crit"

# Incident lifecycle states.
OPEN = "open"          # first firing, just noticed
ACTIVE = "active"      # fired again after opening (sustained)
RESOLVED = "resolved"  # quiet for resolve_after_s

#: Default detector thresholds.  These are detector-local tuning, not
#: cluster config: tests override them per-call, operators get the
#: windows/goals that matter via Config (health_* fields).
DEFAULTS: Dict[str, Any] = {
    # SLO burn rate (Google-SRE multi-window): burn = bad_frac / budget.
    # 14.4x burns a 30-day budget in ~2 days; 6x in ~5 days.  Both windows
    # must burn for a firing.
    "burn_fast_s": 60.0,
    "burn_slow_s": 300.0,
    "burn_fast_x": 14.4,
    "burn_slow_x": 6.0,
    "burn_min_events": 8,     # too few requests -> no signal, stay silent
    "slo_goal": 0.95,
    # Stall pressure / step-wall jitter.
    "stall_frac_warn": 0.5,   # >50% of window wall spent admission-stalled
    "stall_min_steps": 8,
    "jitter_ratio_warn": 20.0,  # p99 step wall / p50 step wall
    "jitter_min_steps": 24,
    # Partition / gray-failure suspicion (counter deltas over the window).
    "partition_min_quarantines": 1,
    "partition_min_deadlines": 3,
    # Drop pressure: ANY telemetry drops in the window are worth a WARN —
    # the rings are sized so steady state never drops.
    "drop_min": 1,
    # Devmem pool leak: strictly-growing pool across the whole window.
    "leak_min_samples": 6,
    "leak_min_bytes": 64 * 1024 * 1024,
    # Head self-observability.
    "loop_lag_warn_s": 0.5,
    "loop_lag_crit_s": 2.0,
    # Gang training plane (joined round skew profiles, util/gangrec.py).
    # Persistent straggler: the SAME rank arrives last in >= frac of the
    # windowed rounds AND its median skew is a meaningful fraction of the
    # round wall (absolute thresholds would be workload-dependent).
    "straggler_min_rounds": 6,
    "straggler_frac": 0.5,
    "straggler_skew_frac": 0.2,
    "straggler_skew_crit_frac": 1.0,  # skew >= the whole median wall
    # Data starvation: the gang's mean data wait dominates the round.
    "data_starved_frac": 0.5,
    "data_min_rounds": 6,
    # Collective desync/timeout suspicion: collective waits dominate the
    # round — some rank is late to (or wedged in) every op.
    "coll_desync_frac": 0.6,
    "coll_min_rounds": 6,
    # Trailing-window MFU regression: recent-half mean vs first-half mean.
    "mfu_drop_frac": 0.2,
    "mfu_min_rounds": 12,
}


def _params(over: Optional[dict]) -> Dict[str, Any]:
    if not over:
        return dict(DEFAULTS)
    p = dict(DEFAULTS)
    p.update(over)
    return p


class SeriesWindow:
    """Bounded (ts, value) samples of ONE metric series, appended on the
    health tick cadence.  Deltas are counter-reset tolerant: a value drop
    (process restart zeroing a counter) clamps to the post-reset value."""

    __slots__ = ("points",)

    def __init__(self, maxlen: int = 512):
        self.points: deque = deque(maxlen=maxlen)

    def add(self, ts: float, value: float) -> None:
        if self.points and self.points[-1][0] >= ts:
            return
        self.points.append((ts, float(value)))

    def latest(self) -> Optional[float]:
        return self.points[-1][1] if self.points else None

    def delta(self, now: float, window_s: float) -> float:
        """Counter increase across [now - window_s, now]."""
        if not self.points:
            return 0.0
        start = now - window_s
        base = None
        for ts, v in self.points:
            if ts >= start:
                break
            base = v
        if base is None:  # series younger than the window: first sample
            base = self.points[0][1]
        total = 0.0
        prev = base
        for ts, v in self.points:
            if ts < start:
                continue
            if v >= prev:
                total += v - prev
            else:  # counter reset
                total += v
            prev = v
        return total

    def max_over(self, now: float, window_s: float) -> Optional[float]:
        vals = [v for ts, v in self.points if ts >= now - window_s]
        return max(vals) if vals else None


class RatioWindow:
    """(ts, good, total) cumulative samples for one SLO signal (e.g. the
    count of TTFT observations under target vs all observations)."""

    __slots__ = ("points",)

    def __init__(self, maxlen: int = 512):
        self.points: deque = deque(maxlen=maxlen)

    def add(self, ts: float, good: float, total: float) -> None:
        if self.points and self.points[-1][0] >= ts:
            return
        self.points.append((ts, float(good), float(total)))

    def bad_fraction(self, now: float, window_s: float):
        """(bad_frac, events) across the window, or (None, 0) when the
        window has no delta to judge (reset-tolerant like SeriesWindow)."""
        if len(self.points) < 2:
            return None, 0
        start = now - window_s
        base = None
        for ts, g, t in self.points:
            if ts >= start:
                break
            base = (g, t)
        if base is None:
            base = (self.points[0][1], self.points[0][2])
        d_good = d_total = 0.0
        pg, pt = base
        for ts, g, t in self.points:
            if ts < start:
                continue
            if t >= pt and g >= pg:
                d_good += g - pg
                d_total += t - pt
            else:  # reset
                d_good += g
                d_total += t
            pg, pt = g, t
        if d_total <= 0:
            return None, 0
        return max(0.0, 1.0 - d_good / d_total), d_total


def firing(kind: str, key: str, severity: str, summary: str,
           **data: Any) -> Dict[str, Any]:
    """One detector hit.  ``key`` is the dedup identity: repeated firings
    with the same key feed ONE incident until it resolves."""
    return {"kind": kind, "key": key, "severity": severity,
            "summary": summary, "data": data}


# --------------------------------------------------------------- detectors


def detect_slo_burn(ratios: Dict[str, RatioWindow], now: float,
                    params: Optional[dict] = None) -> List[dict]:
    """Multi-window multi-burn-rate SLO alert per signal ('ttft', 'itl').
    Fires CRIT at the fast threshold, WARN at the slow threshold; both
    require the fast AND slow window burning (SRE workbook shape)."""
    p = _params(params)
    budget = max(1e-6, 1.0 - p["slo_goal"])
    out = []
    for signal, win in ratios.items():
        fast_bad, fast_n = win.bad_fraction(now, p["burn_fast_s"])
        slow_bad, slow_n = win.bad_fraction(now, p["burn_slow_s"])
        if fast_bad is None or slow_bad is None \
                or fast_n < p["burn_min_events"]:
            continue
        fast_burn = fast_bad / budget
        slow_burn = slow_bad / budget
        for sev, thresh in ((SEV_CRIT, p["burn_fast_x"]),
                            (SEV_WARN, p["burn_slow_x"])):
            if fast_burn >= thresh and slow_burn >= thresh:
                out.append(firing(
                    "slo_burn", f"slo_burn:{signal}", sev,
                    f"{signal} SLO burning {fast_burn:.1f}x budget "
                    f"({fast_bad:.0%} of {fast_n:.0f} requests over target "
                    f"in {p['burn_fast_s']:.0f}s window, goal "
                    f"{p['slo_goal']:.0%})",
                    signal=signal, fast_burn=round(fast_burn, 2),
                    slow_burn=round(slow_burn, 2),
                    bad_fraction=round(fast_bad, 4), events=fast_n))
                break  # report at the highest severity that matched
    return out


def detect_stall_pressure(steps: List[dict], now: float, window_s: float,
                          params: Optional[dict] = None) -> List[dict]:
    """Admission-stall pressure and step-wall jitter per engine, from
    flight-recorder step records (each carries t/engine/wall_s/stall_s)."""
    p = _params(params)
    out = []
    by_engine: Dict[str, List[dict]] = {}
    for rec in steps:
        ts = rec.get("t")
        if isinstance(ts, (int, float)) and ts >= now - window_s:
            by_engine.setdefault(str(rec.get("engine", "?")), []).append(rec)
    for eid, recs in by_engine.items():
        walls = sorted(float(r.get("wall_s", 0.0)) for r in recs)
        wall_sum = sum(walls)
        stall_sum = sum(float(r.get("stall_s", 0.0)) for r in recs)
        if len(recs) >= p["stall_min_steps"] and wall_sum > 0:
            frac = stall_sum / (wall_sum + stall_sum)
            if frac >= p["stall_frac_warn"]:
                out.append(firing(
                    "stall_pressure", f"stall:{eid}", SEV_WARN,
                    f"engine {eid} spent {frac:.0%} of the last "
                    f"{window_s:.0f}s admission-stalled "
                    f"({stall_sum:.1f}s over {len(recs)} steps)",
                    engine=eid, stall_frac=round(frac, 4),
                    stall_s=round(stall_sum, 3), steps=len(recs)))
        if len(walls) >= p["jitter_min_steps"]:
            p50 = walls[len(walls) // 2]
            p99 = walls[min(len(walls) - 1, int(len(walls) * 0.99))]
            if p50 > 0 and p99 / p50 >= p["jitter_ratio_warn"]:
                out.append(firing(
                    "step_jitter", f"jitter:{eid}", SEV_WARN,
                    f"engine {eid} step wall p99/p50 = "
                    f"{p99 * 1e3:.1f}ms/{p50 * 1e3:.1f}ms "
                    f"({p99 / p50:.0f}x) over {len(walls)} steps",
                    engine=eid, p50_s=round(p50, 6), p99_s=round(p99, 6),
                    ratio=round(p99 / p50, 1), steps=len(walls)))
    return out


def detect_partition(counters: Dict[str, SeriesWindow], now: float,
                     window_s: float,
                     params: Optional[dict] = None) -> List[dict]:
    """Partition / gray-failure suspicion from fault-counter deltas:
    peer quarantines are a hard signal (the dataplane only quarantines a
    peer after repeated failed probes); a burst of RPC deadline
    expiries corroborates when no quarantine has landed yet."""
    p = _params(params)
    deltas = {name: win.delta(now, window_s)
              for name, win in counters.items()}
    quar = deltas.get("quarantines", 0.0)
    dead = deltas.get("deadline_exceeded", 0.0)
    faults = deltas.get("netfaults", 0.0)
    retries = deltas.get("retries", 0.0)
    suspect = quar >= p["partition_min_quarantines"] \
        or dead >= p["partition_min_deadlines"]
    if not suspect:
        return []
    parts = []
    if quar:
        parts.append(f"{quar:.0f} peer quarantine(s)")
    if dead:
        parts.append(f"{dead:.0f} rpc deadline(s) exceeded")
    if faults:
        parts.append(f"{faults:.0f} injected netfault(s)")
    if retries:
        parts.append(f"{retries:.0f} rpc retr(ies)")
    return [firing(
        "partition_suspicion", "partition", SEV_CRIT,
        "network partition / gray failure suspected: "
        + ", ".join(parts) + f" in the last {window_s:.0f}s",
        deltas={k: round(v, 1) for k, v in deltas.items() if v})]


def detect_drop_pressure(counters: Dict[str, SeriesWindow], now: float,
                         window_s: float,
                         params: Optional[dict] = None) -> List[dict]:
    """Telemetry rings shedding records (spans / step records / log lines
    dropped): observability itself is degrading, which masks every other
    detector — worth its own incident."""
    p = _params(params)
    deltas = {name: win.delta(now, window_s)
              for name, win in counters.items()}
    dropped = sum(deltas.values())
    if dropped < p["drop_min"]:
        return []
    detail = ", ".join(f"{k}={v:.0f}" for k, v in deltas.items() if v)
    return [firing(
        "drop_pressure", "drops", SEV_WARN,
        f"telemetry rings dropped {dropped:.0f} record(s) in the last "
        f"{window_s:.0f}s ({detail})",
        deltas={k: round(v, 1) for k, v in deltas.items() if v})]


def detect_devmem_leak(pools: Dict[str, SeriesWindow], now: float,
                       window_s: float,
                       params: Optional[dict] = None) -> List[dict]:
    """Monotone pool growth across the whole window: a pool that only ever
    grows (every consecutive sample strictly larger) for leak_min_samples
    and gained leak_min_bytes looks like an accumulation bug, not churn."""
    p = _params(params)
    out = []
    for pool_key, win in pools.items():
        pts = [(ts, v) for ts, v in win.points if ts >= now - window_s]
        if len(pts) < p["leak_min_samples"]:
            continue
        vals = [v for _, v in pts]
        growth = vals[-1] - vals[0]
        if growth < p["leak_min_bytes"]:
            continue
        if all(b > a for a, b in zip(vals, vals[1:])):
            out.append(firing(
                "devmem_leak", f"devmem_leak:{pool_key}", SEV_WARN,
                f"device pool {pool_key} grew monotonically by "
                f"{growth / 2**20:.0f} MiB over {len(vals)} samples "
                f"({window_s:.0f}s) without ever shrinking",
                pool=pool_key, growth_bytes=int(growth),
                samples=len(vals), latest_bytes=int(vals[-1])))
    return out


def detect_head_pressure(loop_lag: SeriesWindow, now: float,
                         window_s: float,
                         params: Optional[dict] = None) -> List[dict]:
    """Head event-loop lag: the probe measures how late the periodic tick
    wakes up — sustained lag means every RPC handler is queueing behind
    something (the per-method handler histograms in the evidence say
    what)."""
    p = _params(params)
    worst = loop_lag.max_over(now, window_s)
    if worst is None or worst < p["loop_lag_warn_s"]:
        return []
    sev = SEV_CRIT if worst >= p["loop_lag_crit_s"] else SEV_WARN
    return [firing(
        "head_pressure", "head_loop_lag", sev,
        f"head event loop lagged up to {worst * 1e3:.0f}ms in the last "
        f"{window_s:.0f}s (handlers are queueing)",
        max_lag_s=round(worst, 4))]


def _profiles_by_gang(profiles: List[dict], now: float,
                      window_s: float) -> Dict[str, List[dict]]:
    by: Dict[str, List[dict]] = {}
    for pr in profiles or []:
        ts = pr.get("t")
        if isinstance(ts, (int, float)) and ts >= now - window_s:
            by.setdefault(str(pr.get("gang", "?")), []).append(pr)
    return by


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    if not s:
        return 0.0
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0


def detect_gang_straggler(profiles: List[dict], now: float, window_s: float,
                          params: Optional[dict] = None) -> List[dict]:
    """Persistent straggler per gang, from joined round skew profiles
    (util/gangrec.skew_profile rows, each carrying t/gang/round/straggler/
    skew_s/wall_s/phase): fires when the SAME rank arrives last in >=
    ``straggler_frac`` of the windowed rounds AND its median skew is >=
    ``straggler_skew_frac`` of the median round wall.  A round-robin of
    slow ranks (ordinary jitter) never fires — that is the point of the
    dominance test."""
    p = _params(params)
    out = []
    for gang, prs in _profiles_by_gang(profiles, now, window_s).items():
        if len(prs) < p["straggler_min_rounds"]:
            continue
        counts: Dict[Any, int] = {}
        for pr in prs:
            r = pr.get("straggler")
            if r is not None:
                counts[r] = counts.get(r, 0) + 1
        if not counts:
            continue
        rank, n = max(counts.items(), key=lambda kv: kv[1])
        if n / len(prs) < p["straggler_frac"]:
            continue
        mine = [pr for pr in prs if pr.get("straggler") == rank]
        med_skew = _median([float(pr.get("skew_s", 0.0)) for pr in mine])
        med_wall = _median([float(pr.get("wall_s", 0.0)) for pr in prs])
        if med_wall <= 0 or med_skew / med_wall < p["straggler_skew_frac"]:
            continue
        phases: Dict[str, int] = {}
        for pr in mine:
            ph = str(pr.get("phase") or "?")
            phases[ph] = phases.get(ph, 0) + 1
        phase = max(phases.items(), key=lambda kv: kv[1])[0]
        worst = sorted(mine, key=lambda pr: -float(pr.get("skew_s", 0.0)))[:3]
        sev = SEV_CRIT if med_skew / med_wall >= \
            p["straggler_skew_crit_frac"] else SEV_WARN
        out.append(firing(
            "gang_straggler", f"gang_straggler:{gang}", sev,
            f"gang {gang} rank {rank} straggled in {n}/{len(prs)} rounds "
            f"(median skew {med_skew * 1e3:.0f}ms = "
            f"{med_skew / med_wall:.0%} of median round wall; "
            f"slow phase: {phase})",
            gang=gang, rank=rank, phase=phase,
            skew_frac=round(med_skew / med_wall, 3),
            median_skew_s=round(med_skew, 6), rounds=len(prs),
            straggler_rounds=n,
            worst_rounds=[{
                "round": pr.get("round"), "skew_s": pr.get("skew_s"),
                "phase": pr.get("phase"), "wall_s": pr.get("wall_s"),
            } for pr in worst]))
    return out


def detect_gang_data_starvation(profiles: List[dict], now: float,
                                window_s: float,
                                params: Optional[dict] = None) -> List[dict]:
    """Data-starvation pressure per gang: the gang's mean data-wait
    fraction (profile ``data_frac``) stays above threshold — the input
    pipeline, not compute, is pacing the whole gang."""
    p = _params(params)
    out = []
    for gang, prs in _profiles_by_gang(profiles, now, window_s).items():
        fracs = [float(pr["data_frac"]) for pr in prs
                 if isinstance(pr.get("data_frac"), (int, float))]
        if len(fracs) < p["data_min_rounds"]:
            continue
        med = _median(fracs)
        if med < p["data_starved_frac"]:
            continue
        out.append(firing(
            "gang_data_starvation", f"gang_data_starvation:{gang}", SEV_WARN,
            f"gang {gang} spent a median {med:.0%} of each round waiting "
            f"on data over {len(fracs)} rounds — input pipeline is pacing "
            "the gang",
            gang=gang, data_frac=round(med, 3), rounds=len(fracs)))
    return out


def detect_gang_collective_desync(profiles: List[dict], now: float,
                                  window_s: float,
                                  params: Optional[dict] = None
                                  ) -> List[dict]:
    """Collective desync / timeout suspicion per gang: collective waits
    (profile ``coll_frac``) dominate the round — ranks spend the round
    parked inside allreduce/barrier waiting for a late or wedged peer.
    Corroborate with the straggler incident (same window) to name it."""
    p = _params(params)
    out = []
    for gang, prs in _profiles_by_gang(profiles, now, window_s).items():
        fracs = [float(pr["coll_frac"]) for pr in prs
                 if isinstance(pr.get("coll_frac"), (int, float))]
        if len(fracs) < p["coll_min_rounds"]:
            continue
        med = _median(fracs)
        if med < p["coll_desync_frac"]:
            continue
        out.append(firing(
            "gang_collective_desync", f"gang_collective_desync:{gang}",
            SEV_WARN,
            f"gang {gang} spent a median {med:.0%} of each round inside "
            f"collective waits over {len(fracs)} rounds — desync or "
            "timeout suspicion",
            gang=gang, coll_frac=round(med, 3), rounds=len(fracs)))
    return out


def detect_gang_mfu_regression(profiles: List[dict], now: float,
                               window_s: float,
                               params: Optional[dict] = None) -> List[dict]:
    """Trailing-window MFU regression per gang: the recent half of the
    window's mean MFU dropped >= ``mfu_drop_frac`` below the first
    half's.  Catches slow degradation (thermal throttling, a recovering
    rank on cold caches) that per-round skew never trips."""
    p = _params(params)
    out = []
    for gang, prs in _profiles_by_gang(profiles, now, window_s).items():
        seq = sorted(
            (pr for pr in prs if isinstance(pr.get("mfu"), (int, float))),
            key=lambda pr: pr.get("round") or 0)
        if len(seq) < p["mfu_min_rounds"]:
            continue
        half = len(seq) // 2
        base = sum(float(pr["mfu"]) for pr in seq[:half]) / half
        recent = sum(float(pr["mfu"]) for pr in seq[half:]) \
            / (len(seq) - half)
        if base <= 0:
            continue
        drop = 1.0 - recent / base
        if drop < p["mfu_drop_frac"]:
            continue
        out.append(firing(
            "gang_mfu_regression", f"gang_mfu_regression:{gang}", SEV_WARN,
            f"gang {gang} MFU regressed {drop:.0%} over the trailing "
            f"window ({base:.3f} -> {recent:.3f} across {len(seq)} rounds)",
            gang=gang, mfu_base=round(base, 4), mfu_recent=round(recent, 4),
            drop_frac=round(drop, 3), rounds=len(seq)))
    return out


# --------------------------------------------------------------- incidents


class IncidentManager:
    """Firings -> deduped Incident records with hysteresis.

    Lifecycle: a firing whose key has no open incident OPENS one (evidence
    is captured once, at open — the window that tripped the detector is
    the interesting one); further firings mark it ACTIVE and bump
    fired_count; ``resolve_after_s`` of silence RESOLVES it.  The ring
    keeps at most ``max_incidents`` records, evicting oldest-resolved
    first (open incidents are never evicted below the cap)."""

    def __init__(self, resolve_after_s: float = 20.0,
                 max_incidents: int = 256,
                 on_open: Optional[Callable[[dict], None]] = None,
                 on_resolve: Optional[Callable[[dict], None]] = None):
        self.resolve_after_s = float(resolve_after_s)
        self.max_incidents = max(8, int(max_incidents))
        self.on_open = on_open
        self.on_resolve = on_resolve
        self.incidents: "OrderedDict[str, dict]" = OrderedDict()
        self._open_by_key: Dict[str, str] = {}
        self._ids = itertools.count(1)

    def observe(self, firings: List[dict], now: Optional[float] = None,
                evidence: Optional[Callable[[dict, float], dict]] = None
                ) -> List[dict]:
        """Feed one detector pass; returns incidents opened this pass."""
        now = time.time() if now is None else now
        opened = []
        for f in firings:
            iid = self._open_by_key.get(f["key"])
            if iid is not None:
                inc = self.incidents[iid]
                inc["state"] = ACTIVE
                inc["last_fired"] = now
                inc["fired_count"] += 1
                inc["summary"] = f["summary"]
                # Severity only escalates while open (warn -> crit).
                if f["severity"] == SEV_CRIT:
                    inc["severity"] = SEV_CRIT
                inc["data"] = f["data"]
                continue
            iid = f"inc-{next(self._ids):04d}"
            inc = {
                "id": iid, "kind": f["kind"], "key": f["key"],
                "severity": f["severity"], "state": OPEN,
                "summary": f["summary"], "data": f["data"],
                "opened": now, "last_fired": now, "resolved": None,
                "fired_count": 1, "evidence": {},
            }
            if evidence is not None:
                try:
                    inc["evidence"] = evidence(f, now) or {}
                except Exception:
                    logger.exception("health: evidence capture failed")
            self.incidents[iid] = inc
            self._open_by_key[f["key"]] = iid
            opened.append(inc)
            if self.on_open is not None:
                try:
                    self.on_open(inc)
                except Exception:
                    logger.exception("health: on_open sink failed")
        self._resolve_quiet(now)
        self._trim()
        return opened

    def _resolve_quiet(self, now: float) -> None:
        for key, iid in list(self._open_by_key.items()):
            inc = self.incidents[iid]
            if now - inc["last_fired"] >= self.resolve_after_s:
                inc["state"] = RESOLVED
                inc["resolved"] = now
                del self._open_by_key[key]
                if self.on_resolve is not None:
                    try:
                        self.on_resolve(inc)
                    except Exception:
                        logger.exception("health: on_resolve sink failed")

    def _trim(self) -> None:
        while len(self.incidents) > self.max_incidents:
            victim = next((i for i, inc in self.incidents.items()
                           if inc["state"] == RESOLVED), None)
            if victim is None:  # all open (pathological): drop oldest
                victim = next(iter(self.incidents))
                self._open_by_key.pop(self.incidents[victim]["key"], None)
            del self.incidents[victim]

    def open_count(self) -> int:
        return len(self._open_by_key)

    def grade(self) -> str:
        """OK (nothing open) / WARN (open warns) / CRIT (open crits)."""
        worst = "OK"
        for iid in self._open_by_key.values():
            if self.incidents[iid]["severity"] == SEV_CRIT:
                return "CRIT"
            worst = "WARN"
        return worst

    def snapshot(self) -> List[dict]:
        """Newest-first copies, wire-safe (plain dicts/scalars only)."""
        return [dict(inc) for inc in reversed(self.incidents.values())]

    def get(self, id_prefix: str) -> List[dict]:
        return [dict(inc) for iid, inc in self.incidents.items()
                if iid.startswith(id_prefix)]


# ------------------------------------------------------------ head facade


#: metric name -> short window key for the partition detector.
_FAULT_COUNTERS = {
    "ray_tpu_peer_quarantines_total": "quarantines",
    "ray_tpu_rpc_deadline_exceeded_total": "deadline_exceeded",
    "ray_tpu_rpc_retries_total": "retries",
    "ray_tpu_netfaults_injected_total": "netfaults",
}

#: metric name -> short window key for the drop-pressure detector.
_DROP_COUNTERS = {
    "ray_tpu_spans_dropped_total": "spans",
    "ray_tpu_step_records_dropped_total": "step_records",
    "ray_tpu_gang_rounds_dropped_total": "gang_rounds",
    "ray_tpu_logs_dropped_total": "logs",
}

#: serve SLO signals: latency histogram -> ratio-window key.
_SLO_HISTOGRAMS = {
    "ray_tpu_serve_engine_ttft_seconds": "ttft",
    "ray_tpu_serve_engine_itl_seconds": "itl",
}


def _sum_rows(rows: List[dict], name: str) -> Optional[float]:
    """Sum a counter/gauge across every tag combination and source."""
    total, seen = 0.0, False
    for row in rows:
        if row.get("name") == name \
                and isinstance(row.get("value"), (int, float)):
            total += row["value"]
            seen = True
    return total if seen else None


def _histogram_good_total(rows: List[dict], name: str, target_s: float):
    """Cumulative (observations <= target, all observations) for one
    latency histogram, summed across tags; the bucket whose upper bound
    covers target_s defines 'good' (conservative: first bound >= target)."""
    good = total = 0.0
    seen = False
    for row in rows:
        if row.get("name") != name or "buckets" not in row:
            continue
        bounds = row.get("boundaries") or ()
        buckets = row.get("buckets") or ()
        count = float(row.get("count", 0))
        idx = next((i for i, b in enumerate(bounds) if b >= target_s), None)
        cum = 0.0
        for i, n in enumerate(buckets):
            cum += n
            if idx is not None and i == idx:
                break
        good += cum if idx is not None else count
        total += count
        seen = True
    return (good, total) if seen else None


class HealthEngine:
    """Owns the sample windows + IncidentManager; ``tick()`` runs on the
    head loop at the telemetry cadence.  All inputs arrive as plain data
    gathered by the head — this class never reaches into head state."""

    def __init__(self, window_s: float = 30.0, resolve_after_s: float = 20.0,
                 max_incidents: int = 256, params: Optional[dict] = None,
                 on_open: Optional[Callable[[dict], None]] = None,
                 on_resolve: Optional[Callable[[dict], None]] = None):
        self.window_s = float(window_s)
        self.params = _params(params)
        self.manager = IncidentManager(
            resolve_after_s=resolve_after_s, max_incidents=max_incidents,
            on_open=on_open, on_resolve=on_resolve)
        self._faults: Dict[str, SeriesWindow] = {
            k: SeriesWindow() for k in _FAULT_COUNTERS.values()}
        self._drops: Dict[str, SeriesWindow] = {
            k: SeriesWindow() for k in _DROP_COUNTERS.values()}
        self._ratios: Dict[str, RatioWindow] = {}
        self._pools: Dict[str, SeriesWindow] = {}
        self._loop_lag = SeriesWindow()
        self.last_tick = 0.0
        self.ticks = 0

    def tick(self, now: float, rows: List[dict], steps: List[dict],
             devmem: Dict[str, dict], loop_lag_s: float,
             slo_targets: Optional[Dict[str, float]] = None,
             evidence: Optional[Callable[[dict, float], dict]] = None,
             gang_profiles: Optional[List[dict]] = None
             ) -> List[dict]:
        """One detector pass; returns incidents opened this pass."""
        self.last_tick = now
        self.ticks += 1
        for name, key in _FAULT_COUNTERS.items():
            v = _sum_rows(rows, name)
            if v is not None:
                self._faults[key].add(now, v)
        for name, key in _DROP_COUNTERS.items():
            v = _sum_rows(rows, name)
            if v is not None:
                self._drops[key].add(now, v)
        targets = slo_targets or {}
        for name, signal in _SLO_HISTOGRAMS.items():
            target = targets.get(signal)
            if not target or target <= 0:
                continue
            gt = _histogram_good_total(rows, name, target)
            if gt is not None:
                self._ratios.setdefault(signal, RatioWindow()).add(
                    now, gt[0], gt[1])
        for pool_key, size in self._pool_sizes(devmem).items():
            self._pools.setdefault(pool_key, SeriesWindow()).add(now, size)
        self._loop_lag.add(now, float(loop_lag_s))

        w, p = self.window_s, self.params
        firings: List[dict] = []
        firings += detect_slo_burn(self._ratios, now, p)
        firings += detect_stall_pressure(steps, now, w, p)
        firings += detect_partition(self._faults, now, w, p)
        firings += detect_drop_pressure(self._drops, now, w, p)
        firings += detect_devmem_leak(self._pools, now, max(w * 4, 60.0), p)
        firings += detect_head_pressure(self._loop_lag, now, w, p)
        if gang_profiles:
            firings += detect_gang_straggler(gang_profiles, now, w, p)
            firings += detect_gang_data_starvation(gang_profiles, now, w, p)
            firings += detect_gang_collective_desync(
                gang_profiles, now, w, p)
            firings += detect_gang_mfu_regression(gang_profiles, now, w, p)
        return self.manager.observe(firings, now, evidence)

    @staticmethod
    def _pool_sizes(devmem: Dict[str, dict]) -> Dict[str, float]:
        """Flatten devmem reports ({pid: {devmem: {pools: {name: info}}}})
        into {'pid:pool': bytes}."""
        out: Dict[str, float] = {}
        for pid, report in (devmem or {}).items():
            pools = ((report or {}).get("devmem") or {}).get("pools") or {}
            for pool, info in pools.items():
                size = info.get("bytes") if isinstance(info, dict) else info
                if isinstance(size, (int, float)):
                    out[f"{pid}:{pool}"] = float(size)
        return out
