"""Gang training flight recorder: a bounded per-rank round-record ring.

The training-plane twin of util/steprec.py (TorchTitan's per-rank step
recording posture, PAPERS.md): every ``train.report()`` appends ONE
fixed-size record per training round — step wall, data wait, collective
wait, lockstep-ack wait, checkpoint wall, compile time, tokens, MFU —
and this module gets it to three places without ever blocking the
training loop:

1. **Head join** — records drain as one batched ``gang_round_batch``
   RPC via the client's ``call_batched`` machinery on the background
   report cadence (exactly the span/steprec shape): they coalesce with
   task_done/span_batch traffic, hold bounded while headless, and
   replay at reconnect.  The head joins them by (gang, round) into skew
   profiles — which rank arrived last and which phase made it late.
   Ring overflow drops records — counted in
   ``ray_tpu_gang_rounds_dropped_total``, never silent.
2. **Black box** — the last ``gang_dump_records`` records are mirrored
   into a ``*.rounds.log`` sidecar next to the rank's own log file on
   every flush (throttled by ``gang_dump_interval_s``), so a SIGKILLed
   rank leaves its final rounds on disk for
   ``ray_tpu_torch logs --post-mortem``.
3. **Tests/bench** — ``drain_buffered()`` hands back unflushed records
   for client-less harnesses (the train smoke bench's recorder-overhead
   gate drains this way).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger("ray_tpu_torch.gangrec")

_ring: deque = deque()
_recent: deque = deque()  # last-N mirror for the black box (never drained)
_ring_lock = threading.Lock()
_dropped_total = 0
_warned_drop = False
_m_flushed = None
_m_dropped = None
_last_dump_t = 0.0
_dump_lock = threading.Lock()


def _cfg():
    from ..core.config import get_config

    return get_config()


def _ring_cap() -> int:
    try:
        return max(16, int(_cfg().gang_ring_size))
    except Exception:
        return 2048


def _dump_cap() -> int:
    try:
        return max(0, int(_cfg().gang_dump_records))
    except Exception:
        return 256


def _count_metric(which: str, n: int) -> None:
    """Lazily-resolved counters (the metrics registry lock must not sit
    on the training loop's record path)."""
    global _m_flushed, _m_dropped
    try:
        from .metrics import get_counter

        if which == "flushed":
            if _m_flushed is None:
                _m_flushed = get_counter(
                    "ray_tpu_gang_rounds_flushed_total",
                    "Gang round records shipped to the head "
                    "(batched flush)")
            _m_flushed.inc(n)
        else:
            if _m_dropped is None:
                _m_dropped = get_counter(
                    "ray_tpu_gang_rounds_dropped_total",
                    "Gang round records dropped (ring overflow or flush "
                    "failure) — counted, never silent")
            _m_dropped.inc(n)
    except Exception:
        pass  # metrics must never fail the recorder


def _note_dropped(n: int, why: str) -> None:
    global _dropped_total, _warned_drop
    _dropped_total += n
    _count_metric("dropped", n)
    if not _warned_drop:
        _warned_drop = True
        logger.warning(
            "dropping gang round records (%s; %d so far, counted in "
            "ray_tpu_gang_rounds_dropped_total) — raise gang_ring_size "
            "if this persists", why, _dropped_total)


def record_round(rec: Dict[str, Any]) -> None:
    """Append one round record: buffered into the bounded process-local
    ring for the next batched flush, and mirrored into the last-N black
    box.  Overflow drops the record (counted), never blocks the caller —
    this sits on the training loop's report() path."""
    dump_cap = _dump_cap()
    with _ring_lock:
        if dump_cap:
            if _recent.maxlen != dump_cap:
                # Config changed (or first record): rebuild the mirror.
                tail = list(_recent)[-dump_cap:]
                _recent.clear()
                _recent.__init__(tail, maxlen=dump_cap)
            _recent.append(rec)
        if len(_ring) < _ring_cap():
            _ring.append(rec)
            return
    _note_dropped(1, "gang round ring full")


def flush_rounds(client=None, sync: bool = False) -> int:
    """Drain the ring into ONE ``gang_round_batch`` head RPC via the
    client's ``call_batched`` (coalescing with task_done / span_batch),
    and refresh the black-box sidecar.  While headless this is a NO-OP
    for the RPC half — records stay in the BOUNDED ring and the first
    post-reconnect flush replays them — but the sidecar still refreshes.
    ``sync=True`` sends a blocking RPC instead (the run-end flush: the
    driver tears the gang down the moment the loops return, so the tail
    records must be IN the head, not in a fire-and-forget buffer, when
    this returns).  Returns the number of records flushed to the head."""
    dump_black_box()
    if client is None:
        from ..core.context import ctx as rt_ctx

        client = rt_ctx.client
    if client is None or getattr(client, "rpc", None) is None \
            or getattr(client.rpc, "closed", False):
        return 0
    with _ring_lock:
        if not _ring:
            return 0
        batch = list(_ring)
        _ring.clear()
    try:
        if sync:
            client.call("gang_round_batch", {"rounds": batch})
        else:
            client.call_batched("gang_round_batch", {"rounds": batch})
    except Exception:
        _note_dropped(len(batch), "gang_round_batch flush failed")
        return 0
    _count_metric("flushed", len(batch))
    return len(batch)


def drain_buffered() -> List[Dict[str, Any]]:
    """Remove and return every buffered (not-yet-flushed) record — for
    tests and client-less harnesses (the train smoke bench asserts
    round-record completeness this way)."""
    with _ring_lock:
        out = list(_ring)
        _ring.clear()
    return out


def dropped_total() -> int:
    return _dropped_total


# ------------------------------------------------------- head-side join

#: Phase keys a skew profile attributes lateness to.
PHASES = ("data", "compute", "checkpoint", "compile")


def _f(rec: Dict[str, Any], key: str) -> float:
    v = rec.get(key)
    return float(v) if isinstance(v, (int, float)) else 0.0


def _median(vals) -> float:
    s = sorted(vals)
    if not s:
        return 0.0
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0


def skew_profile(rank_recs: Dict[int, Dict[str, Any]]
                 ) -> Optional[Dict[str, Any]]:
    """Join one (gang, round)'s per-rank records into a skew profile.

    A rank's *own time* is ``wall + checkpoint − collective wait`` — the
    part of the round it spent working rather than waiting on the gang
    (a straggler's lateness shows up as everyone ELSE's collective/ack
    wait, never its own).  The rank with the largest own time therefore
    arrived last at the round's sync points: it is the straggler, and the
    round's skew is its lead over the median own time.  The guilty phase
    is the straggler's largest positive deviation from the cross-rank
    median among data / compute / checkpoint / compile.

    Pure function over plain dicts (unit-testable without a head); the
    head calls it the moment a round has a record from every rank."""
    recs = {int(r): rec for r, rec in rank_recs.items()
            if isinstance(rec, dict)}
    if not recs:
        return None
    own: Dict[int, float] = {}
    phases: Dict[int, Dict[str, float]] = {}
    for r, rec in recs.items():
        wall = _f(rec, "wall_s")
        data = _f(rec, "data_s")
        coll = _f(rec, "coll_s")
        ckpt = _f(rec, "ckpt_s")
        comp = _f(rec, "compile_s")
        own[r] = wall + ckpt - coll
        phases[r] = {
            "data": data,
            "compute": max(0.0, wall - data - coll - comp),
            "checkpoint": ckpt,
            "compile": comp,
        }
    straggler = max(sorted(own), key=lambda r: own[r])
    # Skew is measured against the OTHER ranks' median own time — with the
    # straggler included, an even-sized gang would fold its own outlier
    # into the baseline (world=2 would always read zero skew).
    others = [own[r] for r in own if r != straggler]
    skew = max(0.0, own[straggler] - _median(others)) if others else 0.0
    dev = {ph: phases[straggler][ph]
           - _median(phases[r][ph] for r in phases) for ph in PHASES}
    phase = max(PHASES, key=lambda ph: dev[ph])
    med_wall = _median(_f(rec, "wall_s") for rec in recs.values())
    n = len(recs)
    mfus = [rec["mfu"] for rec in recs.values()
            if isinstance(rec.get("mfu"), (int, float))]
    tokens = [rec["tokens"] for rec in recs.values()
              if isinstance(rec.get("tokens"), (int, float))]
    any_rec = next(iter(recs.values()))
    return {
        "gang": str(any_rec.get("gang", "?")),
        "round": any_rec.get("round"),
        "world": n,
        "t": max(_f(rec, "t") for rec in recs.values()),
        "wall_s": round(med_wall, 6),
        "skew_s": round(skew, 6),
        "skew_frac": round(skew / med_wall, 4) if med_wall > 0 else 0.0,
        "straggler": straggler,
        "phase": phase,
        "phase_lag_s": round(max(0.0, dev[phase]), 6),
        "data_frac": round(
            sum(phases[r]["data"] for r in phases) / n / med_wall, 4)
        if med_wall > 0 else 0.0,
        "coll_frac": round(
            sum(_f(rec, "coll_s") for rec in recs.values()) / n / med_wall,
            4) if med_wall > 0 else 0.0,
        "ack_s": round(
            sum(_f(rec, "ack_s") for rec in recs.values()) / n, 6),
        "ckpt_s": round(
            sum(_f(rec, "ckpt_s") for rec in recs.values()) / n, 6),
        "mfu": round(sum(mfus) / len(mfus), 4) if mfus else None,
        "tokens": int(sum(tokens)) if tokens else None,
    }


# ------------------------------------------------------------- black box


def black_box_path() -> Optional[str]:
    """Sidecar path next to this process's managed log file (None when
    the process has no spawner-assigned log, e.g. a driver).  Named
    ``<log>.rounds.log`` so the post-mortem glob over ``LOG_ROOT/*/*.log``
    picks it up alongside the log tails."""
    log_path = os.environ.get("RT_LOG_PATH")
    if not log_path:
        return None
    stem = log_path[:-4] if log_path.endswith(".log") else log_path
    return stem + ".rounds.log"


def dump_black_box(path: Optional[str] = None, force: bool = False) -> bool:
    """Rewrite the sidecar with the last-N records as compact JSON lines.
    Throttled by ``gang_dump_interval_s`` unless ``force``.  Returns True
    when a file was written.  Never raises — a full disk must not take
    down the training loop."""
    global _last_dump_t
    if path is None:
        path = black_box_path()
    if path is None or not _dump_cap():
        return False
    now = time.monotonic()
    with _dump_lock:
        if not force and now - _last_dump_t < \
                max(0.0, float(getattr(_cfg(), "gang_dump_interval_s", 1.0))):
            return False
        with _ring_lock:
            records = list(_recent)
        if not records:
            return False
        _last_dump_t = now
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(f"# ray_tpu_torch gang round flight recorder black box "
                        f"(pid={os.getpid()}, last {len(records)} rounds)\n")
                for rec in records:
                    f.write(json.dumps(rec, separators=(",", ":"),
                                       default=str) + "\n")
            os.replace(tmp, path)  # atomic: a crash mid-dump keeps the old box
            return True
        except OSError:
            return False
