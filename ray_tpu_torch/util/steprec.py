"""Engine step flight recorder: a bounded per-process record ring (port of
``ray_tpu/util/steprec.py``).

The inference engine's decode loop appends ONE fixed-size record per step
(step wall, batch occupancy, admission / eviction / shed counts, KV page
usage, prefix-cache hits, adapter pins, admission-stall span) and this
module keeps it without ever blocking the loop:

1. **Ring** — records buffer in a bounded ring (``step_ring_size``) for a
   batched flush.  Overflow drops the record, counted in
   ``ray_tpu_step_records_dropped_total`` and warned about once per
   process: never silent.
2. **Black box** — the last ``step_dump_records`` records are mirrored and
   rewritten atomically into a ``*.steps.log`` sidecar next to the
   process's log file (``RT_LOG_PATH``) on every flush, throttled by
   ``step_dump_interval_s``: a killed process runs no exit hook, so the
   sidecar is written ahead of death.  Writing never raises.
3. **Tests and harnesses** — ``drain_buffered()`` hands back the unflushed
   records.

The port has no runtime yet, so there is no head and no client:
``flush_steps()`` refreshes the black box and then behaves as the JAX one
does when ``ctx.client is None`` (it returns 0 and the records stay in the
ring); given a client it ships the ring as one ``engine_step_batch``
through its ``call_batched``.  The defaults of ``ray_tpu/core/config.py``
(``step_ring_size`` 2048, ``step_dump_records`` 256,
``step_dump_interval_s`` 1.0) stay here behind ``_cfg()``, which tests may
replace.  This module imports nothing of JAX and nothing of ``ray_tpu``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import types
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger("ray_tpu_torch.steprec")

_DEFAULTS = types.SimpleNamespace(step_ring_size=2048, step_dump_records=256,
                                  step_dump_interval_s=1.0)

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
    return _DEFAULTS


def _ring_cap() -> int:
    try:
        return max(16, int(_cfg().step_ring_size))
    except Exception:
        return 2048


def _dump_cap() -> int:
    try:
        return max(0, int(_cfg().step_dump_records))
    except Exception:
        return 256


def _count_metric(which: str, n: int) -> None:
    """Lazily resolved counters (the metrics registry lock must not sit on
    the decode loop's record path)."""
    global _m_flushed, _m_dropped
    try:
        from .metrics import get_counter

        if which == "flushed":
            if _m_flushed is None:
                _m_flushed = get_counter(
                    "ray_tpu_step_records_flushed_total",
                    "Engine step records shipped to the head "
                    "(batched flush)")
            _m_flushed.inc(n)
        else:
            if _m_dropped is None:
                _m_dropped = get_counter(
                    "ray_tpu_step_records_dropped_total",
                    "Engine step records dropped (ring overflow or flush "
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
            "dropping engine step records (%s; %d so far, counted in "
            "ray_tpu_step_records_dropped_total) — raise step_ring_size "
            "if this persists", why, _dropped_total)


def record_step(rec: Dict[str, Any]) -> None:
    """Append one step record: buffered into the bounded ring for the next
    flush, and mirrored into the last-N black box.  Overflow drops the
    record (counted), never blocks the caller: this sits on the decode
    loop's hot path."""
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
    _note_dropped(1, "step ring full")


def flush_steps(client=None) -> int:
    """Refresh the black-box sidecar, then drain the ring into ONE
    ``engine_step_batch`` call through the client's ``call_batched``;
    returns the records flushed.  With no client, or a closed one, the
    records stay in the bounded ring and this returns 0."""
    dump_black_box()
    if client is None or getattr(client, "rpc", None) is None \
            or getattr(client.rpc, "closed", False):
        return 0
    with _ring_lock:
        if not _ring:
            return 0
        batch = list(_ring)
        _ring.clear()
    try:
        client.call_batched("engine_step_batch", {"steps": batch})
    except Exception:
        _note_dropped(len(batch), "engine_step_batch flush failed")
        return 0
    _count_metric("flushed", len(batch))
    return len(batch)


def drain_buffered() -> List[Dict[str, Any]]:
    """Remove and return every buffered (not yet flushed) record."""
    with _ring_lock:
        out = list(_ring)
        _ring.clear()
    return out


def dropped_total() -> int:
    return _dropped_total


# ------------------------------------------------------------- black box


def black_box_path() -> Optional[str]:
    """Sidecar path next to this process's log file (``RT_LOG_PATH``), or
    None when the process has none.  Named ``<log>.steps.log`` so a glob
    over ``*.log`` finds it beside the log."""
    log_path = os.environ.get("RT_LOG_PATH")
    if not log_path:
        return None
    stem = log_path[:-4] if log_path.endswith(".log") else log_path
    return stem + ".steps.log"


def dump_black_box(path: Optional[str] = None, force: bool = False) -> bool:
    """Rewrite the sidecar with the last-N records as compact JSON lines.
    Throttled by ``step_dump_interval_s`` unless ``force``.  Returns True
    when a file was written.  Never raises: a full disk must not take down
    the decode loop."""
    global _last_dump_t
    if path is None:
        path = black_box_path()
    if path is None or not _dump_cap():
        return False
    now = time.monotonic()
    with _dump_lock:
        if not force and now - _last_dump_t < \
                max(0.0, float(getattr(_cfg(), "step_dump_interval_s", 1.0))):
            return False
        with _ring_lock:
            records = list(_recent)
        if not records:
            return False
        _last_dump_t = now
        try:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(f"# ray_tpu step flight recorder black box "
                        f"(pid={os.getpid()}, last {len(records)} steps)\n")
                for rec in records:
                    f.write(json.dumps(rec, separators=(",", ":"),
                                       default=str) + "\n")
            os.replace(tmp, path)  # atomic: a crash mid-dump keeps the old box
            return True
        except OSError:
            return False
