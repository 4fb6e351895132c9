"""Tracing spans: a (trace_id, span_id) context carried through
contextvars, and a bounded ring of finished spans (port of
``ray_tpu/util/tracing.py``).

Finished spans buffer in a bounded per-process ring (``span_ring_size``);
overflow drops the span, counts it in ``ray_tpu_spans_dropped_total`` and
logs one warning per process: drops are visible, never silent.  Root spans
roll ``trace_sample_rate``; ``trace(..., force=True)`` always traces.
Inside an unsampled root, nested spans and submissions stay span-free.
Every span is stamped on :func:`now`, the wall clock that the device
trace (``torch.profiler``'s CUDA activity) stamps its events on too, so a
span and the kernels inside it can be laid on one timeline.
``drain_buffered()`` hands the ring back (what tests and the chip check
read), ``trace_analysis`` turns a trace's spans into a tree, a critical path
and a stage breakdown, and ``chrome_trace`` renders span events for
chrome://tracing.

``flush_spans()`` ships the ring as one ``span_batch`` through the runtime
client's ``call_batched`` (``ctx.client``, flushed on the client's report
cadence); the head keeps the spans for ``list_state(kind="traces")``.  With
no client (no runtime, or headless) the spans stay in the ring.  A task
submitted inside a traced region carries the context in its spec, and the
worker records the task's execution span (``task_span``).  The ring size and
the sample rate come from the runtime's config through ``_cfg()``, which
tests may replace; a client's head-configured rate wins.  Span ids come from
the runtime's fork-keyed PRNG (``core/ids._rand_bytes``).  This module
imports nothing of JAX and nothing of ``ray_tpu``.

Usage::

    with tracing.trace("request", force=True):
        stream = engine.submit(prompt)   # the engine's spans parent here
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..core.ids import _rand_bytes


def _cfg():
    from ..core.config import get_config

    return get_config()


_current: contextvars.ContextVar[Optional[Dict[str, Any]]] = (
    contextvars.ContextVar("rt_trace_ctx", default=None)
)

logger = logging.getLogger("ray_tpu_torch.tracing")


def now() -> float:
    """Wall seconds (``time.time()``): the clock of every span stamp.
    Kineto stamps the device trace's events on the same clock, so a span's
    stamps bound the kernels launched inside it; the card test in
    ``benchmarks/tests/test_step_metrics.py`` checks that the two agree
    around a launch."""
    return time.time()


def new_id() -> str:
    """A fresh 64-bit hex span/trace id."""
    return _rand_bytes(8).hex()


# ------------------------------------------------------------- sampling


def _sample_rate() -> float:
    """Head-configured root sampling rate: the register reply carries the
    head's ``trace_sample_rate`` (one knob governs the cluster); processes
    without a client fall back to their local config."""
    from ..core.context import ctx as rt_ctx

    client = rt_ctx.client
    rate = getattr(client, "trace_sample_rate", None) \
        if client is not None else None
    if rate is None:
        try:
            rate = _cfg().trace_sample_rate
        except Exception:
            rate = 1.0
    return float(rate)


def should_sample(force: bool = False) -> bool:
    """Root-trace sampling decision.  ``force=True`` always traces;
    otherwise roll against ``trace_sample_rate``."""
    if force:
        return True
    rate = _sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int.from_bytes(_rand_bytes(4), "little") < rate * 2.0**32


# ------------------------------------------------------------- span ring

_ring: deque = deque()
_ring_lock = threading.Lock()
_dropped_total = 0
_warned_drop = False
_m_emitted = None
_m_dropped = None


def _ring_cap() -> int:
    try:
        return max(16, int(_cfg().span_ring_size))
    except Exception:
        return 4096


def _count_metric(which: str, n: int) -> None:
    """Lazily resolved counters (the metrics registry lock must not sit on
    the emit path)."""
    global _m_emitted, _m_dropped
    try:
        from .metrics import get_counter

        if which == "emitted":
            if _m_emitted is None:
                _m_emitted = get_counter(
                    "ray_tpu_spans_emitted_total",
                    "Tracing spans shipped to the head (batched flush)")
            _m_emitted.inc(n)
        else:
            if _m_dropped is None:
                _m_dropped = get_counter(
                    "ray_tpu_spans_dropped_total",
                    "Tracing spans dropped (ring overflow or flush "
                    "failure) — counted, never silent")
            _m_dropped.inc(n)
    except Exception:
        pass  # metrics must never fail the span plane


def _note_dropped(n: int, why: str) -> None:
    global _dropped_total, _warned_drop
    _dropped_total += n
    _count_metric("dropped", n)
    if not _warned_drop:
        _warned_drop = True
        logger.warning(
            "dropping tracing spans (%s; %d so far, counted in "
            "ray_tpu_spans_dropped_total) — raise span_ring_size or lower "
            "trace_sample_rate if this persists", why, _dropped_total)


def emit_span(span: Dict[str, Any]) -> None:
    """Record a finished span into the bounded ring.  The span dict needs at
    least trace_id/span_id/name; start/end are :func:`now` walls in
    seconds.  Ring overflow drops the span (counted), never blocks."""
    with _ring_lock:
        if len(_ring) < _ring_cap():
            _ring.append(span)
            return
    _note_dropped(1, "span ring full")


def flush_spans(client=None) -> int:
    """Drain the ring into ONE ``span_batch`` call through the client's
    ``call_batched``; returns the spans flushed.  With no client, or a
    client whose connection is closed, this is a no-op returning 0: the
    spans stay in the bounded ring."""
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
        client.call_batched("span_batch", {"spans": batch})
    except Exception:
        _note_dropped(len(batch), "span_batch flush failed")
        return 0
    _count_metric("emitted", len(batch))
    return len(batch)


def drain_buffered() -> List[Dict[str, Any]]:
    """Remove and return every buffered (not yet flushed) span."""
    with _ring_lock:
        out = list(_ring)
        _ring.clear()
    return out


# ------------------------------------------------------------- context


def current_context() -> Optional[Dict[str, Any]]:
    """The active {trace_id, span_id}, or None outside any trace.  Inside
    an unsampled root this returns the unsampled sentinel."""
    return _current.get()


def context_for_submit() -> Optional[Dict[str, str]]:
    """Trace context to carry with an outgoing submission: None outside any
    trace AND inside an unsampled root (unsampled traces propagate
    nothing)."""
    ctx = _current.get()
    if ctx is None or not ctx.get("sampled", True):
        return None
    return ctx


def _safe_reset(token, installed=None) -> None:
    """Reset the context var, tolerating a generator finalized on another
    thread than the one that opened the span: the token then belongs to
    another thread's context.  In that case clear ONLY if the finalizing
    thread's active context is this very span."""
    try:
        _current.reset(token)
    except ValueError:
        if installed is not None and _current.get() is installed:
            _current.set(None)


def set_context(ctx: Optional[Dict[str, str]]):
    """Install a received context; returns a token for reset."""
    return _current.set(ctx)


def reset_context(token) -> None:
    _current.reset(token)


@contextlib.contextmanager
def trace(name: str, force: bool = False, **attrs):
    """A named span.  Nested spans and submissions inside it become its
    children.  Root spans roll ``trace_sample_rate``; ``force=True`` always
    traces this root.  Extra keyword arguments become span attrs; values
    written into the yielded ctx's ``"attrs"`` key merge over them."""
    parent = _current.get()
    if parent is not None and not parent.get("sampled", True):
        # Inside an unsampled root: stay span-free, keep the sentinel.
        yield parent
        return
    if parent is None and not should_sample(force):
        # Fresh dict per root (not the shared sentinel): callers may write
        # into the yielded ctx's "attrs" and must not poison other traces.
        unsampled = {"sampled": False}
        token = _current.set(unsampled)
        try:
            yield unsampled
        finally:
            _safe_reset(token, unsampled)
        return
    span_ctx = {
        "trace_id": parent["trace_id"] if parent else new_id(),
        "span_id": new_id(),
    }
    token = _current.set(span_ctx)
    start = now()
    try:
        yield span_ctx
    finally:
        _safe_reset(token, span_ctx)
        late = span_ctx.get("attrs")
        if late:
            attrs = {**attrs, **late}
        emit_span({
            "trace_id": span_ctx["trace_id"],
            "span_id": span_ctx["span_id"],
            "parent_id": parent["span_id"] if parent else None,
            "name": name,
            "start": start,
            "end": now(),
            "pid": os.getpid(),
            **({"attrs": attrs} if attrs else {}),
        })


def make_span(parent_ctx: Dict[str, str], name: str, start: float,
              end: float, **attrs) -> Dict[str, Any]:
    """Build a finished-span dict against an explicit parent context, for
    emitters that cannot use the ``trace()`` context manager (the engine's
    loop thread stamping another thread's request).  Pair with
    :func:`emit_span`."""
    return {
        "trace_id": parent_ctx["trace_id"],
        "span_id": new_id(),
        "parent_id": parent_ctx.get("span_id"),
        "name": name,
        "start": start,
        "end": end,
        "pid": os.getpid(),
        **({"attrs": attrs} if attrs else {}),
    }


def trace_if_active(name: str, **attrs):
    """``trace()`` only when a SAMPLED context is already active: untraced
    or unsampled callers pay nothing and root nothing.  Yields a dict
    either way; writes to its ``"attrs"`` key merge into the emitted span
    (no-op when inactive)."""
    if context_for_submit() is None:
        return contextlib.nullcontext({})
    return trace(name, **attrs)


def task_span(spec: Dict[str, Any], start: float, end: float,
              **attrs) -> Optional[dict]:
    """Build the execution span for a finished task from its spec's injected
    context (None when the submission wasn't traced and tracing isn't
    forced)."""
    injected = spec.get("trace_ctx")
    if injected is None:
        return None
    return {
        "trace_id": injected["trace_id"],
        "span_id": injected.get("task_span_id") or new_id(),
        "parent_id": injected.get("span_id"),
        "name": f"task:{spec.get('name', 'anonymous')}",
        "start": start,
        "end": end,
        "pid": os.getpid(),
        **({"attrs": attrs} if attrs else {}),
    }


def chrome_trace(events) -> list:
    """Convert span events (``kind == "span"``) into Chrome trace-event
    JSON: 'X' complete events keyed by pid.  A submission span whose
    ``attrs.flow_id`` names an execution span also gets a flow arrow ('s'
    at the submit span's end, 'f' at the execution span's start)."""
    out = []
    spans = []
    for ev in events:
        if ev.get("kind") != "span":
            continue
        if not isinstance(ev.get("start"), (int, float)) \
                or not isinstance(ev.get("end"), (int, float)):
            continue  # malformed emitter: skip, don't kill the export
        spans.append(ev)
        out.append({
            "name": ev.get("name", "span"),
            "cat": ev.get("trace_id", ""),
            "ph": "X",
            "ts": ev["start"] * 1e6,
            "dur": max(ev["end"] - ev["start"], 0) * 1e6,
            "pid": ev.get("pid", 0),
            "tid": ev.get("pid", 0),
            "args": {
                "trace_id": ev.get("trace_id"),
                "span_id": ev.get("span_id"),
                "parent_id": ev.get("parent_id"),
                **(ev.get("attrs") or {}),
            },
        })
    # Flow arrows: submit span (attrs.flow_id) -> execution span (span_id).
    flow_starts = {}
    for ev in spans:
        flow = (ev.get("attrs") or {}).get("flow_id")
        if flow:
            flow_starts[flow] = ev
    if flow_starts:
        for ev in spans:
            sub = flow_starts.get(ev.get("span_id"))
            if sub is None or ev is sub:
                continue
            common = {"cat": "scheduling", "id": ev["span_id"],
                      "name": "submit_to_start"}
            out.append({**common, "ph": "s", "ts": sub["end"] * 1e6,
                        "pid": sub.get("pid", 0), "tid": sub.get("pid", 0)})
            out.append({**common, "ph": "f", "bp": "e",
                        "ts": ev["start"] * 1e6,
                        "pid": ev.get("pid", 0), "tid": ev.get("pid", 0)})
    return out
