"""Per-request trace analysis: span-tree reconstruction, critical path,
stage breakdown, and an ASCII waterfall (a copy of
``ray_tpu/util/trace_analysis.py``, which is pure Python; the port keeps
its own so that it imports nothing of ``ray_tpu``).

The span plane (``util/tracing.py``) buffers finished spans;
``tracing.drain_buffered()`` hands them back.  This module turns a trace's
flat span list into the answers an operator asks:

- **tree**: parent/child reconstruction from (span_id, parent_id);
- **critical path**: the chain of spans that bounds the trace's wall
  time, with per-span self time (shrinking anything off this path cannot
  speed the request up);
- **stage breakdown**: wall time attributed to pipeline stages by span
  naming convention (ingress/handle/submit/schedule/queue/prefill/decode/
  execute/…), where *schedule* is the flow-arrow gap between a submit
  span and its execution span;
- **waterfall**: a terminal-width Gantt rendering of the tree.

Everything here is pure functions over span dicts, so tests, the chip
check and a CLI share one implementation.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

#: Span-name prefix -> stage label, first match wins (longest prefixes
#: first so ``engine:queue`` beats a hypothetical ``engine:`` rule).
STAGE_RULES: Tuple[Tuple[str, str], ...] = (
    ("ingress:", "ingress"),
    ("handle:", "handle"),
    ("submit:", "submit"),
    ("reroute:", "reroute"),
    ("replica:", "replica"),
    ("engine:queue", "queue"),
    ("engine:prefill", "prefill"),
    ("engine:decode", "decode"),
    ("task:", "execute"),
)


def _dur(span: Dict[str, Any]) -> float:
    try:
        return max(float(span["end"]) - float(span["start"]), 0.0)
    except (KeyError, TypeError, ValueError):
        return 0.0


def _valid(span: Dict[str, Any]) -> bool:
    return isinstance(span.get("start"), (int, float)) \
        and isinstance(span.get("end"), (int, float))


def stage_of(name: str) -> str:
    for prefix, stage in STAGE_RULES:
        if name.startswith(prefix):
            return stage
    return "other"


def summarize(events, limit: int = 100) -> List[Dict[str, Any]]:
    """Group timeline span events by trace id -> summary rows (most recent
    first).  ``events`` may be the raw timeline (non-span events are
    skipped)."""
    traces: Dict[str, List[dict]] = {}
    for ev in events:
        if ev.get("kind") != "span" or not _valid(ev):
            continue
        tid = ev.get("trace_id")
        if tid:
            traces.setdefault(tid, []).append(ev)
    rows = []
    for tid, spans in traces.items():
        ids = {s.get("span_id") for s in spans}
        roots = [s for s in spans if s.get("parent_id") not in ids]
        root = min(roots or spans, key=lambda s: s["start"])
        start = min(s["start"] for s in spans)
        end = max(s["end"] for s in spans)
        rows.append({
            "trace_id": tid,
            "root": root.get("name", ""),
            "spans": len(spans),
            "start": round(start, 6),
            "duration_s": round(end - start, 6),
        })
    rows.sort(key=lambda r: -r["start"])
    return rows[:limit]


def build_tree(spans: List[dict]):
    """(roots, children) where children maps span_id -> child spans sorted
    by start.  A span whose parent_id is unknown (dropped, truncated ring)
    becomes a root — partial traces still render."""
    spans = [s for s in spans if _valid(s)]
    ids = {s.get("span_id") for s in spans}
    children: Dict[str, List[dict]] = {}
    roots: List[dict] = []
    for s in spans:
        parent = s.get("parent_id")
        if parent in ids and parent != s.get("span_id"):
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s["start"])
    roots.sort(key=lambda s: s["start"])
    return roots, children


def _merged_coverage(span: Dict[str, Any],
                     others: List[dict]) -> float:
    """Seconds of ``span``'s own interval covered by the union of the
    other spans' intervals (merged, so overlapping children don't double
    count)."""
    lo, hi = float(span["start"]), float(span["end"])
    clipped = sorted(
        (max(float(o["start"]), lo), min(float(o["end"]), hi))
        for o in others
    )
    covered = 0.0
    cur_lo: Optional[float] = None
    cur_hi = 0.0
    for s, e in clipped:
        if e <= s:
            continue
        if cur_lo is None:
            cur_lo, cur_hi = s, e
        elif s <= cur_hi:
            cur_hi = max(cur_hi, e)
        else:
            covered += cur_hi - cur_lo
            cur_lo, cur_hi = s, e
    if cur_lo is not None:
        covered += cur_hi - cur_lo
    return covered


def _descendants(span: Dict[str, Any], children) -> List[dict]:
    out: List[dict] = []
    stack = list(children.get(span.get("span_id") or "", []))
    while stack:
        s = stack.pop()
        out.append(s)
        stack.extend(children.get(s.get("span_id") or "", []))
    return out


def _walk_critical(node: Dict[str, Any], children, out: List[dict],
                   seen) -> None:
    """Backward sibling walk (the Jaeger-style critical path over a span
    tree): the last-finishing child bounds the tail of the parent; before
    that child starts, the latest-ending earlier sibling bounds the next
    segment; and so on — so a decode span's critical path includes the
    prefill that gated it, not just the deepest chain."""
    if id(node) in seen:
        return  # malformed parent links must not recurse forever
    seen.add(id(node))
    out.append(node)
    kids = sorted(children.get(node.get("span_id") or "", []),
                  key=lambda s: s["end"], reverse=True)
    cursor: Optional[float] = None
    for k in kids:
        if cursor is None or k["end"] <= cursor:
            _walk_critical(k, children, out, seen)
            cursor = float(k["start"])


def critical_path(spans: List[dict]) -> List[Dict[str, Any]]:
    """The span chain bounding the trace's wall time, chronological order.
    Each row carries the span's duration and its *self* time — the part
    of its interval not covered by its own descendants on the path
    (children may outlive their parents: a handle span closes at
    submission while the execution span runs on, so coverage is interval
    math, not child-duration subtraction).  Shrinking anything off this
    path cannot speed the request up."""
    roots, children = build_tree(spans)
    if not roots:
        return []
    path: List[dict] = []
    _walk_critical(max(roots, key=_dur), children, path, set())
    path.sort(key=lambda s: (s["start"], s["end"]))
    path_ids = {id(s) for s in path}
    out = []
    for s in path:
        on_path_desc = [d for d in _descendants(s, children)
                        if id(d) in path_ids]
        out.append({
            "name": s.get("name", ""),
            "span_id": s.get("span_id"),
            "stage": stage_of(str(s.get("name", ""))),
            "duration_s": _dur(s),
            "self_s": max(
                _dur(s) - _merged_coverage(s, on_path_desc), 0.0),
        })
    return out


def stage_breakdown(spans: List[dict]) -> Dict[str, float]:
    """Wall seconds per pipeline stage.  Each span contributes its SELF
    time — its interval minus the merged coverage of ALL its descendants
    (not just direct children: a handle span's execution-span child
    outlives it, so the grandparent ingress span must discount the
    grandchild too) — so nested stages never double count.  The
    submit→execute flow gap (attrs.flow_id, see tracing.chrome_trace) is
    attributed to ``schedule``."""
    spans = [s for s in spans if _valid(s)]
    _, children = build_tree(spans)
    out: Dict[str, float] = {}
    by_id = {s.get("span_id"): s for s in spans}
    for s in spans:
        desc = _descendants(s, children)
        self_s = max(_dur(s) - _merged_coverage(s, desc), 0.0)
        stage = stage_of(str(s.get("name", "")))
        out[stage] = out.get(stage, 0.0) + self_s
    # Scheduling gaps: submit span end -> execution span start.  The gap
    # wall time currently sits in the self time of the span the wait
    # happened INSIDE (the submit span's parent) — move it, don't double
    # count it, or stage shares would sum past 100%.
    for s in spans:
        flow = (s.get("attrs") or {}).get("flow_id")
        if not flow:
            continue
        exec_span = by_id.get(flow)
        if exec_span is None:
            continue
        gap = exec_span["start"] - s["end"]
        if gap <= 0:
            continue
        out["schedule"] = out.get("schedule", 0.0) + gap
        parent = by_id.get(s.get("parent_id"))
        if parent is not None:
            pstage = stage_of(str(parent.get("name", "")))
            out[pstage] = max(out.get(pstage, 0.0) - gap, 0.0)
    return out


def _fmt_ms(seconds: float) -> str:
    ms = seconds * 1e3
    if ms >= 100:
        return f"{ms:.0f}ms"
    if ms >= 1:
        return f"{ms:.1f}ms"
    return f"{ms:.3f}ms"


def render_waterfall(spans: List[dict], width: int = 64) -> str:
    """ASCII Gantt of the span tree: one line per span, bar positioned on
    the trace's wall-clock extent."""
    spans = [s for s in spans if _valid(s)]
    if not spans:
        return "(no spans)"
    roots, children = build_tree(spans)
    t0 = min(s["start"] for s in spans)
    total = max(max(s["end"] for s in spans) - t0, 1e-9)
    label_w = min(
        max(len(str(s.get("name", ""))) + 2 * _depth_cap for s in spans),
        40,
    )
    lines = []

    def walk(span, depth):
        name = str(span.get("name", ""))
        label = ("  " * min(depth, _depth_cap) + name)[:label_w]
        lo = int((span["start"] - t0) / total * width)
        hi = int((span["end"] - t0) / total * width)
        hi = max(hi, lo + 1)
        bar = " " * lo + "█" * (hi - lo) + " " * (width - hi)
        lines.append(
            f"{label:<{label_w}} |{bar}| {_fmt_ms(_dur(span)):>9}")
        for child in children.get(span.get("span_id") or "", []):
            walk(child, depth + 1)

    for root in roots:
        walk(root, 0)
    header = f"{'span':<{label_w}} |{'total ' + _fmt_ms(total):<{width}}|"
    return "\n".join([header] + lines)


_depth_cap = 8


def format_trace(spans: List[dict]) -> str:
    """Full CLI rendering: waterfall + critical path + stage breakdown
    (what ``python -m ray_tpu trace <id>`` prints)."""
    spans = [s for s in spans if _valid(s)]
    if not spans:
        return "(no spans)"
    tid = spans[0].get("trace_id", "")
    t0 = min(s["start"] for s in spans)
    total = max(s["end"] for s in spans) - t0
    out = [f"trace {tid}  spans={len(spans)}  wall={_fmt_ms(total)}", ""]
    out.append(render_waterfall(spans))
    out.append("")
    out.append("critical path:")
    for row in critical_path(spans):
        out.append(
            f"  {row['name']:<40} {_fmt_ms(row['duration_s']):>9}"
            f"  (self {_fmt_ms(row['self_s'])})")
    out.append("")
    out.append("stage breakdown:")
    breakdown = stage_breakdown(spans)
    for stage, secs in sorted(breakdown.items(), key=lambda kv: -kv[1]):
        share = secs / total * 100 if total > 0 else 0.0
        out.append(f"  {stage:<10} {_fmt_ms(secs):>9}  {share:5.1f}%")
    return "\n".join(out)
