"""Operator CLI: `python -m ray_tpu_torch <command>`.

Role-equivalent to the reference's `ray` CLI + state API commands
(reference: python/ray/scripts/scripts.py:76, util/state/api.py:781 `ray
list ...`, `ray summary`, `ray timeline`, `ray status`): inspects a running
cluster over the control-plane RPC.  The address comes from --address,
RT_TORCH_ADDRESS, or ``core/config.address_file()`` (written by init()).

The port's own copy of ``ray_tpu/scripts.py``, with every subcommand of
``python -m ray_tpu``.  ``profile`` asks the worker for a ``torch.profiler``
capture; ``lint`` refuses, since the port has no rtlint yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from .core.config import ADDRESS_ENV, address_file


def _resolve_address(addr: Optional[str]) -> str:
    if addr:
        return addr
    if os.environ.get(ADDRESS_ENV):
        return os.environ[ADDRESS_ENV]
    try:
        with open(address_file()) as f:
            return f.read().strip()
    except OSError:
        raise SystemExit(
            f"no cluster address (use --address, {ADDRESS_ENV}, or start a "
            "cluster first)"
        )


def _client(addr: Optional[str]):
    from .core.client import Client

    return Client(_resolve_address(addr), kind="driver", pid=os.getpid())


def _format_table(rows, columns, empty: str = "(no items)") -> str:
    if not rows:
        return empty
    widths = {
        c: max(len(c), *(len(str(r.get(c, ""))) for r in rows))
        for c in columns
    }
    out = ["  ".join(c.upper().ljust(widths[c]) for c in columns)]
    for r in rows:
        out.append(
            "  ".join(str(r.get(c, "")).ljust(widths[c]) for c in columns))
    return "\n".join(out)


def _print_table(rows, columns, empty: str = "(no items)"):
    print(_format_table(rows, columns, empty))


def _union_columns(items) -> list:
    """Column set spanning EVERY row (first-seen order): heterogeneous
    state rows (e.g. pending vs reserved placement groups) must not have
    fields silently dropped because items[0] happened to lack them."""
    cols: list = []
    for r in items:
        for k in r:
            if k not in cols:
                cols.append(k)
    return cols


_LIST_COLUMNS = {
    "actors": ["actor_id", "class_name", "state", "name", "pid",
               "num_executed_tasks"],
    "tasks": ["task_id", "name", "state", "error"],
    "nodes": ["node_id", "alive", "resources", "available"],
    "workers": ["worker_id", "node_id", "state", "pid"],
    "objects": ["object_id", "size", "sealed", "inline", "ref_count"],
    "placement_groups": ["pg_id", "strategy", "created", "name"],
    "logs": ["proc_id", "kind", "node_id", "pid", "alive", "actor_id",
             "log_path"],
    "task_events": ["task_id", "name", "state", "node_id", "worker_id",
                    "error"],
    "incidents": ["id", "kind", "severity", "state", "fired_count",
                  "summary"],
    "gang_rounds": ["gang", "world", "last_t", "latest"],
}


def cmd_list(args) -> int:
    kind = {"pgs": "placement_groups"}.get(args.kind, args.kind)
    cl = _client(args.address)
    try:
        items = cl.call("list_state", {"kind": kind})["items"]
        if args.json:
            print(json.dumps(items, indent=1, default=str))
        else:
            _print_table(items, _LIST_COLUMNS.get(kind) or
                         _union_columns(items), empty=f"(no {kind})")
    finally:
        cl.close()
    return 0


def cmd_status(args) -> int:
    cl = _client(args.address)
    try:
        nodes = cl.call("list_state", {"kind": "nodes"})["items"]
        workers = cl.call("list_state", {"kind": "workers"})["items"]
        actors = cl.call("list_state", {"kind": "actors"})["items"]
        total = cl.call("cluster_resources")["resources"]
        avail = cl.call("available_resources")["resources"]
        health = _health_line(cl)
        if health:
            print(health)
        print(f"nodes: {sum(1 for n in nodes if n.get('alive'))} alive / "
              f"{len(nodes)}")
        print(f"workers: {len(workers)}  actors: "
              f"{sum(1 for a in actors if a['state'] == 'ALIVE')} alive")
        for res in sorted(total):
            used = total[res] - avail.get(res, 0)
            print(f"  {res}: {used:g}/{total[res]:g} used")
        stats = cl.call("store_stats")
        used_b = stats.get("used_bytes", 0)
        cap_b = stats.get("capacity_bytes", 0)
        print(f"object store: {used_b / 2**20:.1f}/{cap_b / 2**20:.1f} "
              "MiB used (head node)")
        # Head fault-tolerance posture: restarts survived, field resyncs
        # adopted, and per-node headless time (ray_tpu_headless_seconds).
        try:
            rows = cl.call("list_state", {"kind": "metrics"})["items"]
            restarts = sum(r.get("value", 0) for r in rows
                           if r["name"] == "ray_tpu_head_restarts_total")
            resyncs = sum(r.get("value", 0) for r in rows
                          if r["name"] == "ray_tpu_resync_reports_total")
            headless = [(r.get("tags", {}).get("node", "?")[:8],
                         r.get("value", 0.0)) for r in rows
                        if r["name"] == "ray_tpu_headless_seconds"]
            if restarts or resyncs or headless:
                print(f"head restarts: {restarts:g}  "
                      f"resync reports: {resyncs:g}")
                for node, secs in sorted(headless):
                    print(f"  node {node}: {secs:.1f}s headless")
        except Exception:
            pass  # older head without the FT metrics: stay quiet
        # Inference engines (flight-recorder + devmem planes): one line
        # per engine with batch occupancy, KV pages, adapter pins, and
        # device bytes by pool.
        try:
            engines = cl.call(
                "list_state", {"kind": "engine_steps", "limit": 64}
            )["items"]
            devmem = cl.call("list_state", {"kind": "devmem"})["items"]
            for row in _engine_rows(engines, devmem):
                print(f"  engine {row['engine']}: slots {row['slots']}  "
                      f"queued {row['queued']}  pages {row['pages']}  "
                      f"stall {row['stall%']}%  "
                      f"adapters pinned {row['adapters']}"
                      + (f"  hbm {row['hbm']}" if row["hbm"] else ""))
        except Exception:
            pass  # older head without the observability plane: stay quiet
    finally:
        cl.close()
    return 0


def _engine_rows(engines, devmem_items) -> list:
    """Join engine flight-recorder windows with devmem pool snapshots into
    display rows (shared by `status` and `top`).  Engine ids are
    ``<pid>.<seq>``, so the pid prefix keys into the devmem reports."""
    dm_by_pid = {d.get("pid"): (d.get("devmem") or {}) for d in devmem_items}
    rows = []
    for e in engines:
        recs = e.get("records") or []
        latest = e.get("latest") or {}
        wall = sum(float(r.get("wall_s") or 0) for r in recs)
        stall = sum(float(r.get("stall_s") or 0) for r in recs)
        try:
            pid = int(str(e.get("engine", "")).split(".", 1)[0])
        except ValueError:
            pid = None
        pools = dm_by_pid.get(pid, {}).get("pools") or {}
        tenants = latest.get("tenants") or {}
        rows.append({
            "engine": e.get("engine", "?"),
            "slots": f"{latest.get('occupancy', 0)}/"
                     f"{latest.get('slots', 0)}",
            "queued": latest.get("queued", 0),
            "stall%": f"{100.0 * stall / wall:.1f}" if wall > 0 else "0.0",
            "pages": f"{latest.get('pages_used', 0)}u/"
                     f"{latest.get('pages_free', 0)}f",
            "adapters": latest.get("adapter_pins", 0),
            "hbm": " ".join(
                f"{name}={nbytes / 2**20:.0f}M"
                for name, nbytes in sorted(pools.items()) if nbytes
            ),
            "tenants": " ".join(
                f"{t}:{n}" for t, n in sorted(tenants.items())) or "-",
        })
    return rows


def _gang_rows(items) -> list:
    """Display rows for the gang skew join (shared by `gang` and `top`):
    one line per gang with its latest joined round's wall/skew and
    straggler attribution."""
    rows = []
    for g in items:
        latest = g.get("latest") or {}
        skew = latest.get("skew_s")
        frac = latest.get("skew_frac")
        rows.append({
            "gang": g.get("gang", "?"),
            "world": g.get("world", 0),
            "round": latest.get("round", "-"),
            "wall": f"{latest.get('wall_s', 0):.3f}s" if latest else "-",
            "skew": f"{skew:.3f}s ({100 * frac:.0f}%)"
            if isinstance(skew, (int, float)) else "-",
            "straggler": f"r{latest.get('straggler')}:{latest.get('phase')}"
            if latest.get("straggler") is not None else "-",
            "data%": f"{100 * latest.get('data_frac', 0):.0f}"
            if latest else "-",
            "coll%": f"{100 * latest.get('coll_frac', 0):.0f}"
            if latest else "-",
            "mfu": f"{latest.get('mfu'):.3f}"
            if isinstance(latest.get("mfu"), (int, float)) else "-",
        })
    return rows


def cmd_gang(args) -> int:
    """Gang training skew: per-round straggler attribution joined from the
    per-rank round flight recorders.  Without an id, one summary line per
    gang; with an id (prefix), the recent skew profiles plus the newest
    raw record from every rank."""
    import time as _time

    cl = _client(args.address)
    try:
        body = {"kind": "gang_rounds", "limit": max(1, args.rounds)}
        if args.gang:
            body["gang"] = args.gang
        items = cl.call("list_state", body)["items"]
        if args.json:
            print(json.dumps(items, indent=1, default=str))
            return 0
        if not items:
            print(f"(no gang matching {args.gang!r})" if args.gang else
                  "(no gang rounds joined yet — flight recorder off or no "
                  "multi-rank train run)")
            return 1 if args.gang else 0
        if not args.gang:
            _print_table(_gang_rows(items),
                         ["gang", "world", "round", "wall", "skew",
                          "straggler", "data%", "coll%", "mfu"])
            return 0
        now = _time.time()
        for g in items:
            print(f"gang {g.get('gang')}  world {g.get('world')}  "
                  f"last seen {_age(now, g.get('last_t'))} ago")
            ranks = g.get("ranks") or {}
            rank_rows = [{
                "rank": r, "round": rec.get("round"),
                "wall": f"{rec.get('wall_s', 0):.3f}",
                "data": f"{rec.get('data_s', 0):.3f}",
                "coll": f"{rec.get('coll_s', 0):.3f}",
                "ckpt": f"{rec.get('ckpt_s', 0):.3f}",
                "ack": f"{rec.get('ack_s', 0):.3f}",
                "mfu": f"{rec.get('mfu'):.3f}"
                if isinstance(rec.get("mfu"), (int, float)) else "-",
            } for r, rec in sorted(ranks.items(), key=lambda kv: int(kv[0]))]
            _print_table(rank_rows,
                         ["rank", "round", "wall", "data", "coll", "ckpt",
                          "ack", "mfu"], empty="(no per-rank records)")
            prof_rows = [{
                "round": p.get("round"),
                "wall": f"{p.get('wall_s', 0):.3f}",
                "skew": f"{p.get('skew_s', 0):.3f}",
                "skew%": f"{100 * p.get('skew_frac', 0):.0f}",
                "straggler": f"r{p.get('straggler')}",
                "phase": p.get("phase"),
                "lag": f"{p.get('phase_lag_s', 0):.3f}",
                "mfu": f"{p.get('mfu'):.3f}"
                if isinstance(p.get("mfu"), (int, float)) else "-",
            } for p in (g.get("profiles") or [])]
            print()
            _print_table(prof_rows,
                         ["round", "wall", "skew", "skew%", "straggler",
                          "phase", "lag", "mfu"],
                         empty="(no joined rounds yet)")
    finally:
        cl.close()
    return 0


def _node_row(n: dict) -> dict:
    stats = n.get("stats") or {}
    mem = stats.get("mem_used_frac")
    return {
        "node": n.get("node_id", "")[:8],
        "alive": n.get("alive"),
        "load1": stats.get("load1", ""),
        "mem%": round(100 * mem, 1) if isinstance(mem, (int, float)) else "",
        "procs": stats.get("num_worker_procs", ""),
        "cpu": "{:g}/{:g}".format(
            (n.get("available") or {}).get("CPU", 0),
            (n.get("resources") or {}).get("CPU", 0)),
    }


def _render_top(cl) -> str:
    """One frame of `ray_tpu_torch top`: cluster header, node table, and the
    per-engine occupancy/stall/pages/HBM table."""
    import time as _time

    nodes = cl.call("list_state", {"kind": "nodes"})["items"]
    workers = cl.call("list_state", {"kind": "workers"})["items"]
    engines = cl.call(
        "list_state", {"kind": "engine_steps", "limit": 64})["items"]
    devmem = cl.call("list_state", {"kind": "devmem"})["items"]
    gangs = cl.call("list_state", {"kind": "gang_rounds", "limit": 1})["items"]
    alive = sum(1 for n in nodes if n.get("alive"))
    health = _health_line(cl)
    sections = [
        f"ray_tpu_torch top  {_time.strftime('%H:%M:%S')}  "
        f"nodes {alive}/{len(nodes)} alive  workers {len(workers)}"
        + (f"  |  {health}" if health else ""),
        "",
        _format_table(
            [_node_row(n) for n in nodes],
            ["node", "alive", "load1", "mem%", "procs", "cpu"],
            empty="(no nodes)",
        ),
        "",
        _format_table(
            _engine_rows(engines, devmem),
            ["engine", "slots", "queued", "stall%", "pages", "adapters",
             "hbm", "tenants"],
            empty="(no engines reporting — flight recorder off or no "
                  "serve traffic yet)",
        ),
    ]
    if gangs:
        # Gang section only when a train gang is actually reporting —
        # serve-only clusters keep the frame compact.
        sections += ["", _format_table(
            _gang_rows(gangs),
            ["gang", "world", "round", "wall", "skew", "straggler",
             "data%", "coll%", "mfu"])]
    return "\n".join(sections)


def cmd_top(args) -> int:
    """Auto-refreshing cluster table (reference: `ray status -v` + the
    dashboard, as a terminal loop): nodes, workers, and per-engine
    occupancy/stall%/KV pages/HBM-by-pool from the flight-recorder and
    devmem planes.  --once renders a single frame (scripts/CI)."""
    cl = _client(args.address)
    try:
        while True:
            try:
                frame = _render_top(cl)
            except KeyboardInterrupt:
                return 0
            except Exception as e:
                frame = f"(top refresh failed: {e})"
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(frame)
            sys.stdout.flush()
            if args.once:
                return 0
            try:
                import time as _time

                _time.sleep(max(0.2, args.interval))
            except KeyboardInterrupt:
                return 0
    finally:
        cl.close()


def cmd_down(args) -> int:
    """Shut the whole cluster down over the control plane (reference:
    `ray stop`): the head tears down workers, node daemons and itself."""
    cl = _client(args.address)
    try:
        cl.call("shutdown_cluster", {})
        print("cluster shutdown requested")
    finally:
        try:
            cl.close()
        except Exception:
            pass  # the head is going away under us by design
    return 0


def cmd_lint(args) -> int:
    """rtlint, the JAX package's framework-aware static analysis, has no
    counterpart in the port yet: a declared refusal until ``devtools/``
    (rtlint and its rules) is ported, the devtools item of ROADMAP.md's
    Queue 1."""
    print("lint: rtlint is not ported to ray_tpu_torch yet; it comes with "
          "devtools/ (rtlint and its rules), the devtools item of "
          "ROADMAP.md's Queue 1", file=sys.stderr)
    return 2


def cmd_summary(args) -> int:
    """Task summary by name+state (reference: `ray summary tasks`)."""
    cl = _client(args.address)
    try:
        items = cl.call("list_state", {"kind": "tasks"})["items"]
        agg = {}
        for t in items:
            key = (t.get("name", ""), t.get("state", ""))
            agg[key] = agg.get(key, 0) + 1
        rows = [
            {"name": k[0], "state": k[1], "count": v}
            for k, v in sorted(agg.items())
        ]
        _print_table(rows, ["name", "state", "count"])
    finally:
        cl.close()
    return 0


def cmd_metrics(args) -> int:
    cl = _client(args.address)
    try:
        rows = cl.call("list_state", {"kind": "metrics"})["items"]
        if args.prometheus:
            from .util.metrics import prometheus_text

            sys.stdout.write(prometheus_text(rows))
        else:
            _print_table(rows, ["name", "kind", "tags", "value"])
    finally:
        cl.close()
    return 0


def cmd_timeline(args) -> int:
    cl = _client(args.address)
    try:
        items = cl.call("list_state", {"kind": "timeline"})["items"]
        if getattr(args, "chrome", False):
            # chrome://tracing / Perfetto format from span events
            # (reference: `ray timeline` emits the same shape).
            from .util.tracing import chrome_trace

            print(json.dumps(chrome_trace(items)))
        else:
            print(json.dumps(items, indent=1, default=str))
    finally:
        cl.close()
    return 0


def cmd_trace(args) -> int:
    """Per-request trace analysis (the span-plane query surface): without
    an id, lists recent traces; with a trace id (hex prefix ok), prints
    the ASCII waterfall, the critical path, and the per-stage latency
    breakdown; ``--chrome`` exports that one trace as chrome://tracing
    JSON with the submit->execute flow arrows."""
    cl = _client(args.address)
    try:
        if not args.trace_id:
            items = cl.call("list_state", {"kind": "traces"})["items"]
            if args.json:
                print(json.dumps(items, indent=1, default=str))
            else:
                _print_table(
                    items,
                    ["trace_id", "root", "spans", "start", "duration_s"],
                    empty="(no traces)")
            return 0
        reply = cl.call(
            "list_state", {"kind": "traces", "trace_id": args.trace_id})
        spans = reply["items"]
        ambiguous = reply.get("ambiguous_matches")
        if ambiguous:
            print(
                f"note: prefix {args.trace_id!r} matches "
                f"{len(ambiguous)} traces — showing the most recent "
                f"({spans[0].get('trace_id', '?')}); others: "
                + " ".join(t[:16] for t in ambiguous[:8]),
                file=sys.stderr)
        if not spans:
            print(f"(no spans for trace {args.trace_id!r} — sampled out, "
                  "expired from the timeline ring, or wrong id)",
                  file=sys.stderr)
            return 1
        if getattr(args, "chrome", False):
            from .util.tracing import chrome_trace

            print(json.dumps(chrome_trace(spans)))
            return 0
        if args.json:
            print(json.dumps(spans, indent=1, default=str))
            return 0
        from .util import trace_analysis

        print(trace_analysis.format_trace(spans))
    finally:
        cl.close()
    return 0


def _health_line(cl) -> Optional[str]:
    """One-line cluster health grade for `status` and the `top` header;
    None against a head without the incident plane."""
    try:
        reply = cl.call("list_state", {"kind": "incidents"})
    except Exception:
        return None
    grade = reply.get("grade", "OK")
    n = reply.get("open", 0)
    line = f"health: {grade}  open incidents: {n}"
    if n:
        worst = next((i for i in reply.get("items", [])
                      if i.get("state") != "resolved"), None)
        if worst:
            line += f"  ({worst['kind']}: {worst['summary']})"
    return line


def _age(now: float, ts) -> str:
    if not isinstance(ts, (int, float)):
        return ""
    d = max(0.0, now - ts)
    return f"{d:.0f}s" if d < 120 else f"{d / 60:.0f}m"


def cmd_incidents(args) -> int:
    """Incident ring of the health plane: every detector firing that
    opened an incident, with lifecycle state and dedup counts."""
    import time as _time

    cl = _client(args.address)
    try:
        reply = cl.call("list_state", {"kind": "incidents"})
        items = reply["items"]
        if args.json:
            print(json.dumps(
                {"grade": reply.get("grade"), "open": reply.get("open"),
                 "incidents": items}, indent=1, default=str))
            return 0
        print(f"health: {reply.get('grade', 'OK')}  "
              f"open: {reply.get('open', 0)}  total: {len(items)}")
        now = _time.time()
        rows = [{
            "id": i.get("id"), "kind": i.get("kind"),
            "sev": i.get("severity"), "state": i.get("state"),
            "age": _age(now, i.get("opened")),
            "fired": i.get("fired_count"),
            "summary": str(i.get("summary", ""))[:72],
        } for i in items]
        _print_table(rows, ["id", "kind", "sev", "state", "age", "fired",
                            "summary"], empty="(no incidents)")
    finally:
        cl.close()
    return 0


def _doctor_object_plane(cl) -> int:
    """Put-path contention attribution from the cluster-aggregated stage
    histograms — where the object-plane put wall goes (the measurement
    gate for the zero-copy redesign, ROADMAP item 3)."""
    rows = cl.call("list_state", {"kind": "metrics"})["items"]

    def hist_rows(name):
        return [r for r in rows if r["name"] == name and "sum" in r]

    stages = {}
    for r in hist_rows("ray_tpu_put_copy_seconds"):
        stage = r.get("tags", {}).get("stage", "?")
        cur = stages.setdefault(stage, [0.0, 0])
        cur[0] += r.get("sum", 0.0)
        cur[1] += r.get("count", 0)
    lock = [(r.get("sum", 0.0), r.get("count", 0))
            for r in hist_rows("ray_tpu_store_lock_wait_seconds")]
    if lock:
        stages["lock_wait"] = [sum(s for s, _ in lock),
                               sum(c for _, c in lock)]
    outbox = [(r.get("sum", 0.0), r.get("count", 0))
              for r in hist_rows("ray_tpu_rpc_outbox_delay_seconds")]
    if not stages:
        print("(no put-stage samples yet — do a large put first)")
        return 1
    total = sum(s for s, _ in stages.values())
    print("object-plane put attribution (cluster cumulative):")
    table = [{
        "stage": stage, "seconds": f"{secs:.4f}", "ops": int(count),
        "share": f"{100 * secs / total:.1f}%" if total else "-",
    } for stage, (secs, count) in
        sorted(stages.items(), key=lambda kv: -kv[1][0])]
    _print_table(table, ["stage", "seconds", "ops", "share"])
    if outbox:
        osum = sum(s for s, _ in outbox)
        ocnt = sum(c for _, c in outbox)
        print(f"rpc outbox queue delay: {osum:.4f}s over {ocnt} "
              "drain bursts")
    return 0


def cmd_doctor(args) -> int:
    """Root-cause narrative for an incident: replays the evidence chain
    (trace links, task events, counter deltas) and runs the span-plane
    critical-path analysis on the slowest linked trace.  Without an id,
    diagnoses the most recent open incident; --object-plane prints the
    put-path contention attribution instead."""
    import time as _time

    cl = _client(args.address)
    try:
        if getattr(args, "object_plane", False):
            return _doctor_object_plane(cl)
        reply = cl.call("list_state", {"kind": "incidents"})
        items = reply["items"]
        if args.incident:
            items = [i for i in items
                     if str(i.get("id", "")).startswith(args.incident)]
            if not items:
                print(f"(no incident matching {args.incident!r})")
                return 1
        else:
            open_items = [i for i in items if i.get("state") != "resolved"]
            items = open_items or items
            if not items:
                print(f"health: {reply.get('grade', 'OK')} — no incidents "
                      "recorded; nothing to diagnose")
                return 0
        inc = items[0]
        now = _time.time()
        print(f"incident {inc['id']}  [{inc['kind']}/{inc['severity']}]  "
              f"state={inc['state']}")
        print(f"  {inc['summary']}")
        print(f"  opened {_age(now, inc.get('opened'))} ago, fired "
              f"{inc.get('fired_count', 1)}x, last "
              f"{_age(now, inc.get('last_fired'))} ago"
              + (f", resolved {_age(now, inc.get('resolved'))} ago"
                 if inc.get("resolved") else ""))
        ev = inc.get("evidence") or {}
        deltas = ev.get("counter_deltas") or (inc.get("data") or {}).get(
            "deltas")
        if deltas:
            print("  counter deltas in window: " + "  ".join(
                f"{k}=+{v:g}" for k, v in deltas.items()))
        if ev.get("step_window"):
            print("  step-record window: " + "  ".join(
                f"{k}={v}" for k, v in ev["step_window"].items()))
        if ev.get("gang"):
            # Gang incident: rank/phase attribution from the skew join.
            line = f"  gang {ev['gang']}"
            if ev.get("rank") is not None:
                line += f": straggler rank {ev['rank']}"
            if ev.get("phase"):
                line += f" late in {ev['phase']}"
            for k in ("skew_frac", "data_frac", "coll_frac"):
                if isinstance(ev.get(k), (int, float)):
                    line += f"  {k}={ev[k]:g}"
            print(line)
            for wr in (ev.get("worst_rounds") or [])[:3]:
                print("  worst round: " + "  ".join(
                    f"{k}={v}" for k, v in wr.items() if v is not None))
        for h in ev.get("slowest_handlers") or []:
            print(f"  handler {h['method']}: {h['total_s']}s "
                  f"over {h['calls']} calls")
        for e in (ev.get("task_events") or [])[:5]:
            print("  event: " + " ".join(
                f"{k}={v}" for k, v in e.items() if v is not None))
        tids = ev.get("trace_ids") or []
        if not tids:
            print("  (no linked traces in the evidence window)")
            return 0
        print(f"  linked traces: {len(tids)}")
        # Critical path of the slowest linked trace: the narrative's
        # "where the time actually went" section.
        slowest, slow_spans, slow_dur = None, None, -1.0
        for tid in tids:
            try:
                spans = cl.call("list_state",
                                {"kind": "traces", "trace_id": tid})["items"]
            except Exception:
                continue
            if not spans:
                continue
            starts = [s["start"] for s in spans
                      if isinstance(s.get("start"), (int, float))]
            ends = [s["end"] for s in spans
                    if isinstance(s.get("end"), (int, float))]
            dur = (max(ends) - min(starts)) if starts and ends else 0.0
            if dur > slow_dur:
                slowest, slow_spans, slow_dur = tid, spans, dur
        if slow_spans is None:
            print("  (linked traces already expired from the ring)")
            return 0
        from .util import trace_analysis

        print(f"\nslowest linked trace {str(slowest)[:16]} "
              f"({slow_dur:.3f}s):")
        print(trace_analysis.format_trace(slow_spans))
    finally:
        cl.close()
    return 0


def cmd_logs(args) -> int:
    """Cluster log retrieval (reference: `ray logs`).  Without an id, lists
    the head's log index — including EXITED processes, whose files stay
    retrievable for crash post-mortems.  With an id (worker/node hex
    prefix, actor id, or pid), streams that process's log; --follow keeps
    tailing a live process."""
    if getattr(args, "post_mortem", False):
        return _post_mortem_tails(args)
    cl = _client(args.address)
    try:
        if not args.id:
            items = cl.call("list_state", {"kind": "logs"})["items"]
            _print_table(items, _LIST_COLUMNS["logs"],
                         empty="(no registered logs)")
            return 0
        from .core.api import iter_log_chunks

        try:
            for data in iter_log_chunks(
                cl.call, args.id, offset=-args.tail if args.tail else 0,
                follow=args.follow,
            ):
                sys.stdout.write(data.decode("utf-8", "replace"))
                sys.stdout.flush()
        except RuntimeError as e:
            print(e, file=sys.stderr)
            return 1
    finally:
        cl.close()
    return 0


def _post_mortem_tails(args) -> int:
    """Dump the tail of every cluster process log — CI calls this when the
    test run fails so failures come with worker-side post-mortems.  Routes
    through the head's log index when a cluster is reachable; falls back
    to scanning the log root on the local filesystem."""
    import glob

    tail = args.tail or 4000
    paths: list = []
    try:
        cl = _client(args.address)
        try:
            paths = [e["log_path"] for e
                     in cl.call("list_state", {"kind": "logs"})["items"]
                     if e.get("log_path")]
        finally:
            cl.close()
    except (SystemExit, Exception):
        pass  # no live cluster: the filesystem fallback below still works
    if not paths:
        from .core.node_main import LOG_ROOT

        paths = sorted(
            glob.glob(os.path.join(LOG_ROOT, "*", "*.log")),
            key=lambda p: os.path.getmtime(p) if os.path.exists(p) else 0,
        )
    # Flight-recorder black boxes (<log>.steps.log sidecars) ride along
    # with their log's tail: the head's index stores only the log file
    # itself, and the SIGKILLed worker the sidecar exists for is exactly
    # the one a post-mortem is after.
    for path in list(paths):
        stem = path[:-4] if path.endswith(".log") else path
        sidecar = stem + ".steps.log"
        if sidecar != path and sidecar not in paths \
                and os.path.exists(sidecar):
            paths.append(sidecar)
    shown = 0
    for path in paths[-40:]:
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(max(0, size - tail))
                data = f.read().decode("utf-8", "replace")
        except OSError:
            continue
        if not data.strip():
            continue
        print(f"==== {path} (last {min(size, tail)} bytes) ====")
        print(data)
        shown += 1
    if not shown:
        print("(no cluster process logs found)")
    return 0


def cmd_events(args) -> int:
    """Task lifecycle history (reference: `ray list tasks --detail` / the
    task events state API): per-task SUBMITTED/SCHEDULED/RUNNING/FINISHED/
    FAILED transitions with placement and failure tracebacks, retained at
    the head past worker/node death."""
    cl = _client(args.address)
    try:
        body = {"kind": "task_events"}
        if args.task:
            body["task_id"] = args.task
        if args.errors:
            body["errors"] = True
        items = cl.call("list_state", body)["items"]
        if args.json:
            print(json.dumps(items, indent=1, default=str))
            return 0
        if args.task:
            if not items:
                print(f"(no task events for {args.task!r})")
                return 0
            for rec in items:
                print(f"task {rec['task_id']}  name={rec.get('name', '')}  "
                      f"state={rec.get('state', '')}")
                for ev in rec.get("events", []):
                    where = " ".join(
                        f"{k}={ev[k]}" for k in ("node", "worker", "error")
                        if ev.get(k)
                    )
                    print(f"  {ev.get('ts', 0):.6f}  "
                          f"{ev.get('state', ''):<10} {where}")
                if rec.get("traceback"):
                    print("  traceback:")
                    for line in str(rec["traceback"]).splitlines():
                        print(f"    {line}")
            return 0
        rows = [
            {
                "task_id": r["task_id"][:16],
                "name": r.get("name", ""),
                "state": r.get("state", ""),
                "node_id": (r.get("node_id") or "")[:8],
                "worker_id": (r.get("worker_id") or "")[:8],
                "error": " ".join(str(r.get("error") or "").split())[:60],
            }
            for r in items
        ]
        _print_table(rows, _LIST_COLUMNS["task_events"],
                     empty="(no task events)")
    finally:
        cl.close()
    return 0


def cmd_stack(args) -> int:
    """On-demand all-thread stack dump of a live worker (reference:
    `ray stack`): the hung-gang diagnosis tool — collected by the worker's
    rpc thread without interrupting the running task."""
    cl = _client(args.address)
    try:
        reply = cl.call(
            "stack_dump",
            {"worker_id": args.worker_id, "timeout": args.timeout},
            timeout=args.timeout + 30,
        )
    finally:
        cl.close()
    if not reply.get("found") or not reply.get("ok"):
        print(reply.get("error", "stack dump failed"), file=sys.stderr)
        return 1
    print(f"worker {reply['worker_id'][:16]} pid={reply.get('pid')} "
          f"node={reply.get('node_id', '')[:8]} "
          f"threads={reply.get('threads')}")
    print(reply.get("dump", ""))
    return 0


def cmd_profile(args) -> int:
    """On-demand device-trace capture of a live worker (reference:
    `ray timeline`-class tooling; here the profiler of record is
    torch.profiler): the worker wraps its live process in
    util.profiling.device_trace for N seconds (its card's activity when it
    holds a grant, its host's when it holds none) and replies with the
    TensorBoard trace dir."""
    cl = _client(args.address)
    try:
        body = {"worker_id": args.worker_id, "seconds": args.seconds}
        if args.logdir:
            body["logdir"] = args.logdir
        reply = cl.call("profile", body, timeout=args.seconds + 60)
    finally:
        cl.close()
    if not reply.get("found") or not reply.get("ok"):
        print(reply.get("error", "profile capture failed"), file=sys.stderr)
        return 1
    print(f"worker {reply['worker_id'][:16]} pid={reply.get('pid')} "
          f"node={reply.get('node_id', '')[:8]}")
    print(f"trace dir: {reply.get('logdir')}")
    print(f"view with: tensorboard --logdir {reply.get('logdir')}")
    return 0


def cmd_serve(args) -> int:
    """Declarative Serve operations (reference: `serve deploy/status/
    shutdown` CLI over the schema config)."""
    os.environ.setdefault(ADDRESS_ENV, _resolve_address(args.address))
    from ray_tpu_torch import serve as rt_serve

    if args.action == "deploy":
        if not args.config:
            raise SystemExit("serve deploy requires a config file path")
        handles = rt_serve.deploy_config(args.config)
        print(f"deployed {len(handles)} application(s)")
        st = rt_serve.status()
        for name, info in sorted(st.items()):
            print(f"  {name}: {info['running_replicas']}/"
                  f"{info['target_replicas']} replicas")
    elif args.action == "status":
        for name, info in sorted(rt_serve.status().items()):
            print(f"{name}: {info}")
    elif args.action == "shutdown":
        rt_serve.shutdown()
        print("serve shut down")
    return 0


def cmd_dashboard(args) -> int:
    """Serve the web dashboard against a running cluster (reference:
    dashboard/head.py runs as its own process attached to the GCS)."""
    from .dashboard import Dashboard

    dash = Dashboard(
        _resolve_address(args.address), host=args.host, port=args.port
    ).start()
    print(f"dashboard at {dash.url} (ctrl-c to stop)")
    try:
        import signal

        signal.pause()
    except (KeyboardInterrupt, AttributeError):
        pass
    finally:
        dash.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch")
    ap.add_argument("--address", default=None)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("kind", choices=[
        "actors", "tasks", "nodes", "workers", "objects",
        "placement_groups", "pgs", "logs", "task_events",
        "engine_steps", "gang_rounds", "devmem", "incidents",
    ])
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser(
        "logs", help="cluster log index / per-process log retrieval"
    )
    p.add_argument("id", nargs="?", default=None,
                   help="worker/node id (hex prefix), actor id, or pid; "
                        "omit to list the index")
    p.add_argument("--follow", action="store_true",
                   help="keep tailing a live process")
    p.add_argument("--tail", type=int, default=0, metavar="BYTES",
                   help="start BYTES from the end of the log")
    p.add_argument("--post-mortem", action="store_true",
                   help="dump tails of every cluster process log "
                        "(index-routed, filesystem fallback) — for CI "
                        "failure forensics")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("events", help="task lifecycle event history")
    p.add_argument("--task", default=None,
                   help="show full transitions for tasks matching this id "
                        "prefix")
    p.add_argument("--errors", action="store_true",
                   help="only failed tasks")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser(
        "stack", help="dump all-thread Python stacks of a live worker"
    )
    p.add_argument("worker_id",
                   help="worker id (hex prefix) or actor id")
    p.add_argument("--timeout", type=float, default=15.0)
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser("status", help="cluster resource summary")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser(
        "incidents",
        help="health-plane incident ring (detector firings + lifecycle)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_incidents)

    p = sub.add_parser(
        "doctor",
        help="root-cause narrative: replay an incident's evidence chain "
             "and critical-path the slowest linked trace")
    p.add_argument("incident", nargs="?", default=None,
                   help="incident id (prefix ok); omit for the most "
                        "recent open incident")
    p.add_argument("--object-plane", action="store_true",
                   help="print the put-path contention attribution "
                        "(stage split + store-lock wait + outbox delay)")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser(
        "top", help="auto-refreshing cluster/engine table"
    )
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (scripts/CI)")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser(
        "gang",
        help="gang training skew: per-round straggler attribution from "
             "the rank flight recorders")
    p.add_argument("gang", nargs="?", default=None,
                   help="gang id (prefix ok) for the per-rank detail view; "
                        "omit for one summary line per gang")
    p.add_argument("--rounds", type=int, default=20,
                   help="joined skew profiles to show per gang")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_gang)

    p = sub.add_parser(
        "profile",
        help="capture a device trace (torch.profiler) on a live worker",
    )
    p.add_argument("worker_id",
                   help="worker id (hex prefix) or actor id")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="capture window length")
    p.add_argument("--logdir", default=None,
                   help="trace destination on the worker's machine "
                        "(default: ray_tpu_torch_profiles/<worker> under "
                        "the temp dir)")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("down", help="shut the cluster down")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser(
        "lint", help="framework-aware static analysis (RT001-RT012; not "
                     "ported yet)"
    )
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings")
    p.add_argument("--root", default=None,
                   help="package directory to lint (default: this "
                        "installed ray_tpu_torch package)")
    p.add_argument("--allowlist", default=None,
                   help="allowlist file (default: the package's own "
                        ".rtlint-allowlist)")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser("summary", help="task summary by name+state")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("metrics", help="aggregated user metrics")
    p.add_argument("--prometheus", action="store_true")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("timeline", help="task event timeline (json)")
    p.add_argument("--chrome", action="store_true",
                   help="emit chrome://tracing span JSON")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser(
        "trace",
        help="per-request trace: waterfall, critical path, stage "
             "breakdown",
    )
    p.add_argument("trace_id", nargs="?", default=None,
                   help="trace id (hex prefix ok); omit to list recent "
                        "traces")
    p.add_argument("--chrome", action="store_true",
                   help="emit this trace as chrome://tracing JSON (flow "
                        "arrows included)")
    p.add_argument("--json", action="store_true",
                   help="raw span dicts / summary rows")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("serve", help="declarative serve operations")
    p.add_argument("action", choices=["deploy", "status", "shutdown"])
    p.add_argument("config", nargs="?", help="JSON or YAML config (for deploy)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("dashboard", help="serve the web dashboard")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8265)
    p.set_defaults(fn=cmd_dashboard)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
