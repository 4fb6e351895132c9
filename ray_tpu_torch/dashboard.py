"""Web dashboard: HTTP JSON API + a self-contained HTML UI over the state
plane.

Role-equivalent to the reference's dashboard head + modules
(reference: python/ray/dashboard/head.py:53 DashboardHead, module REST
routes under dashboard/modules/{actor,node,job,metrics,reporter}) —
re-designed: instead of a dedicated aiohttp process with per-node agents, a
single threaded HTTP server rides on the existing state RPCs (`list_state`,
`cluster_resources`) through one head connection.  Per-node stats already
flow to the head (worker heartbeats carry rss/cpu), so no agent processes
are needed at this scale.

Endpoints:
    /api/nodes /api/actors /api/tasks /api/workers /api/objects
    /api/placement_groups /api/timeline /api/metrics   -> {"items": [...]}
    /api/task_events -> per-task lifecycle histories (transitions +
                        failure tracebacks, retained past worker death)
    /api/logs     -> the cluster log index (exited processes included)
    /api/traces   -> per-trace summary rows from the span plane (trace id,
                     root span, span count, duration) — drill in via
                     `python -m ray_tpu_torch trace <id>`
    /api/log?proc=<id>[&offset=N][&max_bytes=N] -> raw log content,
                     routed head -> owning node (negative offset = tail)
    /api/metrics/history -> retained time series per (metric, tags):
                            {"items": [{name, tags, kind, points: [[ts, v]]}]}
    /api/status   -> cluster resource totals/availability + process counts
    /api/jobs     -> submitted jobs (job_submission KV records)
    /api/summary  -> task counts by (name, state)
    /metrics      -> Prometheus exposition (scrapeable)
    /             -> HTML UI (tabs per endpoint + sparkline history panels,
                     auto-refresh)

Start via ``ray_tpu_torch.init(include_dashboard=True)``, programmatically
with ``Dashboard(addr).start()``, or ``python -m ray_tpu_torch dashboard``.
The port's own copy of ``ray_tpu/dashboard.py``, every route the same; the
metric names keep their ``ray_tpu_`` prefix.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_STATE_KINDS = (
    "nodes", "actors", "tasks", "workers", "objects",
    "placement_groups", "timeline", "metrics", "task_events", "logs",
    "traces", "engine_steps", "gang_rounds", "devmem", "incidents",
)

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
 body { font: 13px/1.5 system-ui, sans-serif; margin: 0; color: #1a1a2e; }
 header { background: #16213e; color: #fff; padding: 10px 16px; }
 header h1 { font-size: 15px; margin: 0; display: inline-block; }
 header span { opacity: .65; margin-left: 12px; font-size: 12px; }
 nav { background: #f4f4f8; padding: 6px 12px; border-bottom: 1px solid #ddd; }
 nav button { border: 0; background: none; padding: 6px 10px; cursor: pointer;
              font: inherit; border-radius: 4px; }
 nav button.on { background: #16213e; color: #fff; }
 #status { padding: 12px 16px; display: flex; gap: 24px; flex-wrap: wrap; }
 .stat { background: #f4f4f8; border-radius: 6px; padding: 8px 14px; }
 .stat b { display: block; font-size: 18px; }
 table { border-collapse: collapse; margin: 8px 16px; width: calc(100% - 32px); }
 th, td { text-align: left; padding: 4px 10px; border-bottom: 1px solid #eee;
          font-size: 12px; max-width: 420px; overflow: hidden;
          text-overflow: ellipsis; white-space: nowrap; }
 th { background: #f4f4f8; position: sticky; top: 0; }
 .err { color: #b00; padding: 12px 16px; }
 #content .sparks { display: flex; flex-wrap: wrap; gap: 12px;
                    padding: 12px 16px; }
 .spark { background: #f4f4f8; border-radius: 6px; padding: 8px 12px;
          width: 280px; }
 .spark .t { font-size: 11px; color: #555; overflow: hidden;
             text-overflow: ellipsis; white-space: nowrap; }
 .spark .v { font-size: 15px; font-weight: 600; }
 .spark svg { display: block; width: 100%; height: 36px; }
 .spark polyline { fill: none; stroke: #16213e; stroke-width: 1.5; }
</style></head><body>
<header><h1>ray_tpu_torch dashboard</h1><span id="addr"></span></header>
<nav id="nav"></nav>
<div id="status"></div>
<div id="content"></div>
<script>
const TABS = ["status","nodes","actors","tasks","workers","objects",
              "placement_groups","jobs","metrics","history","summary",
              "task_events","logs","traces","engine_steps","gang_rounds",
              "devmem","incidents"];
let tab = location.hash.slice(1) || "status";
const nav = document.getElementById("nav");
TABS.forEach(t => {
  const b = document.createElement("button");
  b.textContent = t; b.id = "tab-" + t;
  b.onclick = () => { tab = t; location.hash = t; render(); };
  nav.appendChild(b);
});
async function getJSON(p) {
  const r = await fetch(p);
  if (!r.ok) throw new Error(p + " -> " + r.status);
  return r.json();
}
function esc(s) {
  return String(s).replace(/[&<>"']/g, c => ({"&": "&amp;", "<": "&lt;",
    ">": "&gt;", '"': "&quot;", "'": "&#39;"}[c]));
}
function table(items) {
  if (!items || !items.length) return "<p style='margin:12px 16px'>(empty)</p>";
  const cols = [];  // union across rows: heterogeneous rows keep all fields
  for (const it of items)
    for (const k of Object.keys(it)) if (!cols.includes(k)) cols.push(k);
  let h = "<table><tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("") + "</tr>";
  for (const it of items.slice(0, 500)) {
    h += "<tr>" + cols.map(c => {
      let v = it[c];
      if (typeof v === "object" && v !== null) v = JSON.stringify(v);
      return `<td>${v === null || v === undefined ? "" : esc(v)}</td>`;
    }).join("") + "</tr>";
  }
  return h + "</table>";
}
function sparkline(points) {
  if (!points.length) return "";
  const vs = points.map(p => p[1]);
  const lo = Math.min(...vs), hi = Math.max(...vs);
  const span = hi - lo || 1;
  const w = 256, h = 36, n = points.length;
  const pts = points.map((p, i) => {
    const x = n === 1 ? w / 2 : (i / (n - 1)) * w;
    const y = h - 3 - ((p[1] - lo) / span) * (h - 6);
    return `${x.toFixed(1)},${y.toFixed(1)}`;
  }).join(" ");
  return `<svg viewBox="0 0 ${w} ${h}"><polyline points="${pts}"/></svg>`;
}
function fmtv(v) {
  if (!isFinite(v)) return String(v);
  if (Math.abs(v) >= 1e6 || (v !== 0 && Math.abs(v) < 1e-3))
    return v.toExponential(2);
  return Number.isInteger(v) ? String(v) : v.toFixed(3);
}
function sparks(items) {
  if (!items || !items.length)
    return "<p style='margin:12px 16px'>(no retained series yet)</p>";
  items = items.slice().sort((a, b) => a.name.localeCompare(b.name));
  let h = "<div class='sparks'>";
  for (const s of items.slice(0, 200)) {
    const tags = Object.entries(s.tags || {})
      .map(([k, v]) => `${k}=${v}`).join(",");
    const last = s.points.length ? s.points[s.points.length - 1][1] : null;
    h += `<div class="spark"><div class="t" title="${esc(s.name)}` +
         `${tags ? "{" + esc(tags) + "}" : ""}">${esc(s.name)}` +
         `${tags ? "{" + esc(tags) + "}" : ""}</div>` +
         `<div class="v">${last === null ? "" : esc(fmtv(last))}</div>` +
         sparkline(s.points) + `</div>`;
  }
  return h + "</div>";
}
async function render() {
  TABS.forEach(t => document.getElementById("tab-" + t)
    .classList.toggle("on", t === tab));
  const content = document.getElementById("content");
  const status = document.getElementById("status");
  try {
    const s = await getJSON("/api/status");
    document.getElementById("addr").textContent = s.address || "";
    status.innerHTML = ["nodes_alive","workers","actors_alive","tasks_running"]
      .map(k => `<div class="stat"><b>${s[k]}</b>${k.replace("_"," ")}</div>`)
      .join("") +
      Object.keys(s.resources_total || {}).sort().map(r => {
        const t = s.resources_total[r], a = (s.resources_available||{})[r] ?? t;
        const fmt = x => Number.isInteger(x) ? x : x.toExponential(2);
        return `<div class="stat"><b>${fmt(t - a)}/${fmt(t)}</b>${esc(r)} used</div>`;
      }).join("");
    if (tab === "status") { content.innerHTML = ""; return; }
    if (tab === "history") {
      const d = await getJSON("/api/metrics/history");
      content.innerHTML = sparks(d.items);
      return;
    }
    const d = await getJSON("/api/" + tab);
    content.innerHTML = table(d.items);
  } catch (e) {
    content.innerHTML = `<div class="err">${esc(e)}</div>`;
  }
}
render();
setInterval(render, 4000);
</script></body></html>"""


class Dashboard:
    """Threaded HTTP server bridging the state RPC plane to browsers."""

    def __init__(self, address: str, host: str = "127.0.0.1", port: int = 0):
        from .core.client import RpcClient

        h, p = address.rsplit(":", 1)
        self._rpc = RpcClient(h, int(p), name="dashboard")
        self._rpc_lock = threading.Lock()
        self._address = address
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                try:
                    dash._route(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface handler bugs as 500s
                    try:
                        self.send_error(500, str(e))
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- plumbing --------------------------------------------------------------

    def _call(self, method: str, body: dict) -> dict:
        with self._rpc_lock:
            return self._rpc.call(method, body, timeout=10.0)

    def _send(self, req, code: int, content_type: str, payload: bytes):
        req.send_response(code)
        req.send_header("Content-Type", content_type)
        req.send_header("Content-Length", str(len(payload)))
        req.end_headers()
        req.wfile.write(payload)

    def _send_json(self, req, obj, code: int = 200):
        self._send(req, code, "application/json",
                   json.dumps(obj, default=str).encode())

    # -- routes ----------------------------------------------------------------

    def _route(self, req):
        path = req.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/":
            return self._send(req, 200, "text/html; charset=utf-8",
                              _PAGE.encode())
        if path == "/metrics":
            from .util.metrics import prometheus_text

            rows = self._call("list_state", {"kind": "metrics"})["items"]
            return self._send(req, 200, "text/plain; version=0.0.4",
                              prometheus_text(rows).encode())
        if path == "/api/status":
            return self._send_json(req, self._status())
        if path == "/api/jobs":
            return self._send_json(req, {"items": self._jobs()})
        if path == "/api/summary":
            return self._send_json(req, {"items": self._summary()})
        if path == "/api/metrics/history":
            return self._send_json(
                req, self._call("list_state", {"kind": "metrics_history"})
            )
        if path == "/api/log":
            # Raw log content (?proc=<id>[&offset=N][&max_bytes=N]) —
            # routed head -> owning node, works for exited processes too.
            from urllib.parse import parse_qs

            q = parse_qs(req.path.split("?", 1)[1] if "?" in req.path else "")

            def qint(key, default):
                try:
                    return int(q.get(key, [default])[0])
                except (TypeError, ValueError):
                    return default

            reply = self._call("get_log", {
                "proc_id": (q.get("proc") or [""])[0],
                "offset": qint("offset", -65536),
                "max_bytes": qint("max_bytes", 65536),
            })
            if not reply.get("found"):
                return self._send_json(
                    req, {"error": reply.get("error", "log not found")},
                    code=404,
                )
            return self._send(req, 200, "text/plain; charset=utf-8",
                              bytes(reply.get("data") or b""))
        if path.startswith("/api/"):
            kind = path[len("/api/"):]
            if kind in _STATE_KINDS:
                return self._send_json(
                    req, self._call("list_state", {"kind": kind})
                )
        self._send_json(req, {"error": f"unknown path {path}"}, code=404)

    def _status(self) -> dict:
        nodes = self._call("list_state", {"kind": "nodes"})["items"]
        workers = self._call("list_state", {"kind": "workers"})["items"]
        actors = self._call("list_state", {"kind": "actors"})["items"]
        tasks = self._call("list_state", {"kind": "tasks"})["items"]
        total = self._call("cluster_resources", {})["resources"]
        avail = self._call("available_resources", {})["resources"]
        return {
            "address": self._address,
            "nodes_alive": sum(1 for n in nodes if n.get("alive")),
            "nodes_total": len(nodes),
            "workers": len(workers),
            "actors_alive": sum(1 for a in actors if a["state"] == "ALIVE"),
            "tasks_running": sum(1 for t in tasks if t.get("state") == "RUNNING"),
            "resources_total": total,
            "resources_available": avail,
        }

    def _jobs(self) -> list:
        def kv(key):
            raw = self._call("kv_get", {"key": key}).get("value")
            return raw.decode() if isinstance(raw, bytes) else raw

        reply = self._call("kv_keys", {"prefix": "job:"})
        items = []
        for key in sorted(reply.get("keys", [])):
            if not key.endswith(":status"):
                continue
            job_id = key.split(":")[1]
            items.append({
                "job_id": job_id,
                "status": kv(key),
                "entrypoint": kv(f"job:{job_id}:entrypoint"),
            })
        return items

    def _summary(self) -> list:
        items = self._call("list_state", {"kind": "tasks"})["items"]
        agg: dict = {}
        for t in items:
            key = (t.get("name", ""), t.get("state", ""))
            agg[key] = agg.get(key, 0) + 1
        return [
            {"name": k[0], "state": k[1], "count": v}
            for k, v in sorted(agg.items())
        ]

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "Dashboard":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dashboard", daemon=True
        )
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        try:
            self._rpc.close()
        except Exception:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
