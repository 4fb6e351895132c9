"""Scenarios of the runtime's libraries, run under either package, one
process each: compiled DAGs, workflows, the actor pool, queue and
multiprocessing utilities, the dashboard, job submission and the CLI.

``python tests/_torch_lib_scenarios.py --pkg ray_tpu_torch dag`` imports
the named package as ``rt``, runs the scenario (which starts and stops its
own cluster) and prints ``{name: result}`` as one JSON line; several names
run in one process (``_torch_serve_scenarios.run`` starts it, with
``--many``).  The tests (``tests/test_torch_dag.py``,
``_workflow.py``, ``_util.py``, ``_dashboard.py``, ``_cli.py``) run each
under ``ray_tpu`` and under ``ray_tpu_torch`` at once and compare the two
results, so every value a scenario returns under a shared key is one the
two packages must agree on: no pid, no clock, no port, no package name.
Keys that only one package can give (a torch tensor on an edge, the CLI's
refusals) are read by port-only tests.  The scenarios are those of
``tests/test_dag.py``, ``test_workflow.py``, ``test_util.py``,
``test_dashboard.py``, the job paths of ``test_observability.py`` and
``test_fault_tolerance.py`` and the CLI subcommands that
``test_observability.py``, ``test_flight_recorder.py`` and
``test_tracing.py`` drive.  Accelerator grants differ by name only, as in
``_torch_runtime_scenarios.py``.
"""

from __future__ import annotations

import argparse
import glob
import importlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import _torch_serve_scenarios as serve_sc
from _torch_runtime_scenarios import result
from _torch_serve_scenarios import _grant, _visible

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def _mod(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


def _ctx(rt):
    return _mod(rt, "core.context").ctx


def _address_env(rt) -> str:
    return "RT_TORCH_ADDRESS" if _port(rt) else "RT_ADDRESS"


def _error(fn):
    """``"<type>: <message>"`` of what ``fn()`` raises, or its value."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001: the error is the result
        return f"{type(e).__name__}: {e}"


def _child_env(extra_path: str = ""):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RT_ADDRESS", "RT_TORCH_ADDRESS")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (extra_path, root, env.get("PYTHONPATH", "")) if p)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


# ------------------------------------------------------------------ dag


@scenario
def dag(rt):
    """test_dag.py's seven tests in one cluster, then a torch tensor (the
    JAX package: a numpy array) crossing two edges, and a middle stage
    granted the one mocked card (``RT_GPUS=1`` / ``RT_TPU_CHIPS=1``)."""
    d = _mod(rt, "dag")
    pkg = rt.__name__
    out = {}

    tmp = tempfile.mkdtemp(prefix="dag_chan_")
    path = os.path.join(tmp, "chan")
    a = d.ShmChannel(path, capacity=1024, create=True)
    b = d.ShmChannel(path)
    seen = []
    for payload in (b"hello", b"again"):
        a.write_bytes(payload)  # the second proceeds: the slot was released
        view = b.read_bytes()
        seen.append(bytes(view).decode())
        view.release()
        b.done_reading()
    a.close_writer()
    seen.append(_error(lambda: bytes(b.read_bytes())))
    a.close(unlink=True)
    b.close()
    shutil.rmtree(tmp)
    out["channel"] = seen

    rt.init(num_cpus=4)
    enable = d.enable_compiled_dags

    @enable
    @rt.remote(max_concurrency=2)
    class Doubler:
        def apply(self, x):
            return x * 2

    @enable
    @rt.remote(max_concurrency=2)
    class AddOne:
        def apply(self, x):
            return x + 1

    import numpy as np

    with d.InputNode() as inp:
        out_node = AddOne.remote().apply.bind(Doubler.remote().apply.bind(inp))
    g = out_node.experimental_compile()
    try:
        first = g.execute(20)
        arr = np.arange(1000, dtype=np.float32)
        arr_ok = bool(np.allclose(g.execute(arr), arr * 2 + 1))
        t0 = time.perf_counter()
        ok = all(g.execute(i) == i * 2 + 1 for i in range(200))
        per_call = (time.perf_counter() - t0) / 200
    finally:
        g.teardown()
    out["pipeline"] = [first, arr_ok, ok, per_call < 0.05]

    @enable
    @rt.remote(max_concurrency=2)
    class Bomb:
        def apply(self, x):
            if x == 13:
                raise ValueError("unlucky")
            return x

    with d.InputNode() as inp:
        out_node = Bomb.remote().apply.bind(inp)
    g = out_node.experimental_compile()
    try:
        out["error"] = [g.execute(1), _error(lambda: g.execute(13)),
                        g.execute(2)]
    finally:
        g.teardown()

    @enable
    @rt.remote(max_concurrency=2)
    class Branch:
        def __init__(self, k):
            self.k = k

        def scale(self, x):
            return x * self.k

    @enable
    @rt.remote(max_concurrency=2)
    class Join:
        def add(self, a, b):
            return a + b

    with d.InputNode() as inp:
        out_node = Join.remote().add.bind(Branch.remote(10).scale.bind(inp),
                                          Branch.remote(100).scale.bind(inp))
    g = out_node.experimental_compile()
    try:
        out["diamond"] = [g.execute(i) for i in range(10)]
    finally:
        g.teardown()

    @enable
    @rt.remote(max_concurrency=2)
    class Op:
        def __init__(self, k):
            self.k = k

        def mul(self, x):
            return x * self.k

    with d.InputNode() as inp:
        x = Op.remote(2).mul.bind(inp)
        y = Op.remote(3).mul.bind(inp)
    g = d.MultiOutputNode([x, y]).experimental_compile()
    try:
        out["multi_output"] = [g.execute(5), g.execute(7)]
    finally:
        g.teardown()

    @enable
    @rt.remote(max_concurrency=2)
    class Stage:
        def work(self, x):
            time.sleep(0.2)
            return x + 1

    s1, s2, s3 = Stage.remote(), Stage.remote(), Stage.remote()
    with d.InputNode() as inp:
        out_node = s3.work.bind(s2.work.bind(s1.work.bind(inp)))
    g = out_node.experimental_compile()
    try:
        g.execute(0)  # warm the loops
        t0 = time.perf_counter()
        futs = [g.execute_async(i) for i in range(4)]
        results = [f.result() for f in futs]
        # Serial would be 4 x 3 x 0.2 = 2.4 s; pipelined ~ 6 x 0.2.
        out["overlapped"] = [results, time.perf_counter() - t0 < 2.0]
    finally:
        g.teardown()

    @enable
    @rt.remote(max_concurrency=2)
    class Bad:
        def boom(self, x):
            raise ValueError("branch failed")

    @enable
    @rt.remote(max_concurrency=2)
    class Ok:
        def ident(self, x):
            return x

        def join(self, a, b):
            return (a, b)

    bad, okay = Bad.remote(), Ok.remote()
    with d.InputNode() as inp:
        out_node = okay.join.bind(bad.boom.bind(inp), okay.ident.bind(inp))
    g = out_node.experimental_compile()
    try:
        out["diamond_error"] = [_error(lambda: g.execute(1)),
                                _error(lambda: g.execute(2))]
    finally:
        g.teardown()

    # encode -> middle -> collect, as the card's engine DAG: a list in, a
    # tensor (numpy array) on both inner edges, a list out; the middle
    # stage holds the one mocked card.
    @enable
    @rt.remote(max_concurrency=2)
    class Encode:
        def run(self, tokens):
            if pkg == "ray_tpu_torch":
                import torch

                return torch.tensor(tokens, dtype=torch.int64)
            return np.asarray(tokens, dtype=np.int64)

    @enable
    @rt.remote(max_concurrency=2)
    class Middle:
        def run(self, t):
            return [type(t).__module__.split(".")[0], str(t.dtype),
                    _visible(importlib.import_module(pkg)), t * 2 + 1]

    @enable
    @rt.remote(max_concurrency=2)
    class Collect:
        def run(self, rec):
            kind, dtype, visible, t = rec
            return [kind, dtype, visible, type(t).__module__.split(".")[0],
                    [int(v) for v in t.tolist()]]

    with d.InputNode() as inp:
        out_node = Collect.remote().run.bind(
            Middle.options(**_grant(rt, 1)).remote().run.bind(
                Encode.remote().run.bind(inp)))
    g = out_node.experimental_compile()
    try:
        got = [g.execute([1, 2, 3]), g.execute_async([7, 8]).result()]
    finally:
        g.teardown()
    out["tensor_edge"] = [r[4] for r in got]
    out["granted_stage"] = [r[2] for r in got]
    out["edge_types"] = [r[:2] + r[3:4] for r in got]
    rt.shutdown()
    return out


# -------------------------------------------------------------- workflow


@scenario
def workflow(rt):
    """test_workflow.py's tests but the head restart, in one cluster."""
    wf = _mod(rt, "workflow")
    store = tempfile.mkdtemp(prefix="wf_store_")
    out = {}
    rt.init(num_cpus=4)

    def load(x):
        return list(range(x))

    def double(xs):
        return [v * 2 for v in xs]

    def total(xs, offset=0):
        return sum(xs) + offset

    c = wf.step(total)(wf.step(double)(wf.step(load)(10)), offset=5)
    out["chain"] = wf.run(c, workflow_id="chain", storage=store)

    marker = os.path.join(store, "ran_first")
    trip = os.path.join(store, "trip")

    def first(x):
        with open(marker, "a") as f:  # steps run in workers
            f.write("x")
        return x + 1

    def flaky(x):
        if not os.path.exists(trip):
            open(trip, "w").write("tripped")
            raise RuntimeError("transient failure")
        return x * 10

    b = wf.step(flaky)(wf.step(first)(1))
    failed = _error(lambda: wf.run(b, workflow_id="resume", storage=store))
    ran_once = open(marker).read()
    resumed = wf.run(b, workflow_id="resume", storage=store)
    listed = "resume" in wf.list_workflows(storage=store)
    wf.delete("resume", storage=store)
    out["resume"] = ["transient failure" in failed, ran_once, resumed,
                     open(marker).read(), listed,
                     "resume" in wf.list_workflows(storage=store)]

    def slow(x):
        time.sleep(0.3)
        return x * 3

    run = wf.run_async(wf.step(slow)(7), workflow_id="async", storage=store)
    out["run_async"] = run.result(timeout=60)

    def slow_shard(i):
        time.sleep(1.5)
        return i

    def merge(*parts):
        return sum(parts)

    node = wf.step(merge)(*[wf.step(slow_shard)(i) for i in range(4)])
    t0 = time.time()
    value = wf.run(node, workflow_id="par", storage=store)
    # Serialized, the four 1.5-s sleeps alone take 6 s.
    out["parallel"] = [value, time.time() - t0 < 6.0]

    def child(i):
        return i * i

    def gather(*vals):
        return sorted(vals)

    def fan_out(k):
        return wf.step(gather)(*[wf.step(child)(i) for i in range(k)])

    value = wf.run(wf.step(fan_out)(5), workflow_id="dyn", storage=store)
    files = os.listdir(os.path.join(store, "dyn"))
    kids = [f for f in files if "child" in f]
    out["dynamic"] = [value, len(kids),
                      any("." in f.replace(".pkl", "") for f in kids)]

    ctx = _ctx(rt)

    def after(ev, prefix):
        return prefix + ev.decode()

    done = wf.step(after)(wf.kv_event("wf-ev-key", poll_interval_s=0.05),
                          "got:")

    def fire():
        time.sleep(1.0)
        ctx.client.kv_put("wf-ev-key", b"payload")

    threading.Thread(target=fire, daemon=True).start()
    t0 = time.time()
    value = wf.run(done, workflow_id="ev1", storage=store)
    blocked = time.time() - t0 >= 0.9
    ctx.client.kv_del("wf-ev-key")  # the event was checkpointed
    out["event"] = [value, blocked,
                    wf.run(done, workflow_id="ev1", storage=store)]

    ev = wf.wait_for_event(lambda: None, poll_interval_s=0.05,
                           timeout_s=0.5)
    msg = _error(lambda: wf.run(ev, workflow_id="ev-to", storage=store))
    out["event_timeout"] = [msg.split(":")[0], "no event" in msg]
    rt.shutdown()
    shutil.rmtree(store, ignore_errors=True)
    return out


_RESTART_DRIVER = """
import sys, time
import {pkg} as rt
from {pkg} import workflow
from {pkg}.job_submission import JobSubmissionClient
rt.init(num_cpus=2, system_config={{"head_state_path": {state!r}}})
JobSubmissionClient().submit_job(
    entrypoint="python -c 'print(42)'", job_id="kill9-job")

def pre():
    print("PRE-RAN", flush=True)
    return "pre"

def after(p, ev):
    return p + ":" + ev.decode()

node = workflow.step(after)(
    workflow.step(pre)(), workflow.kv_event("restart-ev"))
print("READY", flush=True)
workflow.run(node, workflow_id="surv", storage={wf_store!r})
"""


@scenario
def restart(rt):
    """test_workflow.py's head restart, with test_fault_tolerance.py's job
    row: a driver submits a job and blocks a workflow on a KV event; the
    head (the driver's process) is SIGKILLed; a head restarted from the
    durable snapshot still has the job's rows, and once the event fires a
    resumed run completes, its pre-event step from its checkpoint."""
    tmp = tempfile.mkdtemp(prefix="wf_restart_")
    state = os.path.join(tmp, "head.state")
    wf_store = os.path.join(tmp, "wf")
    proc = subprocess.Popen(
        [sys.executable, "-c", _RESTART_DRIVER.format(
            pkg=rt.__name__, state=state, wf_store=wf_store)],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ready = False
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if "READY" in line:
            ready = True
            break
        if line == "" and proc.poll() is not None:
            raise RuntimeError(proc.stderr.read())
    if not ready:
        proc.kill()
        raise RuntimeError("the restart driver never became ready")
    time.sleep(2.5)  # pre()'s checkpoint lands; the event step polls
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    time.sleep(2)

    wf = _mod(rt, "workflow")
    rt.init(num_cpus=2, system_config={"head_state_path": state})
    try:
        ctx = _ctx(rt)
        jc = _mod(rt, "job_submission").JobSubmissionClient()
        out = {"job_row": [
            jc.get_job_status("kill9-job") in (
                "PENDING", "RUNNING", "SUCCEEDED", "FAILED"),
            ctx.client.kv_get("job:kill9-job:entrypoint").decode()]}
        ctx.client.kv_put("restart-ev", b"late")  # the event fires

        def pre():
            raise AssertionError("pre must resume from its checkpoint")

        pre.__name__ = "pre"
        value = wf.run(
            wf.step(lambda p, ev: p + ":" + ev.decode())(
                wf.step(pre)(), wf.kv_event("restart-ev")),
            workflow_id="surv", storage=wf_store)
        out["resume"] = [value, any(
            "pre" in f for f in os.listdir(os.path.join(wf_store, "surv")))]
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ------------------------------------------------------------------ util


@scenario
def util(rt):
    """test_util.py's seven tests in one cluster."""
    u = _mod(rt, "util")
    mp = _mod(rt, "util.multiprocessing")
    out = {}
    rt.init(num_cpus=6)

    @rt.remote
    class Doubler:
        def __init__(self):
            self.pid = os.getpid()

        def work(self, x, delay=0.0):
            time.sleep(delay)
            return x * 2

        def whoami(self, x):
            return self.pid

    pool = u.ActorPool([Doubler.remote() for _ in range(3)])
    ordered = list(pool.map(
        lambda a, v: a.work.remote(v, delay=0.3 if v == 0 else 0.0),
        range(6)))
    unordered = list(pool.map_unordered(
        lambda a, v: a.work.remote(v, delay=0.5 if v == 0 else 0.0),
        range(4)))
    pids = set(pool.map(lambda a, v: a.whoami.remote(v), range(9)))
    out["pool_map"] = [ordered, sorted(unordered), unordered[-1],
                       len(pids) >= 2]

    pool = u.ActorPool([Doubler.remote() for _ in range(2)])
    seq = [pool.has_free()]
    pool.submit(lambda a, v: a.work.remote(v), 10)
    pool.submit(lambda a, v: a.work.remote(v), 11)
    seq += [pool.has_free(), pool.has_next(), pool.get_next(timeout=30),
            pool.get_next(timeout=30), pool.has_next(),
            _error(pool.get_next).split(":")[0]]
    out["pool_submit"] = seq

    q = u.Queue(maxsize=2)
    q.put(1)
    q.put(2)
    seq = [q.full(), q.qsize(), _error(lambda: q.put_nowait(3)),
           q.get(), q.get(), q.empty(), _error(q.get_nowait),
           _error(lambda: q.get(timeout=0.2))]
    got = []
    t = threading.Thread(target=lambda: got.append(q.get(timeout=10)),
                         daemon=True)
    t.start()
    time.sleep(0.3)
    q.put("late")
    t.join(timeout=10)
    q2 = u.Queue(maxsize=3)
    seq += [got, _error(lambda: q2.put_nowait_batch([1, 2, 3, 4])),
            q2.get_nowait_batch(10)]
    q2.shutdown()
    q.shutdown()
    out["queue"] = seq

    q = u.Queue(maxsize=1)
    q.put("only")
    t0 = time.monotonic()
    full = _error(lambda: q.put("spill", timeout=0.5))
    waited = 0.4 <= time.monotonic() - t0 < 10
    seq = [full, waited, q.qsize(), q.get_nowait(), _error(q.get_nowait)]
    q.put("a")
    done = []
    t = threading.Thread(target=lambda: done.append(q.put("b", timeout=10)),
                         daemon=True)
    t.start()
    time.sleep(0.3)
    seq.append(q.get(timeout=5))
    t.join(timeout=10)
    seq += [t.is_alive(), q.get(timeout=5)]
    q.shutdown()
    out["queue_timed_put"] = seq

    q = u.Queue(maxsize=16)

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i)
        return n

    @rt.remote
    def consumer(q, n):
        return sorted(q.get(timeout=30) for _ in range(n))

    p, c = producer.remote(q, 8), consumer.remote(q, 8)
    out["queue_shared"] = [rt.get(c, timeout=60), rt.get(p, timeout=60)]
    q.shutdown()

    pool = u.ActorPool([Doubler.remote() for _ in range(2)])
    pool.submit(lambda a, v: a.work.remote(v), 0)
    pool.submit(lambda a, v: a.work.remote(v), 1)
    first = pool.get_next_unordered(timeout=30)
    has = pool.has_next()
    second = pool.get_next(timeout=30)
    out["pool_mixed"] = [first in (0, 2), has, sorted([first, second]),
                         pool.has_next(),
                         list(pool.map(lambda a, v: a.work.remote(v),
                                       [5, 6]))]

    def square(x):
        return x * x

    def add(a, b, offset=0):
        return a + b + offset

    with mp.Pool(processes=4) as mpool:
        seq = [mpool.map(square, range(10)),
               mpool.starmap(add, [(1, 2), (3, 4)]),
               mpool.apply(add, (5, 6), {"offset": 100})]
        ar = mpool.map_async(square, range(6), chunksize=2)
        ar.wait(timeout=60)
        seq += [ar.ready(), ar.successful(), ar.get(timeout=30),
                list(mpool.imap(square, range(8), chunksize=3)),
                sorted(mpool.imap_unordered(square, range(8)))]
    seq.append(_error(lambda: mpool.map(square, [1])))
    out["multiprocessing"] = seq
    rt.shutdown()
    return out


# ------------------------------------------------------- dashboard, jobs


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@scenario
def dashboard(rt):
    """test_dashboard.py's five tests through ``init(include_dashboard=
    True)``, then test_observability.py's two jobs, listed by
    ``/api/jobs``."""
    rt.init(num_cpus=4, include_dashboard=True)
    dash = _ctx(rt).dashboard
    out = {}

    @rt.remote
    def work(x):
        return x * 2

    value = rt.get(work.remote(21))
    s = json.loads(_get(dash.url + "/api/status")[1])
    out["status"] = [value, s["nodes_alive"], s["resources_total"]["CPU"]]

    @rt.remote
    class Counter:
        def ping(self):
            return 1

    c = Counter.remote()
    value = rt.get(c.ping.remote())
    eps = {}
    for ep in ("nodes", "actors", "tasks", "workers", "objects",
               "placement_groups", "metrics", "timeline", "traces"):
        code, body = _get(f"{dash.url}/api/{ep}")
        eps[ep] = [code, "items" in json.loads(body)]
    actors = json.loads(_get(dash.url + "/api/actors")[1])["items"]
    summary = json.loads(_get(dash.url + "/api/summary")[1])["items"]
    out["state_endpoints"] = [value, eps, any(
        a["class_name"] == "Counter" for a in actors), any(
        r["name"] == "Counter.ping" or r["count"] >= 1 for r in summary)]

    code, body = _get(dash.url + "/")
    out["html"] = [code, f"{rt.__name__} dashboard".encode() in body,
                   _get(dash.url + "/metrics")[0]]

    @rt.remote
    def tick(x):
        return x

    value = rt.get(tick.remote(1))
    code, body = _get(dash.url + "/metrics")
    text = body.decode()
    name = "ray_tpu_scheduler_submit_to_start_seconds"
    prom = [code, f"# TYPE {name} histogram" in text,
            f'{name}_bucket{{le="+Inf"}}' in text, f"{name}_count" in text]
    history = False
    deadline = time.time() + 20
    while time.time() < deadline and not history:
        items = json.loads(_get(dash.url + "/api/metrics/history")[1])[
            "items"]
        builtin = [s for s in items if s["name"].startswith("ray_tpu_")
                   and len(s["points"]) >= 2]
        if builtin:
            ts = [p[0] for p in builtin[0]["points"]]
            history = ts == sorted(ts) and ts[0] > 0
        else:
            time.sleep(0.3)
    out["metrics_history"] = [value, prom, history]
    out["unknown_path"] = _get(dash.url + "/api/nope")[0]

    js = _mod(rt, "job_submission")
    client = js.JobSubmissionClient()
    ok = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('job ran ok'); "
                   f"print(6*7)\"")
    status = client.wait_until_finished(ok, timeout=120)
    logs = client.get_job_logs(ok)
    bad = client.submit_job(entrypoint=f"{sys.executable} -c 'exit(3)'")
    failed = client.wait_until_finished(bad, timeout=120)
    jobs = json.loads(_get(dash.url + "/api/jobs")[1])["items"]
    out["jobs"] = [status, "job ran ok" in logs and "42" in logs,
                   any(j["job_id"] == ok for j in client.list_jobs()),
                   failed, sorted(j["status"] for j in jobs
                          if j["job_id"] in (ok, bad)),
                   [j["entrypoint"] for j in jobs if j["job_id"] == ok]
                   == [f"{sys.executable} -c \"print('job ran ok'); "
                       f"print(6*7)\""]]
    rt.shutdown()
    out["stopped"] = _error(lambda: _get(dash.url + "/api/status")[0])[:3]
    return out


# ------------------------------------------------------------------- cli


def _seed_trace(tracing, t0):
    """test_tracing.py's three-stage tree."""
    tid = tracing.new_id()
    root_id, task_id, sub_id = (tracing.new_id() for _ in range(3))
    pre_id, dec_id = tracing.new_id(), tracing.new_id()
    spans = [
        {"kind": "span", "trace_id": tid, "span_id": root_id,
         "parent_id": None, "name": "ingress:app", "start": t0,
         "end": t0 + 1.0, "pid": 1},
        {"kind": "span", "trace_id": tid, "span_id": sub_id,
         "parent_id": root_id, "name": "submit:work", "start": t0 + 0.01,
         "end": t0 + 0.01, "pid": 1, "attrs": {"flow_id": task_id}},
        {"kind": "span", "trace_id": tid, "span_id": task_id,
         "parent_id": root_id, "name": "task:work", "start": t0 + 0.40,
         "end": t0 + 0.95, "pid": 2},
        {"kind": "span", "trace_id": tid, "span_id": pre_id,
         "parent_id": task_id, "name": "engine:prefill",
         "start": t0 + 0.45, "end": t0 + 0.60, "pid": 2,
         "attrs": {"bucket": 16}},
        {"kind": "span", "trace_id": tid, "span_id": dec_id,
         "parent_id": task_id, "name": "engine:decode",
         "start": t0 + 0.60, "end": t0 + 0.94, "pid": 2,
         "attrs": {"tokens": 4}},
    ]
    return tid, spans


_SERVE_APP = """import {pkg}.serve as serve

@serve.deployment
class Greeter:
    def __init__(self, greeting="hello"):
        self.greeting = greeting

    def __call__(self, who):
        return f"{{self.greeting}}, {{who}}"
"""


@scenario
def cli(rt):
    """``python -m <package>`` against a live cluster: the subcommands of
    test_observability.py (list, status, summary, metrics, timeline,
    events, logs, stack, down), test_flight_recorder.py (engine steps,
    status and top over step records, profile, logs --post-mortem) and
    test_tracing.py (trace), then ``serve deploy`` of a JSON and a YAML
    file, ``lint`` and ``--help``."""
    pkg = rt.__name__
    rt.init(num_cpus=4)
    ctx = _ctx(rt)
    addr = os.environ[_address_env(rt)]
    tmp = tempfile.mkdtemp(prefix="cli_")

    def cli_run(*argv, timeout=120, extra_path=""):
        p = subprocess.run(
            [sys.executable, "-m", pkg, "--address", addr, *argv],
            capture_output=True, text=True, env=_child_env(extra_path),
            timeout=timeout)
        return p.returncode, p.stdout, p.stderr

    def has(argv, *needles):
        """[returncode, each needle in stdout]."""
        rc, so, _ = cli_run(*argv)
        return [rc] + [n in so for n in needles]

    out = {}

    @rt.remote
    class Keeper:
        def ping(self):
            return "ok"

    k = Keeper.options(name="cli-keeper").remote()
    rt.get(k.ping.remote())
    out["state"] = {
        "list_actors": has(["list", "actors"], "Keeper", "cli-keeper"),
        "status": has(["status"], "nodes: 1 alive"),
        "summary": has(["summary"], "COUNT", "ping"),
        "metrics": [cli_run("metrics")[0]],
        "timeline": has(["timeline"], "task_submitted"),
        "list_pgs": has(["list", "pgs"], "no placement_groups"),
        "events": has(["events"], "Keeper.ping", "FINISHED"),
        "events_errors": has(["events", "--errors"], "no task events"),
        "events_task": has(["events", "--task", "ffffffff"],
                           "no task events"),
        "logs": has(["logs"], "PROC_ID", "worker"),
    }
    workers = ctx.client.call("list_state", {"kind": "workers"})["items"]
    actor_wid = [w for w in workers if w["state"] == "actor"][0]["worker_id"]
    out["stack"] = has(["stack", actor_wid], "Thread", "threads=")

    @rt.remote
    class Doomed:
        def scribble(self):
            print("POSTMORTEM-STDOUT-LINE")
            print("POSTMORTEM-STDERR-LINE", file=sys.stderr)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)

    dm = Doomed.remote()
    died = _error(lambda: rt.get(dm.scribble.remote(), timeout=60))
    entry = None
    deadline = time.time() + 20
    while time.time() < deadline and entry is None:
        entries = ctx.client.call("list_state", {"kind": "logs"})["items"]
        dead = [e for e in entries if e.get("actor_id") == dm._actor_id.hex()
                and not e["alive"]]
        entry = dead[0] if dead else None
        time.sleep(0.1)
    out["dead_log"] = [isinstance(died, str), entry is not None] + (
        has(["logs", entry["proc_id"]], "POSTMORTEM-STDOUT-LINE",
            "POSTMORTEM-STDERR-LINE") if entry else [])

    # Step records from this driver reach the head; list, status, top.
    steprec = _mod(rt, "util.steprec")
    eid = f"{os.getpid()}.77"
    steprec.drain_buffered()
    for i in range(5):
        steprec.record_step({
            "t": float(i), "engine": eid, "step": i, "wall_s": 0.01,
            "stall_s": 0.0, "occupancy": 2, "slots": 4, "admitted": 1,
            "evicted": 0, "shed": 0, "queued": 0, "pages_used": 3,
            "pages_free": 13, "pages_shared": 0, "prefix_hits": 0,
            "adapter_pins": 0, "tenants": {"default": 2}})
    flushed = steprec.flush_steps(ctx.client)
    deadline = time.time() + 20  # the flush lands at the head
    while time.time() < deadline and not ctx.client.call(
            "list_state", {"kind": "engine_steps", "engine": eid})["items"]:
        time.sleep(0.2)
    listed = has(["list", "engine_steps"], eid)
    status = has(["status"], f"engine {eid}", "stall")
    rc, so, _ = cli_run("top", "--once")
    out["engine_steps"] = [flushed, listed, status,
                           [rc, f"{pkg} top" in so, eid in so, "2/4" in so]]

    # profile: a CPU worker's capture (the JAX package's touches JAX on
    # the CPU; the port's worker holds no card, so it traces its host).
    @rt.remote
    class Burner:
        def warm(self):
            if pkg == "ray_tpu_torch":
                import torch

                return int(torch.arange(4.0).sum())
            import jax.numpy as jnp

            return int(jnp.arange(4.0).sum())

        def spin(self, seconds):
            deadline = time.time() + seconds
            if pkg == "ray_tpu_torch":
                import torch

                x = torch.arange(1.0, 1025.0)
                while time.time() < deadline:
                    x = x * 1.0001
                return float(x[0])
            import jax.numpy as jnp

            x = jnp.arange(1.0, 1025.0)
            while time.time() < deadline:
                x = (x * 1.0001).block_until_ready()
            return float(x[0])

    burner = Burner.remote()
    warm = rt.get(burner.warm.remote(), timeout=120)
    workers = ctx.client.call("list_state", {"kind": "workers"})["items"]
    known = {w["worker_id"] for w in workers if w["state"] == "actor"}
    info = ctx.client.call("list_state", {"kind": "actors"})["items"]
    bpid = [a.get("pid") for a in info
            if a["actor_id"] == burner._actor_id.hex()][0]
    wid = [w["worker_id"] for w in workers
           if w["state"] == "actor" and w.get("pid") == bpid][0]
    spin = burner.spin.remote(4.0)  # work during the capture
    logdir = os.path.join(tmp, "tb")
    rc, so, se = cli_run("profile", wid, "--seconds", "1.5", "--logdir",
                         logdir)
    files = glob.glob(f"{logdir}/**/*", recursive=True)
    traces = [f for f in files if f.endswith(".pt.trace.json")] if _port(
        rt) else glob.glob(f"{logdir}/**/plugins/profile/**/*",
                           recursive=True)
    unknown = cli_run("profile", "ffffffff", "--seconds", "0.5")
    out["profile"] = [warm, wid in known, rc, f"trace dir: {logdir}" in so,
                      "tensorboard --logdir" in so, bool(traces),
                      rt.get(spin, timeout=60) > 0, unknown[0],
                      bool(unknown[2].strip())]
    if _port(rt) and traces:
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        out["profile_trace"] = [rc, len(events) > 0]

    # The black box of a SIGKILLed worker through logs --post-mortem.
    @rt.remote
    class Boxed:
        def record(self):
            sr = importlib.import_module(pkg + ".util.steprec")
            for i in range(6):
                sr.record_step({
                    "engine": f"{os.getpid()}.0", "step": i, "t": float(i),
                    "wall_s": 0.01, "stall_s": 0.0,
                    "sentinel": "BLACKBOX-SENTINEL-93251"})
            assert sr.dump_black_box(force=True)
            return sr.black_box_path(), os.getpid()

    box_path, pid = rt.get(Boxed.remote().record.remote(), timeout=120)
    os.kill(pid, signal.SIGKILL)
    deadline = time.time() + 20
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
            time.sleep(0.1)
        except OSError:
            break
    out["post_mortem"] = [box_path.endswith(".steps.log"),
                          os.path.exists(box_path)] + has(
        ["logs", "--post-mortem"], "BLACKBOX-SENTINEL-93251", ".steps.log")

    tracing = _mod(rt, "util.tracing")
    tid, spans = _seed_trace(tracing, time.time())
    ctx.client.call("span_batch", {"spans": spans})
    rc, so, _ = cli_run("trace", tid, "--chrome")
    events = json.loads(so) if rc == 0 else []
    out["trace"] = [
        has(["trace"], tid[:16], "ingress:app"),
        has(["trace", tid[:12]], "critical path:", "stage breakdown:",
            "engine:prefill", "schedule"),
        [rc, sum(1 for e in events if e["ph"] == "X"),
         sum(1 for e in events if e["ph"] in ("s", "f"))],
        cli_run("trace", "feedfacedeadbeef")[0]]

    # serve deploy from a file, then the apps through the driver.
    serve = _mod(rt, "serve")
    with open(os.path.join(tmp, "cli_serve_app.py"), "w") as f:
        f.write(_SERVE_APP.format(pkg=pkg))
    cfg = {"applications": [{
        "name": "greet", "import_path": "cli_serve_app:Greeter",
        "args": {"greeting": "hey"},
        "deployments": [{"name": "Greeter", "num_replicas": 1}]}]}
    deploys = {}
    for kind in ("json", "yaml"):
        path = os.path.join(tmp, f"serve.{kind}")
        app = dict(cfg["applications"][0], name=f"greet_{kind}")
        with open(path, "w") as f:
            if kind == "json":
                json.dump({"applications": [app]}, f)
            else:
                import yaml

                yaml.safe_dump({"applications": [app]}, f)
        rc, so, se = cli_run("serve", "deploy", path, extra_path=tmp)
        deploys[kind] = [rc, "deployed 1 application(s)" in so,
                         f"greet_{kind}: 1/1 replicas" in so]
    sys.path.insert(0, tmp)
    calls = [serve.get_deployment_handle(f"greet_{kind}").remote("you").result()
             for kind in ("json", "yaml")]
    rc, so, _ = cli_run("serve", "status", extra_path=tmp)
    status = [rc, "greet_json" in so, "greet_yaml" in so]
    out["serve_deploy"] = [deploys, calls, status,
                           has(["serve", "shutdown"], "serve shut down")]

    rc, so, se = cli_run("lint")
    out["lint"] = [rc, se.strip()]
    helps = subprocess.run([sys.executable, "-m", pkg, "--help"],
                           capture_output=True, text=True,
                           env=_child_env(), timeout=120)
    out["help"] = [helps.returncode, helps.stdout.split("{", 1)[1].split(
        "}", 1)[0].split(",") if "{" in helps.stdout else helps.stdout]

    rc, so, se = cli_run("down")
    host, port = addr.rsplit(":", 1)
    closed = False
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and not closed:
        try:
            socket.create_connection((host, int(port)), timeout=1).close()
            time.sleep(0.2)
        except OSError:
            closed = True
    out["down"] = [rc, "shutdown requested" in so, closed]
    try:
        rt.shutdown()
    except Exception:  # noqa: BLE001: the head went down under it
        pass
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# ----------------------------------------------------------------- runner


def run_pair(names, jax_env=None, port_env=None, timeout: float = 400.0):
    """The scenarios ``names`` under both packages at once (two clusters on
    one host), one process a package: ``(ray_tpu results, ray_tpu_torch
    results)``, each ``{name: result}``."""
    jp = serve_sc.run(list(names), "ray_tpu", jax_env, script=__file__)
    tp = serve_sc.run(list(names), "ray_tpu_torch", port_env,
                      script=__file__)
    return result(jp, timeout), result(tp, timeout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", required=True, choices=("ray_tpu",
                                                     "ray_tpu_torch"))
    ap.add_argument("--many", action="store_true",
                    help="print {name: result}, which it always does")
    ap.add_argument("names", nargs="+", choices=sorted(SCENARIOS))
    args = ap.parse_args(argv)
    rt = importlib.import_module(args.pkg)
    out = {name: SCENARIOS[name](rt) for name in args.names}
    print("SCENARIO_RESULT " + json.dumps(out, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
