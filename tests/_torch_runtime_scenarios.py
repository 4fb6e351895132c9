"""Runtime scenarios run under either package, one process each.

``python tests/_torch_runtime_scenarios.py --pkg ray_tpu_torch tasks``
imports the named package as ``rt``, runs the scenario (which starts and
stops its own cluster) and prints its result as one JSON line.  The tests
(``tests/test_torch_runtime*.py``) run each scenario under ``ray_tpu`` and
under ``ray_tpu_torch`` and compare the two results, so every value a
scenario returns is one the two runtimes must agree on: no pid, no clock,
no package name.  Accelerator grants differ by name only: the JAX package
grants TPU chips (``num_tpus``, ``TPU_VISIBLE_CHIPS``, mocked by
``RT_TPU_CHIPS``) where the port grants GPUs (``num_gpus``,
``CUDA_VISIBLE_DEVICES``, mocked by ``RT_GPUS``).
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import os
import shutil
import signal
import sys
import tempfile
import time

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def _list_state(rt, kind: str):
    from importlib import import_module

    ctx = import_module(rt.__name__ + ".core.context").ctx
    return ctx.client.call("list_state", {"kind": kind})


# ---------------------------------------------------------------- tasks


@scenario
def tasks(rt):
    rt.init(num_cpus=2)

    @rt.remote
    def sq(x):
        return x * x

    @rt.remote
    def slow(t):
        time.sleep(t)
        return t

    @rt.remote(num_returns=3)
    def three():
        return 1, "b", [3]

    @rt.remote
    def outer(n):
        return sum(rt.get([sq.remote(i) for i in range(n)]))

    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote
    def deref(lst):
        return rt.get(lst[0]) + 1

    out = {"fan_out": rt.get([sq.remote(i) for i in range(24)])}
    refs = [slow.remote(0.0), slow.remote(3.0)]
    ready, pending = rt.wait(refs, num_returns=2, timeout=1.0)
    out["wait_timeout"] = [len(ready), len(pending), rt.get(ready)]
    ready, pending = rt.wait(refs, num_returns=2, timeout=30.0)
    out["wait_all"] = [len(ready), len(pending)]
    try:
        rt.get(slow.remote(3.0), timeout=0.3)
        out["get_timeout"] = "returned"
    except Exception as e:  # noqa: BLE001
        out["get_timeout"] = type(e).__name__
    out["num_returns"] = rt.get(list(three.remote()))
    out["nested"] = rt.get(outer.remote(6))
    ten = rt.put(10)
    out["ref_args"] = rt.get(add.remote(ten, sq.remote(3)))
    out["nested_ref"] = rt.get(deref.remote([ten]))
    rt.shutdown()
    return out


@scenario
def shm(rt):
    import numpy as np

    rt.init(num_cpus=2)

    @rt.remote
    def scale(a, k):
        return a * k

    a = np.arange(40_000, dtype=np.float64)  # 320 KB: the shm path
    ref = rt.put(a)
    got = rt.get(ref)
    doubled = rt.get(scale.remote(ref, 2.0))
    passed = rt.get(scale.remote(a, 3.0))
    out = {
        "put_get": [got.dtype.str, list(got.shape), float(got.sum()),
                    bool(got.flags.writeable)],
        "by_ref": [doubled.dtype.str, float(doubled[-1]),
                   float(doubled.sum())],
        "by_value": [float(passed[-1]), float(passed.sum())],
    }
    rt.shutdown()
    return out


# --------------------------------------------------------------- actors


@scenario
def actors(rt):
    rt.init(num_cpus=2)

    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

        def pid(self):
            return os.getpid()

    @rt.remote
    class Doubler:
        async def work(self, x):
            await asyncio.sleep(0.02)
            return 2 * x

    out = {}
    c = Counter.remote(5)
    out["state"] = rt.get([c.inc.remote() for _ in range(3)]
                          + [c.inc.remote(10)])
    named = Counter.options(name="ctr").remote(0)
    rt.get(named.inc.remote())
    out["named"] = [rt.get(rt.get_actor("ctr").inc.remote(4)),
                    sorted(rt.list_named_actors())]
    rt.kill(c)
    try:
        rt.get(c.inc.remote(), timeout=20)
        out["kill"] = "returned"
    except Exception as e:  # noqa: BLE001
        out["kill"] = type(e).__name__
    r = Counter.options(max_restarts=1, max_task_retries=2).remote(0)
    pid = rt.get(r.pid.remote())
    rt.get(r.inc.remote(3))
    os.kill(pid, signal.SIGKILL)
    deadline = time.time() + 30
    new_pid = pid
    while time.time() < deadline and new_pid == pid:
        try:
            new_pid = rt.get(r.pid.remote(), timeout=10)
        except Exception:  # noqa: BLE001
            time.sleep(0.2)
    out["max_restarts"] = [new_pid != pid, rt.get(r.inc.remote())]
    d = Doubler.remote()
    out["async"] = rt.get([d.work.remote(i) for i in range(6)])
    rt.shutdown()
    return out


@scenario
def errors(rt):
    rt.init(num_cpus=2)

    @rt.remote
    def boom(x):
        raise ValueError(f"bad value {x}")

    @rt.remote
    class Fragile:
        def fail(self):
            raise KeyError("missing")

        def ok(self):
            return "ok"

        def die(self):
            os._exit(1)

    out = {}
    try:
        rt.get(boom.remote(42))
    except Exception as e:  # noqa: BLE001
        out["task_error"] = [type(e).__name__, isinstance(e, ValueError),
                             "bad value 42" in str(e)]
    f = Fragile.remote()
    try:
        rt.get(f.fail.remote())
    except Exception as e:  # noqa: BLE001
        out["actor_error"] = [type(e).__name__, isinstance(e, KeyError),
                              "missing" in str(e), rt.get(f.ok.remote())]
    f.die.remote()
    try:
        rt.get(f.ok.remote(), timeout=20)
        out["actor_died"] = "returned"
    except Exception as e:  # noqa: BLE001
        out["actor_died"] = [type(e).__name__,
                             isinstance(e, rt.exceptions.ActorDiedError)]
    rt.shutdown()
    return out


@scenario
def retries(rt):
    rt.init(num_cpus=2)
    d = tempfile.mkdtemp()

    @rt.remote(max_retries=2)
    def attempt(path):
        with open(os.path.join(path, f"{os.getpid()}"), "w"):
            pass
        time.sleep(1.5 if len(os.listdir(path)) == 1 else 0.0)
        return len(os.listdir(path))

    @rt.remote(max_retries=0)
    def once(path):
        with open(os.path.join(path, "once"), "w") as f:
            f.write(str(os.getpid()))
        time.sleep(30)

    def kill_first(path, name=None):
        deadline = time.time() + 20
        while time.time() < deadline:
            names = os.listdir(path)
            if names:
                pid = (int(open(os.path.join(path, name)).read())
                       if name else int(names[0]))
                os.kill(pid, signal.SIGKILL)
                return
            time.sleep(0.02)

    ref = attempt.remote(d)
    kill_first(d)
    out = {"retried": rt.get(ref, timeout=60)}
    d2 = tempfile.mkdtemp()
    ref = once.remote(d2)
    deadline = time.time() + 20
    while time.time() < deadline and not os.path.exists(
            os.path.join(d2, "once")):
        time.sleep(0.02)
    time.sleep(0.1)
    kill_first(d2, "once")
    try:
        rt.get(ref, timeout=60)
        out["no_retry"] = "returned"
    except Exception as e:  # noqa: BLE001
        out["no_retry"] = type(e).__name__
    rt.shutdown()
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(d2, ignore_errors=True)
    return out


@scenario
def placement(rt):
    rt.init(num_cpus=4)
    pg = rt.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ok = pg.ready(timeout=30)

    @rt.remote(num_cpus=1)
    def where(i):
        return i

    strat = rt.PlacementGroupSchedulingStrategy(pg, 1)
    got = rt.get([where.options(scheduling_strategy=strat).remote(i)
                  for i in range(4)])
    avail = rt.available_resources().get("CPU")
    rt.remove_placement_group(pg)
    time.sleep(0.5)
    out = {"pg": [ok, got, avail, rt.available_resources().get("CPU")]}
    rt.shutdown()
    return out


@scenario
def spill(rt):
    import numpy as np

    rt.init(num_cpus=2, object_store_memory=3 * 1024 * 1024)
    refs = [rt.put(np.full(1 << 17, i, dtype=np.float64))  # 1 MiB each
            for i in range(8)]
    firsts = [float(rt.get(r)[0]) for r in refs]
    again = [float(rt.get(r)[-1]) for r in refs]
    objs = _list_state(rt, "objects")["items"]
    out = {"spill": [firsts, again, len(objs) >= 8]}
    rt.shutdown()
    return out


STATE_KINDS = ("nodes", "actors", "tasks", "objects", "workers",
               "placement_groups", "timeline", "traces", "logs",
               "task_events", "metrics", "metrics_history", "engine_steps",
               "gang_rounds", "devmem", "incidents")


@scenario
def state(rt):
    import numpy as np

    rt.init(num_cpus=2)

    @rt.remote
    def f(x):
        return x + 1

    @rt.remote
    class A:
        def ping(self):
            return 1

    a = A.options(name="stateful").remote()
    rt.get([f.remote(i) for i in range(4)] + [a.ping.remote()])
    rt.put(np.zeros(50_000))
    pg = rt.placement_group([{"CPU": 1}])
    pg.ready(timeout=30)
    deadline = time.time() + 60  # a metrics flush and a history sample
    while time.time() < deadline and not (
            _list_state(rt, "metrics")["items"]
            and _list_state(rt, "metrics_history")["items"]):
        time.sleep(0.5)
    out = {}
    for kind in STATE_KINDS:
        reply = _list_state(rt, kind)
        items = reply["items"]
        # Incidents open on the head's own health signals (loop lag on a
        # loaded host), so only the reply's shape is the runtimes' to agree.
        keys = sorted(items[0]) if items and isinstance(items[0], dict) \
            and kind != "incidents" else None
        out[kind] = [sorted(reply), keys]
    rt.shutdown()
    return out


@scenario
def cluster(rt):
    import numpy as np

    cu = importlib.import_module(rt.__name__ + ".cluster_utils")
    c = cu.Cluster(head_num_cpus=2)
    try:
        n1 = c.add_node(num_cpus=2)

        @rt.remote
        def produce(n):
            return np.arange(n, dtype=np.int64)

        @rt.remote
        def consume(a):
            return int(a.sum())

        @rt.remote
        def node():
            return os.environ["RT_NODE_ID"]

        on_n1 = rt.NodeAffinitySchedulingStrategy(n1.hex)
        on_head = rt.NodeAffinitySchedulingStrategy(c.head_node_id.hex())
        ref = produce.options(scheduling_strategy=on_n1).remote(200_000)
        arr = rt.get(ref, timeout=60)
        out = {
            "nodes": len(rt.nodes()),
            "placed": rt.get(node.options(scheduling_strategy=on_n1).remote())
            == n1.hex,
            "driver_pull": [int(arr[-1]), list(arr.shape)],
            "worker_pull": rt.get(
                consume.options(scheduling_strategy=on_head).remote(ref),
                timeout=60),
        }
    finally:
        c.shutdown()
    return out


# --------------------------------------------------------------- grants


def _grant_opts(rt, n):
    return {"num_gpus": n} if _port(rt) else {"num_tpus": n}


def _visible(rt):
    """The granted card IDs as this worker sees them (None: none granted).
    The JAX package unsets TPU_VISIBLE_CHIPS when a grant is the whole
    host and flips JAX_PLATFORMS to the TPU: that reads as both chips."""
    if _port(rt):
        v = os.environ.get("CUDA_VISIBLE_DEVICES")
        return [int(x) for x in v.split(",")] if v else None
    v = os.environ.get("TPU_VISIBLE_CHIPS")
    if v:
        return [int(x) for x in v.split(",")]
    return [0, 1] if os.environ.get("JAX_PLATFORMS") == "tpu,cpu" else None


@scenario
def stalled_head(rt):
    """With health probes every 0.5 s and two misses allowed, the head's
    event loop is blocked for 3 s (its process starved on a loaded host);
    the port's head gives its workers a fresh window after such a stall,
    so a live actor survives it (the JAX head kills it)."""
    ctx = importlib.import_module(rt.__name__ + ".core.context").ctx

    rt.init(num_cpus=2, system_config={"health_check_period_s": 0.5,
                                       "health_check_failure_threshold": 2})

    @rt.remote
    class Echo:
        def ping(self, x):
            return x

    a = Echo.remote()
    out = {"before": rt.get(a.ping.remote(1), timeout=60)}
    _, server_thread = ctx.head_process
    server_thread.loop.call_soon_threadsafe(time.sleep, 3.0)
    time.sleep(5.0)  # the stall, then a few ticks after it
    try:
        out["after"] = rt.get(a.ping.remote(2), timeout=60)
    except Exception as e:  # noqa: BLE001: part of the result
        out["after"] = type(e).__name__
    rt.shutdown()
    return out


@scenario
def grants(rt):
    """Two mocked cards: whole grants, grants held by actors, a grant
    freed by ``kill``, and a task queued behind a held card."""
    rt.init(num_cpus=4)

    @rt.remote
    def vis():
        return _visible(rt)

    @rt.remote
    class Holder:
        def vis(self):
            return _visible(rt)

    out = {"resources": {k: v for k, v in rt.cluster_resources().items()
                         if k in ("GPU", "TPU")}}
    out["cpu_task"] = rt.get(vis.remote())
    out["one"] = rt.get(vis.options(**_grant_opts(rt, 1)).remote())
    out["two"] = rt.get(vis.options(**_grant_opts(rt, 2)).remote())
    h1 = Holder.options(**_grant_opts(rt, 1)).remote()
    out["actor_1"] = rt.get(h1.vis.remote())
    h2 = Holder.options(**_grant_opts(rt, 1)).remote()
    out["actor_2"] = rt.get(h2.vis.remote())
    queued = vis.options(**_grant_opts(rt, 1)).remote()
    ready, _ = rt.wait([queued], timeout=1.5)
    out["queued_while_held"] = len(ready)
    rt.kill(h1)
    out["after_kill"] = rt.get(queued, timeout=60)
    rt.kill(h2)
    out["fraction"] = rt.get(vis.options(**_grant_opts(rt, 0.5)).remote())
    rt.shutdown()
    return out


@scenario
def port_grants(rt):
    """The port alone: the worker environment, the parent's list, and an
    ungranted task asking for the card."""
    rt.init(num_cpus=2)

    @rt.remote
    def env():
        return [os.environ.get("CUDA_VISIBLE_DEVICES"),
                os.environ.get("RT_PARENT_CUDA_VISIBLE_DEVICES")]

    @rt.remote
    def ask_for_card():
        import torch

        from ray_tpu_torch import resolve_device

        try:
            resolve_device()
            return ["no error", torch.cuda.is_available()]
        except RuntimeError as e:
            return [str(e), torch.cuda.is_available()]

    out = {"resources": rt.cluster_resources().get("GPU"),
           "ungranted": rt.get(env.remote()),
           "granted_one": rt.get(env.options(num_gpus=1).remote()),
           "granted_two": rt.get(env.options(num_gpus=2).remote()),
           "resolve_device": rt.get(ask_for_card.remote())}
    try:
        env.options(num_gpus=1.5).remote()
        out["bad_count"] = "accepted"
    except ValueError as e:
        out["bad_count"] = str(e)
    try:
        env.options(num_tpus=1).remote()
        out["num_tpus"] = "accepted"
    except ValueError as e:
        out["num_tpus"] = type(e).__name__
    rt.shutdown()
    return out


@scenario
def port_imports(rt):
    """What a port worker has loaded, and a task's own result, while a
    cluster of the other package may run beside it."""
    rt.init(num_cpus=2)

    @rt.remote
    def loaded():
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))

    @rt.remote
    def tag(i):
        return [i, __import__(rt.__name__).__name__]

    out = {"loaded": rt.get(loaded.remote()),
           "tasks": rt.get([tag.remote(i) for i in range(8)])}
    rt.shutdown()
    return out


@scenario
def both_in_one(rt):
    """``ray_tpu.init()`` and then ``ray_tpu_torch.init()`` in one
    process (run it under either ``--pkg``): the JAX one exports its head
    address as ``RT_ADDRESS``, and the port must start its own head all
    the same, not attach to the JAX one."""
    import ray_tpu as jt
    import ray_tpu_torch as tt
    from ray_tpu.core.context import ctx as jctx
    from ray_tpu_torch.core.context import ctx as tctx

    jt.init(num_cpus=1)
    tt.init(num_cpus=1)

    def packages():
        return sorted(m for m in sys.modules if m in ("ray_tpu",
                                                      "ray_tpu_torch"))

    out = {"jax_address": os.environ.get("RT_ADDRESS"),
           "port_address": os.environ.get("RT_TORCH_ADDRESS"),
           "in_process_heads": [jctx.head_process is not None,
                                tctx.head_process is not None],
           "sessions_differ": jctx.session != tctx.session,
           "jax_worker": jt.get(jt.remote(packages).remote()),
           "port_worker": tt.get(tt.remote(packages).remote()),
           "port_nodes": len(tt.nodes())}
    tt.shutdown()
    jt.shutdown()
    out["left_after"] = [os.environ.get("RT_ADDRESS"),
                         os.environ.get("RT_TORCH_ADDRESS")]
    return out


# -------------------------------------------------------- observability


@scenario
def engine_actor(rt):
    """A tiny engine actor on the CPU serves two requests under a forced
    root trace; its step records and spans reach the head."""
    rt.init(num_cpus=2)

    @rt.remote
    class Engine:
        def __init__(self):
            if _port(rt):
                import torch

                from ray_tpu_torch.models.llama import LlamaConfig, llama_init
                from ray_tpu_torch.serve import engine as eng_mod

                cfg = LlamaConfig.tiny(dtype=torch.float32)
                params = llama_init(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
                self.engine = eng_mod.InferenceEngine(
                    cfg, params, eng_mod.EngineConfig(
                        batch_slots=2, page_size=8, max_prompt_len=16,
                        max_new_tokens_cap=8, prefix_cache=False),
                    device="cpu")
            else:
                import jax
                import jax.numpy as jnp

                from ray_tpu.models import LlamaConfig, llama_init
                from ray_tpu.serve import engine as eng_mod

                cfg = LlamaConfig.tiny(remat=False, dtype=jnp.float32)
                params = llama_init(cfg, jax.random.PRNGKey(0))
                self.engine = eng_mod.InferenceEngine(
                    cfg, params, eng_mod.EngineConfig(
                        batch_slots=2, page_size=8, max_prompt_len=16,
                        max_new_tokens_cap=8, prefix_cache=False))
            self.tracing = importlib.import_module(
                rt.__name__ + ".util.tracing")

        def serve(self):
            with self.tracing.trace("actor-request", force=True) as root:
                toks = [list(self.engine.submit([1, 2, 3, 4],
                                                max_new_tokens=4)),
                        list(self.engine.submit([5, 6], max_new_tokens=3))]
            return [len(t) for t in toks], root["trace_id"], \
                self.engine.engine_id

    e = Engine.remote()
    lens, trace_id, engine_id = rt.get(e.serve.remote(), timeout=300)
    steps, spans = [], []
    deadline = time.time() + 60
    while time.time() < deadline:
        steps = [r for r in _list_state(rt, "engine_steps")["items"]
                 if r.get("engine") == engine_id]
        traces = _list_state(rt, "traces")["items"]
        mine = [t for t in traces if t.get("trace_id") == trace_id]
        if steps and mine and mine[0].get("spans", 0) >= 5:
            break
        time.sleep(0.5)
    timeline = _list_state(rt, "timeline")["items"]
    spans = [ev for ev in timeline if ev.get("kind") == "span"
             and ev.get("trace_id") == trace_id]
    records = [r for group in steps for r in group["records"]]
    out = {"lens": lens,
           "step_groups": sorted(set().union(*(set(g) for g in steps))),
           "step_fields": sorted(set().union(*(set(r) for r in records))),
           "steps_admitted": sum(r["admitted"] for r in records),
           "trace_keys": sorted(mine[0]) if mine else [],
           "span_names": sorted({s["name"] for s in spans})}
    rt.shutdown()
    return out


def run(name: str, pkg: str, env=None, timeout: float = 240.0):
    """Start the scenario under ``pkg`` in a subprocess; returns the
    ``Popen`` (read it with ``result``).  ``env`` adds variables to this
    process's environment; a value of None removes one."""
    import subprocess

    full = dict(os.environ)
    # A scenario starts its own cluster: an address this process holds
    # (its own cluster, while one is up) must not send it to that one.
    for k in ("RT_ADDRESS", "RT_TORCH_ADDRESS"):
        full.pop(k, None)
    for k, v in (env or {}).items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    full["PYTHONPATH"] = root + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pkg", pkg, name],
        cwd=root, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def result(proc, timeout: float = 240.0):
    """The JSON a scenario printed; raises with its output if it failed."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except Exception:
        proc.kill()
        out, err = proc.communicate()
        raise RuntimeError(
            f"scenario timed out:\n{out[-4000:]}\n{err[-4000:]}")
    for line in out.splitlines():
        if line.startswith("SCENARIO_RESULT "):
            return json.loads(line.split(" ", 1)[1])
    raise RuntimeError(f"scenario failed (rc {proc.returncode}):\n"
                       f"{out[-4000:]}\n{err[-4000:]}")


def run_pair(name: str, jax_env=None, port_env=None):
    """The scenario under both packages at once (two clusters on one
    host): ``(ray_tpu result, ray_tpu_torch result)``."""
    jp = run(name, "ray_tpu", jax_env)
    tp = run(name, "ray_tpu_torch", port_env)
    return result(jp), result(tp)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", required=True, choices=("ray_tpu",
                                                     "ray_tpu_torch"))
    ap.add_argument("name", choices=sorted(SCENARIOS))
    args = ap.parse_args(argv)
    rt = importlib.import_module(args.pkg)
    result = SCENARIOS[args.name](rt)
    print("SCENARIO_RESULT " + json.dumps(result, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
