"""Serve scenarios run under either package, one process each.

``python tests/_torch_serve_scenarios.py --pkg ray_tpu_torch front``
imports the named package as ``rt`` (and its ``serve``), runs the
scenario (which starts and stops its own cluster, controller and
ingresses) and prints its result as one JSON line.  The tests
(``tests/test_torch_serve*.py``) run each scenario under ``ray_tpu`` and
under ``ray_tpu_torch`` at once and compare the two results, so every
value a scenario returns is one the two packages must agree on: no pid,
no clock, no port, no package name.  The scenarios are those of
``tests/test_serve.py``, grouped so that one cluster serves several.
Accelerator grants differ by name only: a JAX replica asks for TPU chips
(``num_tpus``, mocked by ``RT_TPU_CHIPS``), a port replica for GPUs
(``num_gpus``, mocked by ``RT_GPUS``).  Models are built from numpy trees
that the test writes (``RT_SERVE_TREE``, ``RT_SERVE_LORA``: pickles of
the JAX package's ``llama_init`` and ``random_lora`` as numpy), so both
packages serve the same weights.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pickle
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

from _torch_runtime_scenarios import result

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def _serve(rt):
    return importlib.import_module(rt.__name__ + ".serve")


def _post(port: int, path: str, body, headers=None, timeout: float = 60):
    """(status, Content-Type, body bytes) of one POST to the ingress."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{path}",
        data=json.dumps(body).encode() if body is not None else b"",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _sse(port: int, path: str, body):
    status, ctype, raw = _post(port, path, body,
                               {"Accept": "text/event-stream"})
    return {"status": status, "type": ctype, "raw": raw.decode()}


def _wait(cond, timeout: float = 60.0, every: float = 0.2) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(every)
    return False


# ------------------------------------------------------------- the front


@scenario
def front(rt):
    """Routing across replicas, a rolling update, ``@serve.batch``, the
    HTTP ingress, model composition, multiplexing and its LRU, streaming
    through the handle and as SSE, status and delete, and
    ``deploy_config`` (test_serve.py's first, second, fourth, fifth,
    seventh to ninth and eleventh tests, in one cluster)."""
    rt.init(num_cpus=4)
    serve = _serve(rt)
    out = {}

    @serve.deployment(num_replicas=2)
    class Echo:
        def __init__(self, prefix):
            self.prefix = prefix
            self.pid = os.getpid()

        def __call__(self, x):
            return {"out": f"{self.prefix}{x}", "pid": self.pid}

    handle = serve.run(Echo.bind("hi:"))
    res = [handle.remote(i).result() for i in range(20)]
    out["routing"] = {"outs": [r["out"] for r in res],
                      "replicas": len({r["pid"] for r in res}),
                      "status": serve.status()["Echo"]}
    serve.delete("Echo")

    @serve.deployment(num_replicas=1)
    def v1(x):
        return f"v1:{x}"

    @serve.deployment(num_replicas=1)
    def v2(x):
        return f"v2:{x}"

    handle = serve.run(v1.bind(), name="app")
    first = handle.remote(1).result()
    handle = serve.run(v2.bind(), name="app")
    _wait(lambda: handle.remote(1).result() == "v2:1", 30)
    out["rolling_update"] = [first, handle.remote(2).result(),
                             serve.status()["app"]["version"]]
    serve.delete("app")

    @serve.deployment(num_replicas=1)
    class Batched:
        def __init__(self):
            self.batch_sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        async def __call__(self, items):
            self.batch_sizes.append(len(items))
            return [i * 2 for i in items]

        def sizes(self):
            return self.batch_sizes

    handle = serve.run(Batched.bind())
    responses = [handle.remote(i) for i in range(8)]
    got = [r.result() for r in responses]
    sizes = handle.options("sizes").remote().result()
    out["batching"] = [got, sum(sizes), max(sizes) > 1]
    serve.delete("Batched")

    @serve.deployment(num_replicas=1)
    def adder(a, b):
        return {"sum": a + b}

    @serve.deployment
    def boom():
        raise ValueError("bad request")

    serve.run(adder.bind(), name="adder")
    serve.run(boom.bind(), name="boom")
    port = serve.start_http()
    status, ctype, body = _post(port, "adder", {"a": 2, "b": 40})
    out["http"] = [status, ctype, body.decode()]
    status, ctype, body = _post(port, "boom", None)
    out["http_error"] = [status, ctype,
                         "bad request" in json.loads(body)["error"]]

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Pipeline:
        def __init__(self, doubler):
            self.doubler = doubler

        def __call__(self, x):
            return self.doubler.remote(x).result() + 1

    handle = serve.run(Pipeline.bind(Doubler.bind()))
    out["composition"] = [handle.remote(10).result(),
                          sorted(k for k in serve.status()
                                 if k in ("Pipeline", "Doubler"))]

    @serve.deployment(num_replicas=2)
    class Host:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            self.loads.append(model_id)
            return f"model:{model_id}"

        def __call__(self):
            mid = serve.get_multiplexed_model_id()
            return {"model": self.get_model(mid), "loads": list(self.loads)}

    handle = serve.run(Host.bind())
    mux = [handle.options(multiplexed_model_id=m).remote().result()
           for m in ("a", "a", "b")]
    out["multiplexing"] = [mux[0]["model"], mux[1]["loads"].count("a"),
                           mux[2]["model"]]
    serve.delete("Host")

    @serve.deployment(num_replicas=1)
    class Lru:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return model_id

        async def __call__(self):
            await self.get_model(serve.get_multiplexed_model_id())
            return list(self.loads)

    handle = serve.run(Lru.bind())
    for mid in ("a", "b", "c", "a", "c"):
        loads = handle.options(multiplexed_model_id=mid).remote().result()
    out["multiplex_lru"] = loads
    serve.delete("Lru")

    @serve.deployment(num_replicas=1)
    class Tokens:
        def __call__(self, n=5, prefix="tok"):
            for i in range(n):
                yield f"{prefix}{i}"

    handle = serve.run(Tokens.bind())
    out["stream_handle"] = list(handle.options(stream=True).remote(
        4, prefix="h"))
    out["stream_sse"] = _sse(port, "Tokens", {"n": 3, "prefix": "t"})
    serve.stop_http()

    # The declarative path: a module named by import path, options
    # overridden by deployment name, from a dict and from a JSON file.
    tmp = tempfile.mkdtemp(prefix="serve_cfg_")
    with open(os.path.join(tmp, "serve_cfg_app.py"), "w") as f:
        f.write(f"import {rt.__name__}.serve as serve\n\n"
                "@serve.deployment\n"
                "class Greeter:\n"
                "    def __init__(self, greeting='hello'):\n"
                "        self.greeting = greeting\n\n"
                "    def __call__(self, who):\n"
                "        return f'{self.greeting}, {who}'\n")
    sys.path.insert(0, tmp)
    cfg = {"applications": [{
        "name": "greet", "import_path": "serve_cfg_app:Greeter",
        "args": {"greeting": "hey"},
        "deployments": [{"name": "Greeter", "num_replicas": 2}]}]}
    handles = serve.deploy_config(cfg)
    path = os.path.join(tmp, "serve.json")
    with open(path, "w") as f:
        json.dump(dict(cfg, applications=[dict(
            cfg["applications"][0], name="greet2")]), f)
    handles += serve.deploy_config(path)
    out["deploy_config"] = [h.remote("you").result() for h in handles]
    try:
        serve.deploy_config({"applications": [dict(
            cfg["applications"][0], deployments=[{"name": "Nope"}])]})
        out["config_typo"] = "accepted"
    except ValueError as e:
        out["config_typo"] = str(e)
    out["status"] = serve.status()
    serve.shutdown()
    rt.shutdown()
    return out


# ---------------------------------------------------- death and autoscale


@scenario
def recovery(rt):
    """A replica killed under the controller is replaced; sustained load
    makes the autoscaler add replicas (test_serve.py's third and sixth
    tests); a stream that holds every replica lane longer than the
    controller's probe deadline."""
    import signal

    rt.init(num_cpus=4)
    serve = _serve(rt)
    out = {}

    @serve.deployment(num_replicas=2)
    class Svc:
        def __call__(self):
            return os.getpid()

    handle = serve.run(Svc.bind())
    # Calls until both replicas have answered (or a deadline): routing is
    # random, so a fixed number of calls can miss one.
    pids = set()
    deadline = time.time() + 30
    while len(pids) < 2 and time.time() < deadline:
        pids.add(handle.remote().result())
    out["before"] = len(pids)
    os.kill(next(iter(pids)), signal.SIGKILL)

    def replaced():
        if serve.status()["Svc"]["running_replicas"] != 2:
            return False
        try:
            new = {handle.remote().result() for _ in range(10)}
        except Exception:  # noqa: BLE001: the dead one still routed
            return False
        return len(new) == 2 and new != pids

    out["replaced"] = _wait(replaced, 60, 0.3)
    out["after"] = serve.status()["Svc"]["running_replicas"]
    serve.delete("Svc")

    @serve.deployment(autoscaling_config={
        "min_replicas": 1, "max_replicas": 3, "target_ongoing_requests": 1})
    class Slow:
        def __call__(self):
            time.sleep(0.4)
            return "done"

    handle = serve.run(Slow.bind())
    out["autoscale_start"] = serve.status()["Slow"]["running_replicas"]
    deadline = time.time() + 45
    scaled = False
    inflight = []
    while time.time() < deadline and not scaled:
        inflight = inflight[-8:]
        inflight.extend(handle.remote() for _ in range(4))
        time.sleep(0.2)
        scaled = serve.status()["Slow"]["running_replicas"] >= 2
    out["autoscaled"] = scaled
    out["autoscaled_results"] = sorted({r.result() for r in inflight})
    serve.delete("Slow")
    if _port(rt):
        out["busy_streams"] = _busy_streams(serve)
    serve.shutdown()
    rt.shutdown()
    return out


def _busy_streams(serve):
    """Two streams of 8 s on a replica of two lanes, so the controller's
    5-s probes find every lane busy: the port's replica answers them on
    its event loop and both streams finish on one live replica (the JAX
    replica's probes queue behind the streams, and it is killed)."""
    @serve.deployment(max_concurrent_queries=2)
    class Busy:
        def __call__(self, n):
            for _ in range(n):
                time.sleep(1.0)
                yield os.getpid()

    handle = serve.run(Busy.bind()).options(stream=True)
    got = {}

    def drain(i):
        try:
            got[i] = list(handle.remote(8))
        except Exception as e:  # noqa: BLE001: part of the result
            got[i] = type(e).__name__

    threads = [threading.Thread(target=drain, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    return [[len(v), len(set(v))] if isinstance(v, list) else v
            for v in (got.get(0), got.get(1))]


# ------------------------------------------------------------------ gRPC


@scenario
def grpc(rt):
    """The gRPC ingress, unary and server-streaming, and its error codes
    (test_serve.py's tenth and twelfth tests)."""
    import grpc as grpc_mod

    rt.init(num_cpus=4)
    serve = _serve(rt)
    ingress = importlib.import_module(rt.__name__ + ".serve.grpc_ingress")
    out = {}

    @serve.deployment(num_replicas=2)
    class Adder:
        def __call__(self, a, b=0):
            return {"sum": a + b}

        def neg(self, a):
            return -a

        def fail(self):
            raise KeyError("missing")

        def tokens(self, n):
            for i in range(n):
                yield {"t": i}

    serve.run(Adder.bind())
    port = serve.start_grpc()
    channel = grpc_mod.insecure_channel(f"127.0.0.1:{port}")
    unary = channel.unary_unary(ingress.CALL_METHOD)
    stream = channel.unary_stream(ingress.CALL_STREAM_METHOD)

    def call(body, streaming=False):
        try:
            if streaming:
                return [json.loads(b) for b in stream(
                    json.dumps(body).encode(), timeout=60)]
            return json.loads(unary(json.dumps(body).encode(), timeout=60))
        except grpc_mod.RpcError as e:
            return {"code": e.code().name}

    out["unary"] = call({"deployment": "Adder", "args": [40],
                         "kwargs": {"b": 2}})
    out["method"] = call({"deployment": "Adder", "method": "neg",
                          "args": [7]})
    out["not_found"] = call({"deployment": "Nope", "args": []})
    out["bad_body"] = call([1, 2])
    app_error = call({"deployment": "Adder", "method": "fail"})
    out["app_error"] = app_error["code"]
    out["stream"] = call({"deployment": "Adder", "method": "tokens",
                          "args": [5]}, streaming=True)
    out["stream_not_found"] = call({"deployment": "Nope"}, streaming=True)
    channel.close()
    serve.stop_grpc()
    serve.shutdown()
    rt.shutdown()
    return out


# ---------------------------------------------------------------- models


def _tree(name: str):
    with open(os.environ[name], "rb") as f:
        return pickle.load(f)


def _tiny(rt):
    """The tiny model config, fp32, and its weights from ``RT_SERVE_TREE``
    as this package's parameters (CPU)."""
    tree = _tree("RT_SERVE_TREE")
    if _port(rt):
        import torch

        from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax

        cfg = LlamaConfig.tiny(remat=False, dtype=torch.float32)
        return cfg, params_from_jax(cfg, tree, device="cpu")
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig

    cfg = LlamaConfig.tiny(remat=False, dtype=jnp.float32)
    return cfg, jax.tree.map(jnp.asarray, tree)


@scenario
def llm_stream(rt):
    """test_serve.py's last test: a deployment holding the tiny model
    streams ``generate``'s tokens through the handle and as SSE (same
    weights in both packages)."""
    rt.init(num_cpus=4)
    serve = _serve(rt)
    pkg = rt.__name__

    @serve.deployment(num_replicas=1)
    class TinyLlama:
        def __init__(self):
            self.cfg, self.params = _tiny(importlib.import_module(pkg))

        def __call__(self, prompt_tokens, max_new_tokens=4):
            import queue as _q

            import numpy as np

            generate = importlib.import_module(
                pkg + ".models.generate").generate
            out_q: "_q.Queue" = _q.Queue()

            def run():
                generate(self.cfg, self.params,
                         np.asarray([prompt_tokens], np.int32),
                         max_new_tokens=max_new_tokens,
                         stream=lambda t: out_q.put(int(t[0])))
                out_q.put(None)

            threading.Thread(target=run, daemon=True).start()
            while True:
                tok = out_q.get(timeout=120)
                if tok is None:
                    return
                yield tok

    handle = serve.run(TinyLlama.bind())
    out = {"handle": list(handle.options(stream=True).remote([1, 2, 3], 5))}
    out["again"] = list(handle.options(stream=True).remote([1, 2, 3], 5))
    port = serve.start_http()
    out["sse"] = _sse(port, "TinyLlama", {"prompt_tokens": [1, 2, 3],
                                          "max_new_tokens": 3})
    serve.stop_http()
    serve.shutdown()
    rt.shutdown()
    return out


#: The engine deployment's prompts (tiny vocab 512) and its config.
_PROMPTS = [[1, 2, 3], [7, 8, 9, 10, 11, 12], list(range(40, 60)),
            [300, 5, 9, 120, 77]]
_ENGINE = dict(batch_slots=4, page_size=8, max_prompt_len=32,
               max_new_tokens_cap=200, prefix_cache=False)


@scenario
def llm_engine(rt):
    """An ``InferenceEngine`` deployment over one weight tree: greedy
    tokens through the handle (base, by ``adapter=`` and by
    ``multiplexed_model_id``), as SSE, a mid-stream cancel through the
    handle and an SSE client that hangs up, each freeing its pages, and
    an adapter read from the object store against the same adapter
    registered directly."""
    rt.init(num_cpus=4)
    serve = _serve(rt)
    pkg = rt.__name__

    @serve.deployment(num_replicas=1)
    class EngineHost:
        def __init__(self):
            rt_mod = importlib.import_module(pkg)
            eng = importlib.import_module(pkg + ".serve.engine")
            cfg, params = _tiny(rt_mod)
            kw = {"device": "cpu"} if _port(rt_mod) else {}
            self.engine = eng.InferenceEngine(
                cfg, params, eng.EngineConfig(**_ENGINE), **kw)
            self.engine.register_adapter("direct", _tree("RT_SERVE_LORA"))

        def __call__(self, prompt_tokens, max_new_tokens=8, adapter=None):
            if adapter is None:
                mux = importlib.import_module(pkg + ".serve.multiplex")
                adapter = mux.get_multiplexed_model_id() or None
            stream = self.engine.submit(prompt_tokens,
                                        max_new_tokens=max_new_tokens,
                                        adapter=adapter)
            try:
                for tok in stream:
                    yield tok
            finally:
                stream.cancel()

        def load(self, name, source):
            self.engine.register_adapter(name, source)
            return name

        def stats(self):
            return self.engine.stats()

    handle = serve.run(EngineHost.bind())
    stream = handle.options(stream=True)
    out = {"base": [list(stream.remote(p, 8)) for p in _PROMPTS],
           "adapter": [list(stream.remote(p, 8, adapter="direct"))
                       for p in _PROMPTS],
           "mux": list(handle.options(stream=True,
                                      multiplexed_model_id="direct")
                       .remote(_PROMPTS[1], 8))}
    ref = rt.put(_tree("RT_SERVE_LORA"))
    handle.options("load").remote("stored", ref).result()
    out["stored"] = [list(stream.remote(p, 8, adapter="stored"))
                     for p in _PROMPTS]

    def stats():
        return handle.options("stats").remote().result()

    def settled():
        st = stats()
        return st["active_seqs"] == 0 and st["free_pages"] == \
            st["total_pages"]

    gen = stream.remote(_PROMPTS[2], 200)
    it = iter(gen)
    out["cancel_head"] = [next(it), next(it)]
    gen.cancel()
    out["cancel_freed"] = _wait(settled, 30, 0.1)
    st = stats()
    out["cancelled"] = st["cancelled"]
    port = serve.start_http()
    out["sse"] = _sse(port, "EngineHost", {"prompt_tokens": _PROMPTS[0],
                                           "max_new_tokens": 6})
    out["sse_adapter"] = _sse(port, "EngineHost", {
        "prompt_tokens": _PROMPTS[3], "max_new_tokens": 6,
        "adapter": "direct"})
    # An SSE client that hangs up after the first frame.
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/EngineHost", body=json.dumps({
        "prompt_tokens": _PROMPTS[2], "max_new_tokens": 200}),
        headers={"Accept": "text/event-stream"})
    resp = conn.getresponse()
    out["hangup_first"] = resp.readline().decode()
    resp.close()  # the response holds the socket open too
    conn.close()
    out["hangup_freed"] = _wait(
        lambda: settled() and stats()["cancelled"] > st["cancelled"], 60,
        0.2)
    st = stats()
    out["stats"] = {k: st[k] for k in ("active_seqs", "free_pages",
                                       "total_pages", "shared_pages",
                                       "completed", "cancelled", "shed",
                                       "queued", "mode", "adapters")}
    serve.stop_http()
    serve.shutdown()
    rt.shutdown()
    return out


@scenario
def llm_app(rt):
    """``llm_app(model="tiny")`` (on the CPU: the port's with
    ``device="cpu"``) through the handle and as SSE against an engine of
    the same package built in this process from the same seed; JAX and
    the port draw different weights, so only the agreement is compared."""
    rt.init(num_cpus=4)
    serve = _serve(rt)
    eng = importlib.import_module(rt.__name__ + ".serve.engine")
    kw = {"device": "cpu"} if _port(rt) else {}
    ecfg = dict(batch_slots=4, page_size=8, max_prompt_len=32)
    handle = serve.run(serve.llm_app(model="tiny", engine=ecfg,
                                     adapters={"a1": 1}, **kw))
    stream = handle.options(stream=True)
    got = [list(stream.remote(p, 6)) for p in _PROMPTS]
    got_a1 = list(stream.remote(_PROMPTS[1], 6, adapter="a1"))
    port = serve.start_http()
    sse = _sse(port, "llm", {"prompt_tokens": _PROMPTS[2],
                             "max_new_tokens": 6})
    frames = [json.loads(ln[6:]) for ln in sse["raw"].split("\n")
              if ln.startswith("data: ") and ln != "data: null"]
    stats = handle.options("stats").remote().result()
    serve.stop_http()
    serve.shutdown()
    rt.shutdown()

    # The same engine in this process.
    if _port(rt):
        import torch

        from ray_tpu_torch.models.llama import llama_init

        cfg = eng._MODEL_BUILDERS["tiny"]()
        params = llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
        lora = eng.random_lora(cfg, 1, rank=8, device="cpu")
    else:
        import jax

        from ray_tpu.models import llama_init

        cfg = eng._MODEL_BUILDERS["tiny"]()
        params = llama_init(cfg, jax.random.PRNGKey(0))
        lora = eng.random_lora(cfg, 1, rank=8)
    engine = eng.InferenceEngine(cfg, params, eng.EngineConfig(**ecfg), **kw)
    try:
        engine.register_adapter("a1", lora)
        want = [list(engine.submit(p, max_new_tokens=6)) for p in _PROMPTS]
        want_a1 = list(engine.submit(_PROMPTS[1], max_new_tokens=6,
                                     adapter="a1"))
    finally:
        engine.shutdown()
    return {"handle_equal": got == want, "adapter_equal": got_a1 == want_a1,
            "adapter_differs": got_a1 != want[1],
            "sse_equal": frames == want[2], "sse_type": sse["type"],
            "lens": [len(t) for t in got],
            "stats_keys": sorted(k for k in stats
                                 if k in ("free_pages", "total_pages",
                                          "completed", "adapters"))}


# ----------------------------------------------------------------- grants


def _grant(rt, n):
    return {"num_gpus": n} if _port(rt) else {"num_tpus": n}


def _visible(rt):
    """The granted card IDs as this worker sees them (None: none).  The
    JAX package unsets TPU_VISIBLE_CHIPS when a grant is the whole host
    and flips JAX_PLATFORMS to the TPU: that reads as every chip."""
    if _port(rt):
        v = os.environ.get("CUDA_VISIBLE_DEVICES")
    else:
        v = os.environ.get("TPU_VISIBLE_CHIPS")
        if not v and os.environ.get("JAX_PLATFORMS") == "tpu,cpu":
            return list(range(int(os.environ["RT_TPU_CHIPS"])))
    return [int(x) for x in v.split(",")] if v else None


@scenario
def grants(rt):
    """One mocked card (``RT_GPUS=1`` / ``RT_TPU_CHIPS=1``): a replica
    granted it, a rolling update of that deployment (the stale replica
    must give the card back before the new one can start), and the card
    granted to the next app once the first is deleted."""
    rt.init(num_cpus=4)
    serve = _serve(rt)
    pkg = rt.__name__
    out = {"resources": {k: v for k, v in rt.cluster_resources().items()
                         if k in ("GPU", "TPU")}}

    def make(tag):
        @serve.deployment(name="card", ray_actor_options=_grant(rt, 1))
        class Card:
            def __call__(self):
                return [tag, _visible(importlib.import_module(pkg))]

        return Card

    handle = serve.run(make("v1").bind(), name="card", timeout=120)
    out["v1"] = handle.remote().result()
    t = time.time()
    handle = serve.run(make("v2").bind(), name="card", timeout=120)
    out["rolled"] = _wait(lambda: handle.remote().result()[0] == "v2", 60)
    out["v2"] = handle.remote().result()
    out["status"] = serve.status()["card"]
    rolled_s = time.time() - t

    @serve.deployment(ray_actor_options=_grant(rt, 1))
    class Second:
        def __call__(self):
            return ["second", _visible(importlib.import_module(pkg))]

    # One card, one GPU replica at a time: the controller's loop waits
    # for a starting replica, so the next app comes after the delete.
    serve.delete("card")
    second = serve.run(Second.bind(), timeout=120)
    out["second"] = second.remote().result()
    out["final_status"] = serve.status()
    serve.shutdown()
    rt.shutdown()
    print(f"rolling update on one card: {rolled_s:.1f} s", file=sys.stderr)
    return out


@scenario
def no_card(rt):
    """The port alone, with one mocked card (``RT_GPUS=1``) on a host
    without CUDA: ``llm_app``'s replica, granted the card, raises as it
    builds its weights, and so does an ``LLMServer`` replica granted none;
    neither falls back to the CPU."""
    import cloudpickle

    from ray_tpu_torch.serve.api import _dumps_by_value
    from ray_tpu_torch.serve.engine import LLMServer
    from ray_tpu_torch.serve.replica import ServeReplica

    rt.init(num_cpus=2)
    serve = _serve(rt)
    app = serve.llm_app(model="tiny")
    out = {"options": app.deployment.ray_actor_options}
    try:
        serve.run(app, timeout=10)
        out["run"] = "ready"
    except TimeoutError:
        out["run"] = "TimeoutError"
    out["running"] = serve.status()["llm"]["running_replicas"]
    serve.delete("llm")
    blob = _dumps_by_value(LLMServer)
    args = cloudpickle.dumps(((), {"model": "tiny"}))
    for key, opts in (("granted", {"num_gpus": 1}), ("ungranted", {})):
        rep = ServeReplica.options(**opts).remote("llm", blob, args)
        try:
            rt.get(rep.ping.remote(), timeout=120)
            out[key] = "ready"
        except Exception as e:  # noqa: BLE001: part of the result
            out[key] = [type(e).__name__, "CUDA is not available" in str(e)]
        rt.kill(rep)
    serve.shutdown()
    rt.shutdown()
    return out


@scenario
def pending_card(rt):
    """The port alone, one mocked card (``RT_GPUS=1``): app ``a`` holds
    the card; app ``b`` asks for it too and waits, pending; meanwhile a
    CPU app deploys (the reconcile loop is not held by the pending
    replica); ``b`` is deleted while pending, then ``a``: the card comes
    back free and a last app is granted it."""
    rt.init(num_cpus=4)
    serve = _serve(rt)
    pkg = rt.__name__

    def card_app(tag):
        @serve.deployment(name=tag, ray_actor_options={"num_gpus": 1})
        class Card:
            def __call__(self):
                return [tag, _visible(importlib.import_module(pkg))]

        return Card.bind()

    @serve.deployment
    class Cpu:
        def __call__(self):
            return "cpu"

    out = {"a": serve.run(card_app("a"), name="a",
                          timeout=120).remote().result()}
    serve.run(card_app("b"), name="b", wait_ready=False)
    time.sleep(1.0)
    t = time.time()
    try:
        out["cpu"] = serve.run(Cpu.bind(), name="cpu",
                               timeout=60).remote().result()
    except TimeoutError:
        out["cpu"] = "TimeoutError"
    out["cpu_fast"] = time.time() - t < 30
    st = serve.status()
    out["b_status"] = {k: st["b"][k] for k in ("target_replicas",
                                               "running_replicas")}
    t = time.time()
    serve.delete("b")
    out["delete_fast"] = time.time() - t < 5
    serve.delete("a")
    out["card_freed"] = _wait(
        lambda: rt.available_resources().get("GPU") == 1.0, 30)
    time.sleep(2.0)  # a leftover replica would take the card by now
    out["card_still_free"] = rt.available_resources().get("GPU") == 1.0
    out["d"] = serve.run(card_app("d"), name="d",
                         timeout=120).remote().result()
    out["apps"] = sorted(serve.status())
    serve.shutdown()
    rt.shutdown()
    return out


@scenario
def side_by_side(rt):
    """A serve app of each package at once on one host (run both with
    ``run_pair``): two heads, two controllers, two HTTP ingresses, each
    answering its own; the port's replica has loaded no JAX and no
    ``ray_tpu``."""
    rt.init(num_cpus=2)
    serve = _serve(rt)
    pkg = rt.__name__

    @serve.deployment
    class Who:
        def __call__(self, x):
            loaded = sorted({m.split(".")[0] for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib",
                                                    "ray_tpu")})
            return {"x": x, "pkg": pkg, "loaded": loaded}

    serve.run(Who.bind())
    port = serve.start_http()
    status, _, body = _post(port, "Who", {"x": 3})
    out = {"http": [status, json.loads(body)]}
    serve.stop_http()
    serve.shutdown()
    rt.shutdown()
    return out


def run(name, pkg: str, env=None):
    """Start the scenario ``name`` (or, given a list, each of those in
    order) under ``pkg`` in one subprocess; returns the ``Popen`` (read it
    with ``result``: one scenario's result, or ``{name: result}`` for a
    list).  ``env`` adds variables to this process's environment; a value
    of None removes one."""
    import subprocess

    full = dict(os.environ)
    for k, v in (env or {}).items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    full["PYTHONPATH"] = os.pathsep.join(
        [root, here, full.get("PYTHONPATH", "")])
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pkg", pkg,
         *([name] if isinstance(name, str) else ["--many", *name])],
        cwd=root, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def run_pair(name, env=None, jax_env=None, port_env=None,
             timeout: float = 240.0):
    """The scenario (or list of scenarios, see ``run``) under both packages
    at once (two clusters on one host), one process a package:
    ``(ray_tpu result, ray_tpu_torch result)``."""
    jp = run(name, "ray_tpu", dict(env or {}, **(jax_env or {})))
    tp = run(name, "ray_tpu_torch", dict(env or {}, **(port_env or {})))
    return result(jp, timeout), result(tp, timeout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", required=True, choices=("ray_tpu",
                                                     "ray_tpu_torch"))
    ap.add_argument("--many", action="store_true",
                    help="print {name: result} of each scenario named")
    ap.add_argument("names", nargs="+", choices=sorted(SCENARIOS))
    args = ap.parse_args(argv)
    rt = importlib.import_module(args.pkg)
    if args.many:
        out = {name: SCENARIOS[name](rt) for name in args.names}
    else:
        (name,) = args.names
        out = SCENARIOS[name](rt)
    print("SCENARIO_RESULT " + json.dumps(out, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
