"""Public Serve API: @deployment, run, handles, HTTP ingress (port of
``ray_tpu/serve/api.py``).  A replica asks for cards with
``ray_actor_options={"num_gpus": n}`` (a "GPU" resource); ``num_tpus``
is refused as an unknown option, as ``remote`` refuses it.

Role-equivalent to the reference's serve.api
(reference: serve/api.py:510 serve.run -> controller deploy; deployment
decorator serve/deployment.py; stdlib-http ingress plays the HTTPProxy role,
reference: serve/_private/proxy.py:766).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, Optional

import cloudpickle

import ray_tpu_torch
from ..core.api import _VALID_OPTIONS
from .controller import CONTROLLER_NAME, get_or_create_controller
from .handle import DeploymentHandle


def _dumps_by_value(fn) -> bytes:
    """Serialize a deployment's callable so replicas never need to import
    its defining module: driver scripts and test files are typically not
    importable from worker processes (pytest imports test files as
    top-level modules; ad-hoc scripts are __main__).  Modules of this
    package and of installed packages keep by-reference semantics."""
    import sys

    mod = sys.modules.get(getattr(fn, "__module__", None))
    by_value = False
    if mod is not None and mod.__name__ not in ("__main__",):
        mod_file = getattr(mod, "__file__", "") or ""
        # This file is <package>/serve/api.py: two levels up is the
        # package's own directory.
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        in_site = "site-packages" in mod_file or "dist-packages" in mod_file
        in_framework = mod_file.startswith(os.path.join(pkg_dir, ""))
        if mod_file and not in_site and not in_framework:
            try:
                cloudpickle.register_pickle_by_value(mod)
                by_value = True
            except Exception:
                by_value = False
    try:
        return cloudpickle.dumps(fn)
    finally:
        if by_value:
            try:
                cloudpickle.unregister_pickle_by_value(mod)
            except Exception:
                pass


class Application:
    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.init_args = args
        self.init_kwargs = kwargs


class Deployment:
    def __init__(self, cls_or_fn: Callable, name: str,
                 num_replicas: int = 1,
                 max_concurrent_queries: int = 8,
                 ray_actor_options: Optional[dict] = None,
                 autoscaling_config: Optional[dict] = None):
        self._callable = cls_or_fn
        self.name = name
        self.num_replicas = num_replicas
        self.max_concurrent_queries = max_concurrent_queries
        self.ray_actor_options = ray_actor_options or {}
        bad = set(self.ray_actor_options) - _VALID_OPTIONS
        if bad:
            raise ValueError(f"invalid ray_actor_options: {bad}")
        self.autoscaling_config = autoscaling_config

    def options(self, **overrides) -> "Deployment":
        fields = {
            "name": self.name,
            "num_replicas": self.num_replicas,
            "max_concurrent_queries": self.max_concurrent_queries,
            "ray_actor_options": self.ray_actor_options,
            "autoscaling_config": self.autoscaling_config,
        }
        fields.update(overrides)
        return Deployment(self._callable, **fields)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def to_spec(self, app: Application) -> dict:
        res = {}
        opts = self.ray_actor_options
        if opts.get("num_cpus") is not None:
            res["CPU"] = opts["num_cpus"]
        if opts.get("num_gpus"):
            res["GPU"] = opts["num_gpus"]
        spec = {
            "cls_blob": _dumps_by_value(self._callable),
            "init_args_blob": cloudpickle.dumps(
                (app.init_args, app.init_kwargs)
            ),
            "num_replicas": self.num_replicas,
            "max_concurrent": self.max_concurrent_queries,
            "resources": res,
        }
        if self.autoscaling_config:
            ac = dict(self.autoscaling_config)
            ac.setdefault("min_replicas", 1)
            ac.setdefault("max_replicas", max(ac["min_replicas"], 4))
            spec["autoscaling"] = ac
        return spec


def deployment(_cls=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               max_concurrent_queries: int = 8,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[dict] = None):
    """@serve.deployment decorator (reference: serve/deployment.py)."""

    def deco(cls_or_fn):
        return Deployment(
            cls_or_fn,
            name or getattr(cls_or_fn, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            ray_actor_options=ray_actor_options,
            autoscaling_config=autoscaling_config,
        )

    if _cls is not None:
        return deco(_cls)
    return deco


def run(app: Application, *, name: Optional[str] = None,
        wait_ready: bool = True, timeout: float = 120.0) -> DeploymentHandle:
    """Deploy an application (and every application bound into its init
    args) and return the ingress handle (reference: serve/api.py:510
    serve.run; nested binds mirror the deployment-graph build at
    serve/_private/deployment_graph_build.py — each node becomes its own
    deployment and downstream nodes receive DeploymentHandles)."""
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init()
    controller = get_or_create_controller()
    deployed: list = []
    # Diamond reuse: the same bound Application object deploys once; two
    # DIFFERENT binds of one class get suffixed names (reference:
    # deployment_graph_build.py disambiguates duplicate node names).
    seen: Dict[int, DeploymentHandle] = {}
    used_names: Dict[str, int] = {}

    def deploy_tree(a: Application, override_name: Optional[str] = None
                    ) -> DeploymentHandle:
        if id(a) in seen:
            return seen[id(a)]
        dep = a.deployment
        dep_name = override_name or dep.name
        if override_name is None:
            n = used_names.get(dep_name, 0)
            used_names[dep_name] = n + 1
            if n:
                dep_name = f"{dep_name}_{n + 1}"
        args = tuple(
            deploy_tree(x) if isinstance(x, Application) else x
            for x in a.init_args
        )
        kwargs = {
            k: deploy_tree(v) if isinstance(v, Application) else v
            for k, v in a.init_kwargs.items()
        }
        resolved = Application(dep, args, kwargs)
        ray_tpu_torch.get(controller.deploy.remote(dep_name, dep.to_spec(resolved)),
                    timeout=timeout)
        deployed.append(dep_name)
        handle = DeploymentHandle(dep_name)
        seen[id(a)] = handle
        return handle

    handle = deploy_tree(app, override_name=name)
    if wait_ready:
        import time

        deadline = time.monotonic() + timeout
        for dep_name in deployed:
            while time.monotonic() < deadline:
                if ray_tpu_torch.get(controller.ready.remote(dep_name), timeout=30):
                    break
                time.sleep(0.1)
            else:
                raise TimeoutError(f"deployment {dep_name!r} not ready")
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def status() -> Dict[str, Any]:
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def delete(name: str):
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.delete.remote(name), timeout=30)


def shutdown():
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except Exception:
        pass


# ------------------------------------------------------------- HTTP ingress


class _HttpProxy:
    """Minimal stdlib HTTP ingress: POST /<deployment> with a JSON body
    calls the deployment and returns the JSON result (the HTTPProxy role,
    reference: serve/_private/proxy.py:766 routed by LongestPrefixRouter)."""

    def __init__(self, host: str, port: int):
        import http.server

        handles: Dict[tuple, DeploymentHandle] = {}

        class Handler(http.server.BaseHTTPRequestHandler):
            def _stream_sse(self, gen_handle: DeploymentHandle, payload,
                            trace_id=None):
                """Server-sent events over a generator deployment
                (reference: proxy.py:537-598 — the HTTP proxy streams
                responses chunk-by-chunk as the replica produces them).
                One `data:` frame per yielded item, flushed immediately;
                buffering is one item in this thread, the rest in the
                object store."""
                if isinstance(payload, dict):
                    stream = gen_handle.remote(**payload)
                elif payload is None:
                    stream = gen_handle.remote()
                else:
                    stream = gen_handle.remote(payload)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                if trace_id:
                    # Request-tracing handshake: the client can feed this
                    # to the head's ``list_state`` of kind "traces".
                    self.send_header("X-RT-Trace-Id", trace_id)
                self.end_headers()
                completed = False
                try:
                    for item in stream:
                        self.wfile.write(
                            b"data: " + json.dumps(item).encode() + b"\n\n")
                        self.wfile.flush()
                    self.wfile.write(b"event: done\ndata: null\n\n")
                    self.wfile.flush()
                    completed = True
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client hung up: the finally cancels
                except Exception as e:  # noqa: BLE001 — headers are out;
                    # the error must travel IN the stream, not as a status.
                    try:
                        self.wfile.write(
                            b"event: error\ndata: "
                            + json.dumps(str(e)).encode() + b"\n\n")
                        self.wfile.flush()
                    except OSError:
                        pass
                finally:
                    if not completed:
                        # ANY non-complete exit (client hangup, write
                        # timeout, serialization error) cancels the
                        # replica-side generator so an engine-backed
                        # deployment stops decoding and frees its KV
                        # pages mid-flight.  Idempotent.
                        stream.cancel()

            def do_POST(self):  # noqa: N802 — stdlib naming
                from ray_tpu_torch.util import tracing

                name = self.path.strip("/").split("/")[0]
                want_stream = "text/event-stream" in (
                    self.headers.get("Accept") or "")
                trace_id = None
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(n)
                    payload = json.loads(body) if body else None
                    # Multi-tenant ingress: X-RT-Tenant rides into the
                    # deployment as the ``tenant`` kwarg so engine-backed
                    # deployments (LLMServer) apply per-tenant admission
                    # and accounting.  A tenant already in the body wins —
                    # the header is the transport-level default.
                    tenant = (self.headers.get("X-RT-Tenant") or "").strip()
                    if tenant and isinstance(payload, dict):
                        payload.setdefault("tenant", tenant)
                    # Stream-mode handles are cached alongside unary ones:
                    # a fresh handle per request would pay a controller
                    # routing RPC and lose the p2c load counts.
                    key = (name, want_stream)
                    h = handles.get(key)
                    if h is None:
                        h = handles[key] = DeploymentHandle(
                            name, stream=want_stream)
                    # Per-request root span (sampling per the head's
                    # trace_sample_rate): the whole serve chain — handle,
                    # replica, engine — nests under it, so one trace id
                    # answers "where did this request's latency go".
                    # X-RT-Force-Trace: 1 is the per-call override.
                    force = (self.headers.get("X-RT-Force-Trace") or "") \
                        in ("1", "true")
                    with tracing.trace(f"ingress:{name}", force=force,
                                       proto="http",
                                       stream=want_stream) as tctx:
                        trace_id = tctx.get("trace_id")
                        if want_stream:
                            self._stream_sse(h, payload, trace_id)
                            return
                        if isinstance(payload, dict):
                            resp = h.remote(**payload).result()
                        elif payload is None:
                            resp = h.remote().result()
                        else:
                            resp = h.remote(payload).result()
                    out = json.dumps(resp).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001 — surfaces as a 500
                    out = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                if trace_id:
                    self.send_header("X-RT-Trace-Id", trace_id)
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):  # quiet
                pass

        self.server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, daemon=True,
                         name="serve-http").start()

    def close(self):
        self.server.shutdown()


_proxy: Optional[_HttpProxy] = None


def start_http(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the HTTP ingress; returns the bound port."""
    global _proxy
    if _proxy is None:
        _proxy = _HttpProxy(host, port)
    return _proxy.port


def stop_http():
    global _proxy
    if _proxy is not None:
        _proxy.close()
        _proxy = None
