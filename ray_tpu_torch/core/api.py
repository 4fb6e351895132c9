"""Public API: init/shutdown, @remote tasks & actors, get/put/wait, placement
groups, named actors.

Role-equivalent to the reference's python/ray/_private/worker.py:1227 (init),
:2567/2693/2758 (get/put/wait), remote_function.py:40 (RemoteFunction),
actor.py:581 (ActorClass) / :1238 (ActorHandle), util/placement_group.py.
"""

from __future__ import annotations

import atexit
import hashlib
import inspect
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

import cloudpickle

from .. import exceptions
from . import serialization
from .client import Client
from .config import ADDRESS_ENV, Config, address_file, get_config, set_config
from .context import ctx
from .head import Head
from .ids import ActorID, ObjectID, PlacementGroupID, TaskID
from .object_ref import ObjectRef, ObjectRefGenerator, _TopLevelRef
from .rpc import ServerThread
from .scheduler import SchedulingStrategy

_init_lock = threading.RLock()

# ----------------------------------------------------------------- scheduling


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[dict], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        # True when the bundles didn't fit the node set at creation time; the
        # PG stays pending until nodes join (callers on fixed clusters can
        # check this to fall back instead of blocking in ready()).
        self.infeasible_now = False

    def ready(self, timeout: float = 30.0) -> bool:
        """Block until the group's bundles are reserved (False on timeout).
        Feasible-but-busy groups queue head-side until resources free up
        (reference: gcs_placement_group_manager pending queue)."""
        return ctx.client.call(
            "pg_ready",
            {"pg_id": self.id.binary(), "timeout": timeout},
            timeout=timeout + 30,
        )["ready"]

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group: PlacementGroup,
                 placement_group_bundle_index: int = -1):
        self.placement_group = placement_group
        self.bundle_index = placement_group_bundle_index

    def to_wire(self) -> dict:
        return {
            "kind": "placement_group",
            "pg_id": self.placement_group.id.binary(),
            "bundle_index": self.bundle_index,
        }


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft

    def to_wire(self) -> dict:
        return {
            "kind": "node_affinity",
            "node_id": bytes.fromhex(self.node_id),
            "soft": self.soft,
        }


def _strategy_wire(strategy) -> Optional[dict]:
    if strategy is None or strategy == "DEFAULT":
        return None
    if strategy == "SPREAD":
        return {"kind": "spread"}
    if hasattr(strategy, "to_wire"):
        return strategy.to_wire()
    raise ValueError(f"unknown scheduling strategy {strategy!r}")


# ------------------------------------------------------------------- init


def _detect_resources(num_cpus=None, num_gpus=None, resources=None) -> Dict[str, float]:
    from ray_tpu_torch import accelerators

    out: Dict[str, float] = dict(resources or {})
    out["CPU"] = float(num_cpus if num_cpus is not None else os.cpu_count() or 1)
    if num_gpus is not None:
        out["GPU"] = float(num_gpus)
    elif "GPU" not in out:
        # Autodetect the host's cards (accelerators.num_gpus: RT_GPUS, the
        # driver's CUDA_VISIBLE_DEVICES, NVML, /dev/nvidia<n>); explicit
        # num_gpus/resources win.
        out.update(accelerators.node_resources())
    out = {k: v for k, v in out.items() if k != "GPU" or v}
    out.setdefault("memory", float(2**33))
    return out


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    num_workers: Optional[int] = None,
    namespace: str = "default",
    object_store_memory: Optional[int] = None,
    system_config: Optional[dict] = None,
    labels: Optional[Dict[str, str]] = None,
    ignore_reinit_error: bool = False,
    include_dashboard: bool = False,
    dashboard_port: int = 0,
):
    """Start (or connect to) a cluster.  With no address, an in-process control
    plane is started and worker processes are spawned on demand."""
    with _init_lock:
        if ctx.initialized:
            if ignore_reinit_error:
                return ctx
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(pass ignore_reinit_error=True to allow)")
        cfg = Config().apply_env_overrides().apply_overrides(system_config)
        if object_store_memory:
            cfg.object_store_memory = object_store_memory
        set_config(cfg)

        if address is None and os.environ.get(ADDRESS_ENV):
            address = os.environ[ADDRESS_ENV]

        if address is None:
            session = uuid.uuid4().hex[:12]
            head = Head(cfg, session)
            server_thread = ServerThread(head.server)
            # Head.start assigns the port inside the server thread's loop.
            server_thread.loop.call_soon_threadsafe(lambda: None)
            port = server_thread.start()
            head.port = port
            node_resources = _detect_resources(num_cpus, num_gpus, resources)
            cap = num_workers if num_workers is not None else (
                cfg.num_workers or int(node_resources["CPU"])
            )
            server_thread.run_coro(
                _add_local_node(head, node_resources, cap, labels)
            ).result(timeout=10)
            # Prestart the worker pool so first tasks don't pay process spawn
            # latency (reference: worker_pool.h prestarts num_cpus workers).
            prestart = min(cap, int(os.environ.get("RT_PRESTART_WORKERS", cap)))
            server_thread.run_coro(
                _prestart_workers(head, prestart)
            ).result(timeout=10)
            server_thread.run_coro(head.restore_state()).result(timeout=30)
            server_thread.run_coro(head.start_periodic()).result(timeout=10)
            ctx.head_process = (head, server_thread)
            address = f"127.0.0.1:{port}"
            os.environ[ADDRESS_ENV] = address
            # Discovery for out-of-process tooling (state CLI, job submit).
            try:
                path = address_file()
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w") as f:
                    f.write(address)
            except OSError:
                pass

        ctx.client = Client(address, kind="driver", pid=os.getpid())
        ctx.mode = "driver"
        ctx.session = ctx.client.session
        ctx.namespace = namespace
        if include_dashboard:
            from ray_tpu_torch.dashboard import Dashboard

            ctx.dashboard = Dashboard(address, port=dashboard_port).start()
        if os.environ.get("RT_LOG_TO_DRIVER", "1") != "0":
            # Worker stdout/stderr arrive over pubsub (reference: the log
            # monitor republishes worker logs to the driver).
            def _print_worker_log(data):
                try:
                    prefix = f"(pid={data.get('pid')}) "
                    import sys as _sys

                    print(prefix + str(data.get("line", "")),
                          file=_sys.stderr
                          if data.get("stream") == "stderr" else _sys.stdout)
                except Exception:
                    pass

            try:
                ctx.client.subscribe("worker_logs", _print_worker_log)
            except Exception:
                pass
        atexit.register(shutdown)
        return ctx


async def _add_local_node(head: Head, resources, cap, labels):
    head.add_local_node(resources, cap, labels)


async def _prestart_workers(head: Head, n: int):
    for _ in range(n):
        head._spawn_worker(head.local_node_id)


def is_initialized() -> bool:
    return ctx.initialized


def _ensure_init():
    if not ctx.initialized:
        init()


def shutdown():
    with _init_lock:
        if not ctx.initialized:
            return
        head_proc = ctx.head_process
        client = ctx.client
        if ctx.dashboard is not None:
            try:
                ctx.dashboard.stop()
            except Exception:
                pass
        # Flush pending ObjectRef frees so a long-lived driver doesn't leave
        # up to a batch of shm segments behind.
        from .object_ref import _flush_free_queue

        try:
            _flush_free_queue()
        except Exception:
            pass
        try:
            if head_proc is not None:
                head, server_thread = head_proc
                try:
                    server_thread.run_coro(head.stop()).result(timeout=5)
                except Exception:
                    pass
                server_thread.stop()
            client.close()
        finally:
            os.environ.pop(ADDRESS_ENV, None)
            ctx.reset()


# --------------------------------------------------------------- object API


def put(value: Any) -> ObjectRef:
    _ensure_init()
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed")
    return ObjectRef(ctx.client.put(value))


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: float = -1.0):
    _ensure_init()
    single = isinstance(refs, ObjectRef)
    batch = [refs] if single else list(refs)
    for r in batch:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    values = ctx.client.get(batch, timeout=timeout)
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
):
    _ensure_init()
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return ctx.client.wait(
        list(refs), num_returns, -1.0 if timeout is None else timeout
    )


def cancel(ref: ObjectRef, *, force: bool = False):
    _ensure_init()
    # Routed: direct-plane tasks cancel over the peer connection, head
    # tasks via the control plane.
    ctx.client.cancel_task(ref.task_id().binary(), force)


def kill(actor: "ActorHandle", *, no_restart: bool = True):
    _ensure_init()
    ctx.client.call(
        "kill_actor",
        {"actor_id": actor._actor_id.binary(), "no_restart": no_restart},
    )


# ----------------------------------------------------------------- functions


def _export(blob: bytes, prefix: str) -> str:
    """Export a pickled function/class to the cluster function table, dedup by
    content hash (reference: src/ray/gcs/gcs_server/gcs_function_manager.h).
    The export rides the background pipeline: the head processes it before
    any submission that references it (same connection, FIFO)."""
    key = f"{prefix}:{hashlib.sha1(blob).hexdigest()}"
    if key not in ctx.client.exported_keys:
        # First export of a key is synchronous so a failure (e.g. a blob over
        # the rpc size limit) raises here and is retried on the next call —
        # caching the key before a background send succeeded would suppress
        # re-export forever.  Amortized cost: one round trip per function.
        ctx.client.kv_put(key, blob, overwrite=False)
        ctx.client.exported_keys.add(key)
    return key


def _pack_args(args: tuple, kwargs: dict):
    """Replace top-level ObjectRefs with markers; returns (blob, arg_ids,
    args_ref).  Large argument payloads go to the object store."""
    cfg = get_config()
    arg_ids: List[bytes] = []
    proc_args = []
    for a in args:
        if isinstance(a, ObjectRef):
            arg_ids.append(a.binary())
            proc_args.append(_TopLevelRef(a.binary()))
        else:
            proc_args.append(a)
    proc_kwargs = {}
    for k, v in kwargs.items():
        if isinstance(v, ObjectRef):
            arg_ids.append(v.binary())
            proc_kwargs[k] = _TopLevelRef(v.binary())
        else:
            proc_kwargs[k] = v
    meta, buffers = serialization.serialize((tuple(proc_args), proc_kwargs))
    size = serialization.packed_size(meta, buffers)
    if size <= cfg.inline_object_max_bytes:
        blob = bytearray(size)
        serialization.pack_into(meta, buffers, memoryview(blob))
        return bytes(blob), arg_ids, None
    # Large args ride the object store instead of the RPC channel
    # (reference: _raylet.pyx submit_task puts large args into plasma).
    oid = ObjectID.from_random()
    buf = ctx.client.store().create(oid, size)
    serialization.pack_into(meta, buffers, buf)
    ctx.client.call(
        "put_object",
        {"object_id": oid.binary(), "size": size,
         "node_id": ctx.client.node_id.binary()},
    )
    return None, arg_ids, oid.binary()


def _package_working_dir(wd: str):
    """Zip a working_dir into a content-addressed (key, blob) pair."""
    import io
    import zipfile

    buf = io.BytesIO()
    n_files = 0
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(wd):
            dirs[:] = [d for d in dirs
                       if d not in ("__pycache__", ".git", ".venv")]
            for fname in files:
                full = os.path.join(root, fname)
                zf.write(full, os.path.relpath(full, wd))
                n_files += 1
    if n_files == 0:
        raise ValueError(
            f"runtime_env working_dir {wd!r} is empty or does not exist"
        )
    blob = buf.getvalue()
    if len(blob) > 64 * 1024 * 1024:
        raise ValueError(
            f"working_dir archive is {len(blob)} bytes (>64MiB); ship large "
            "assets through the object store or shared storage instead"
        )
    key = f"wd:{hashlib.sha1(blob).hexdigest()}"
    return key, blob


def _process_runtime_env(renv: Optional[dict], cache: Optional[dict] = None):
    """Upload runtime_env payloads (content-addressed in the cluster KV) and
    rewrite the env to reference them.  `cache` memoizes the expensive zip
    across calls, but the kv upload is re-ensured per client so a
    shutdown()+init() cycle re-populates the new cluster's KV (reference:
    _private/runtime_env/working_dir.py URI-cached packages;
    runtime_env/py_modules.py ships import roots the same way)."""
    if not renv or not any(k in renv for k in
                           ("working_dir", "py_modules", "pip", "conda")):
        return renv
    cache = cache if cache is not None else {}
    out = dict(renv)

    def ensure(key, blob):
        if key not in ctx.client.exported_keys:
            ctx.client.kv_put(key, blob, overwrite=False)
            ctx.client.exported_keys.add(key)

    if "working_dir" in renv:
        if "key" in cache:
            key, blob = cache["key"], cache["blob"]
        else:
            key, blob = _package_working_dir(renv["working_dir"])
            cache["key"], cache["blob"] = key, blob
        ensure(key, blob)
        out.pop("working_dir")
        out["working_dir_key"] = key
    if "py_modules" in renv:
        # Each entry is a module DIRECTORY (or a module object); the worker
        # extracts it under an import root on sys.path (reference:
        # runtime_env/py_modules.py upload_py_modules_if_needed).
        mod_keys = cache.get("py_module_keys")
        if mod_keys is None:
            mod_keys = []
            for mod in renv["py_modules"]:
                path = getattr(mod, "__path__", None)
                if path is not None:
                    mod_dir = list(path)[0]
                elif isinstance(mod, str):
                    mod_dir = mod
                else:
                    raise TypeError(
                        "py_modules entries must be package directories "
                        f"(str) or package module objects, got {mod!r} "
                        "(single-file modules: ship their parent directory)"
                    )
                if not os.path.isdir(mod_dir):
                    raise ValueError(
                        f"py_modules entry {mod_dir!r} is not a directory"
                    )
                name = os.path.basename(mod_dir.rstrip("/"))
                if ":" in name:
                    raise ValueError(
                        f"py_modules directory name {name!r} may not "
                        "contain ':'"
                    )
                key, blob = _package_working_dir(mod_dir)
                key = f"pymod:{name}:{key.split(':', 1)[1]}"
                mod_keys.append((key, blob))
            cache["py_module_keys"] = mod_keys
        for key, blob in mod_keys:
            ensure(key, blob)
        out.pop("py_modules")
        out["py_module_keys"] = [k for k, _ in mod_keys]
    if "pip" in renv:
        # Per-task/actor python-dependency isolation (reference:
        # _private/runtime_env/pip.py + uri_cache.py): the env key is a
        # content hash of the requirement list (+ interpreter version);
        # local wheel/sdist files upload to the cluster KV so any node can
        # build the env without a shared filesystem or an index.
        pip_env = cache.get("pip_env")
        if pip_env is None:
            reqs = renv["pip"]
            if isinstance(reqs, dict):
                reqs = reqs.get("packages", [])
            if isinstance(reqs, str):
                with open(reqs) as f:
                    reqs = [ln.strip() for ln in f
                            if ln.strip()
                            and not ln.strip().startswith("#")]
            if not isinstance(reqs, (list, tuple)):
                raise TypeError("runtime_env['pip'] must be a list of "
                                "requirements, a requirements file path, "
                                "or {'packages': [...]}")
            normalized: List = []
            wheels: List = []
            for r in reqs:
                if isinstance(r, str) and os.path.isfile(r) and \
                        r.endswith((".whl", ".tar.gz", ".zip")):
                    with open(r, "rb") as f:
                        blob = f.read()
                    digest = hashlib.sha256(blob).hexdigest()[:16]
                    base = os.path.basename(r)
                    wheels.append((f"pipwhl:{digest}:{base}", blob, base))
                    normalized.append(("file", base, digest))
                else:
                    normalized.append(("req", str(r)))
            import sys as _sys

            env_hash = hashlib.sha256(repr(
                (normalized, _sys.version_info[:2])
            ).encode()).hexdigest()[:16]
            pip_env = cache["pip_env"] = {
                "hash": env_hash,
                "reqs": [list(n) for n in normalized],
                "wheel_keys": [(k, base) for k, _, base in wheels],
                "_wheel_blobs": wheels,
            }
        for key, blob, _ in pip_env["_wheel_blobs"]:
            ensure(key, blob)
        out.pop("pip")
        out["pip_env"] = {k: v for k, v in pip_env.items()
                          if k != "_wheel_blobs"}
    if "conda" in renv:
        # Conda envs (reference: _private/runtime_env/conda.py:260 —
        # content-addressed env creation from an environment dict, or
        # activation of a pre-existing named env).  The worker shells out
        # to the `conda` executable; clusters without conda fail fast
        # with a clear error at task setup.
        spec = renv["conda"]
        if isinstance(spec, dict):
            import json as _json

            canon = _json.dumps(spec, sort_keys=True)
            env_hash = hashlib.sha256(canon.encode()).hexdigest()[:16]
            conda_env = {"hash": env_hash, "spec": canon}
        elif isinstance(spec, str):
            # A named env / prefix path that must already exist.
            conda_env = {"name": spec}
        else:
            raise TypeError("runtime_env['conda'] must be an environment "
                            "dict or an existing env name/prefix")
        out.pop("conda")
        out["conda_env"] = conda_env
    return out


_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "num_returns", "max_retries",
    "retry_exceptions", "name", "scheduling_strategy", "runtime_env",
    "max_restarts", "max_task_retries", "max_concurrency", "lifetime",
    "namespace", "memory", "_metadata",
    "concurrency_groups", "execute_out_of_order", "concurrency_group",
}


def method(**method_options):
    """Annotate an actor method (reference: ray.method — actor.py:116
    ActorMethod decorator).  Supported: ``concurrency_group=`` binds the
    method to a named group declared in
    ``@remote(concurrency_groups={...})`` (reference:
    core_worker/transport/concurrency_group_manager.h); ``num_returns=``."""
    allowed = {"concurrency_group", "num_returns"}
    bad = set(method_options) - allowed
    if bad:
        raise ValueError(f"invalid method options: {bad}")

    def decorator(fn):
        fn.__rt_method_options__ = method_options
        return fn

    return decorator


def _inject_trace(spec: dict) -> None:
    """Propagate the active trace context into an outgoing task spec
    (reference: tracing_helper.py _DictPropagator injects the OTel span
    context into the spec's serialized runtime context).  The pre-assigned
    task_span_id makes the execution span's identity stable across retries.

    Each traced submission also records a zero-length *submit span* whose
    ``attrs.flow_id`` is the execution span's pre-assigned id:
    tracing.chrome_trace turns the pair into a flow arrow, so the timeline
    shows the scheduling gap between submit and execute."""
    import time as _time

    from ray_tpu_torch.util import tracing

    parent = tracing.context_for_submit()
    if parent is not None:
        task_span_id = tracing.new_id()
        spec["trace_ctx"] = {
            "trace_id": parent["trace_id"],
            "span_id": parent["span_id"],
            "task_span_id": task_span_id,
        }
        now = _time.time()
        tracing.emit_span(tracing.make_span(
            parent, f"submit:{spec.get('name', 'task')}", now, now,
            flow_id=task_span_id))


def _resources_from_options(o: dict, default_cpu: float = 1.0) -> Dict[str, float]:
    res = dict(o.get("resources") or {})
    res["CPU"] = float(o["num_cpus"]) if o.get("num_cpus") is not None else default_cpu
    if o.get("num_gpus"):
        res["GPU"] = float(o["num_gpus"])
    if res.get("GPU"):
        # Whole cards or a fraction below 1 (accelerators.validate_request).
        from ray_tpu_torch import accelerators

        err = accelerators.validate_request(res["GPU"])
        if err is not None:
            raise ValueError(err)
    if o.get("memory"):
        res["memory"] = float(o["memory"])
    return {k: v for k, v in res.items() if v}


class RemoteFunction:
    def __init__(self, fn, options: dict):
        self._fn = fn
        self._options = options
        self._exported_key: Optional[str] = None
        self._fn_blob: Optional[bytes] = None
        self._renv_cache: Optional[dict] = None  # processed runtime_env
        self.__name__ = getattr(fn, "__name__", "anonymous")

    def options(self, **overrides):
        bad = set(overrides) - _VALID_OPTIONS
        if bad:
            raise ValueError(f"invalid options: {bad}")
        merged = {**self._options, **overrides}
        rf = RemoteFunction(self._fn, merged)
        rf._fn_blob = self._fn_blob
        return rf

    def _renv(self):
        # Options are immutable per instance: package the working_dir once,
        # not once per .remote(); the KV upload re-ensures per cluster.
        if self._renv_cache is None:
            self._renv_cache = {}
        return _process_runtime_env(
            self._options.get("runtime_env"), self._renv_cache
        )

    def remote(self, *args, **kwargs):
        _ensure_init()
        if self._fn_blob is None:
            self._fn_blob = cloudpickle.dumps(self._fn)
        key = _export(self._fn_blob, "fn")
        o = self._options
        task_id = TaskID.from_random()
        num_returns = o.get("num_returns", 1)
        streaming = num_returns == "streaming" or num_returns == "dynamic"
        n_ret = 1 if streaming else num_returns
        return_ids = [
            ObjectID.for_task_return(task_id, i) for i in range(n_ret)
        ]
        args_blob, arg_ids, args_ref = _pack_args(args, kwargs)
        cfg = get_config()
        spec = {
            "task_id": task_id.binary(),
            "name": o.get("name") or self.__name__,
            "func_key": key,
            "args": args_blob,
            "args_ref": args_ref,
            "arg_ids": arg_ids,
            "num_returns": "streaming" if streaming else num_returns,
            "return_ids": [r.binary() for r in return_ids],
            "resources": _resources_from_options(o),
            "strategy": _strategy_wire(o.get("scheduling_strategy")),
            "max_retries": o.get("max_retries", cfg.default_task_max_retries),
            "retry_exceptions": bool(o.get("retry_exceptions", False)),
            "runtime_env": self._renv(),
        }
        _inject_trace(spec)
        # Submission is pipelined AND batched — and, when a task lease is
        # held, routed straight to a leased worker's peer server with no
        # head traffic at all (reference: task submission is async; errors
        # surface on ray.get of the returned ref).
        ctx.client.submit_task(spec)
        if streaming:
            return ObjectRefGenerator(task_id.binary())
        refs = [ObjectRef(r) for r in return_ids]
        return refs[0] if n_ret == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{self.__name__}' cannot be called directly; "
            f"use {self.__name__}.remote()."
        )


# -------------------------------------------------------------------- actors


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name
        self._options: dict = {}

    def options(self, **overrides):
        m = ActorMethod(self._handle, self._name)
        m._options = {**self._options, **overrides}
        return m

    def remote(self, *args, **kwargs):
        return self._handle._submit(self._name, args, kwargs, self._options)

    def bind(self, *upstreams):
        """Wire this method as a compiled-DAG step; multiple upstream nodes
        become the method's positional args (reference: dag/dag_node.py
        bind)."""
        from ..dag.compiled import bind as _dag_bind

        return _dag_bind(self, *upstreams)


class ActorHandle:
    def __init__(self, actor_id: ActorID, method_names: List[str],
                 max_task_retries: int = 0, class_name: str = "",
                 method_defaults: Optional[dict] = None):
        self._actor_id = actor_id
        self._method_names = method_names
        self._max_task_retries = max_task_retries
        self._class_name = class_name
        # Per-method option defaults from @ray_tpu_torch.method annotations
        # (num_returns today); call-time .options() overrides them.
        self._method_defaults = method_defaults or {}

    def __getattr__(self, name):
        if name.startswith("_") and name != "__rt_dag_exec_loop__":
            raise AttributeError(name)
        if name not in self._method_names:
            raise AttributeError(
                f"actor {self._class_name} has no method {name!r}"
            )
        return ActorMethod(self, name)

    def _submit(self, method_name: str, args, kwargs, options: dict):
        _ensure_init()
        task_id = TaskID.from_random()
        defaults = self._method_defaults.get(method_name, {})
        num_returns = options.get(
            "num_returns", defaults.get("num_returns", 1))
        streaming = num_returns == "streaming"
        n_ret = 1 if streaming else num_returns
        return_ids = [ObjectID.for_task_return(task_id, i) for i in range(n_ret)]
        args_blob, arg_ids, args_ref = _pack_args(args, kwargs)
        spec = {
            "task_id": task_id.binary(),
            "actor_id": self._actor_id.binary(),
            "method_name": method_name,
            "name": f"{self._class_name}.{method_name}",
            "args": args_blob,
            "args_ref": args_ref,
            "arg_ids": arg_ids,
            "num_returns": "streaming" if streaming else num_returns,
            "return_ids": [r.binary() for r in return_ids],
            "max_retries": self._max_task_retries,
        }
        if options.get("concurrency_group") is not None:
            # Per-call group override (reference:
            # actor.py ActorMethod.options(concurrency_group=...)).
            spec["concurrency_group"] = options["concurrency_group"]
        _inject_trace(spec)
        # Peer-direct once the actor's address is resolved (the head sees
        # only liveness/telemetry, not per-call traffic); head-mediated
        # before that and on any peer-plane failure.
        ctx.client.submit_actor_task(spec)
        if streaming:
            return ObjectRefGenerator(task_id.binary())
        refs = [ObjectRef(r) for r in return_ids]
        return refs[0] if n_ret == 1 else refs

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._method_names, self._max_task_retries,
             self._class_name, self._method_defaults),
        )

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"


class ActorClass:
    def __init__(self, cls, options: dict):
        self._cls = cls
        self._options = options
        self._cls_blob: Optional[bytes] = None
        self._renv_cache: Optional[dict] = None  # processed runtime_env
        self.__name__ = cls.__name__

    def options(self, **overrides):
        bad = set(overrides) - _VALID_OPTIONS
        if bad:
            raise ValueError(f"invalid options: {bad}")
        ac = ActorClass(self._cls, {**self._options, **overrides})
        ac._cls_blob = self._cls_blob
        return ac

    def _renv(self):
        if self._renv_cache is None:
            self._renv_cache = {}
        return _process_runtime_env(
            self._options.get("runtime_env"), self._renv_cache
        )

    def remote(self, *args, **kwargs) -> ActorHandle:
        _ensure_init()
        if self._cls_blob is None:
            self._cls_blob = cloudpickle.dumps(self._cls)
        key = _export(self._cls_blob, "cls")
        o = self._options
        cfg = get_config()
        actor_id = ActorID.from_random()
        task_id = TaskID.from_random()
        args_blob, arg_ids, args_ref = _pack_args(args, kwargs)
        method_names = [
            n for n, _ in inspect.getmembers(self._cls, callable)
            if not n.startswith("__") or n == "__rt_dag_exec_loop__"
        ]
        creation_task = {
            "task_id": task_id.binary(),
            "name": f"{self.__name__}.__init__",
            "func_key": key,
            "args": args_blob,
            "args_ref": args_ref,
            "arg_ids": arg_ids,
            "num_returns": 1,
            "return_ids": [ObjectID.for_task_return(task_id, 0).binary()],
            # Actors reserve no CPU by default (matching the reference:
            # actors get a dedicated worker process, not a CPU slot).
            "resources": _resources_from_options(o, default_cpu=0.0),
            "strategy": _strategy_wire(o.get("scheduling_strategy")),
            "max_retries": 0,
            "is_actor_creation": True,
            "actor_id": actor_id.binary(),
            "max_concurrency": o.get("max_concurrency", 1),
            "runtime_env": self._renv(),
        }
        groups = o.get("concurrency_groups")
        # Scan @ray_tpu_torch.method annotations regardless of class options so a
        # group annotation without a declared group errors loudly instead
        # of silently losing its isolation (matching the reference).
        method_groups: Dict[str, str] = {}
        method_defaults: Dict[str, dict] = {}
        for n in method_names:
            fn = getattr(self._cls, n, None)
            opts = getattr(fn, "__rt_method_options__", None) \
                if fn is not None else None
            if not opts:
                continue
            g = opts.get("concurrency_group")
            if g is not None:
                if not groups or g not in groups:
                    raise ValueError(
                        f"method {n!r} declares concurrency group {g!r} "
                        "but the class does not declare it in "
                        "@remote(concurrency_groups={...})")
                method_groups[n] = g
            if opts.get("num_returns") is not None:
                method_defaults[n] = {"num_returns": opts["num_returns"]}
        if groups:
            # Named concurrency groups: per-group execution limits
            # (reference: concurrency_group_manager.h).
            if not all(isinstance(v, int) and v >= 1
                       for v in groups.values()):
                raise ValueError(
                    "concurrency_groups values must be ints >= 1")
            creation_task["concurrency_groups"] = dict(groups)
            creation_task["method_groups"] = method_groups
        if o.get("execute_out_of_order"):
            # Opt-in unordered DISPATCH: dependency-ready tasks may run
            # before earlier-submitted tasks still waiting on arguments, so
            # completion (and effect) order may differ from submission
            # order.  Execution concurrency is still bounded by
            # max_concurrency (reference: out_of_order_actor_submit_queue.h
            # reorders the submit queue without widening the pool).
            creation_task["execute_out_of_order"] = True
        spec = {
            "actor_id": actor_id.binary(),
            "class_name": self.__name__,
            "name": o.get("name"),
            "namespace": o.get("namespace", ctx.namespace),
            "max_restarts": o.get("max_restarts", cfg.default_actor_max_restarts),
            "max_task_retries": o.get("max_task_retries", 0),
            "method_names": method_names,
            "method_defaults": method_defaults,
            "lifetime": o.get("lifetime"),
            "creation_task": creation_task,
        }
        # Constructor args may be locally-cached direct-call results: the
        # head must know them before it dep-tracks the creation task.
        ctx.client.ensure_args_shared(creation_task)
        ctx.client.call("create_actor", spec)
        # Pre-warm the direct route: the ALIVE broadcast carries the
        # hosting worker's peer address and the client dials during
        # creation dispatch, not on the first call.
        ctx.client.prepare_actor_route(actor_id.binary())
        return ActorHandle(
            actor_id, method_names, spec["max_task_retries"], self.__name__,
            method_defaults,
        )

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote()."
        )


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    _ensure_init()
    reply = ctx.client.call("get_actor_by_name", {"name": name})
    if not reply["found"]:
        tomb = reply.get("tombstone")
        if tomb:
            raise ValueError(f"actor {name!r}: {tomb}")
        raise ValueError(f"no actor with name {name!r}")
    spec = reply["spec"]
    return ActorHandle(
        ActorID(reply["actor_id"]),
        spec["method_names"],
        spec.get("max_task_retries", 0),
        spec.get("class_name", ""),
        spec.get("method_defaults"),
    )


def list_named_actors() -> List[str]:
    _ensure_init()
    return ctx.client.call("list_named_actors")["names"]


# ------------------------------------------------------------------ decorator


def remote(*args, **options):
    """@remote decorator for functions and classes."""
    bad = set(options) - _VALID_OPTIONS
    if bad:
        raise ValueError(f"invalid @remote options: {bad}")

    def wrap(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, options)
        return RemoteFunction(obj, options)

    if len(args) == 1 and callable(args[0]) and not options:
        return wrap(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return wrap


# ------------------------------------------------------------ placement group


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    """Reserve resource bundles (reference: util/placement_group.py).

    ``lifetime="detached"`` decouples the group from its creator: it
    survives driver disconnect AND head restarts (persisted in the head
    snapshot, like detached named actors)."""
    _ensure_init()
    if lifetime not in (None, "detached"):
        raise ValueError("lifetime must be None or 'detached'")
    pg_id = PlacementGroupID.from_random()
    reply = ctx.client.call(
        "create_placement_group",
        {
            "pg_id": pg_id.binary(),
            "bundles": bundles,
            "strategy": strategy,
            "name": name,
            "lifetime": lifetime,
        },
    )
    pg = PlacementGroup(pg_id, bundles, strategy)
    if reply.get("infeasible_now"):
        # The reference keeps infeasible PGs pending so they are satisfied
        # when nodes join later (gcs_placement_group_manager); warn rather
        # than fail — ready() blocks until the cluster grows (or times out).
        import warnings

        pg.infeasible_now = True
        warnings.warn(
            f"placement group {pg_id.hex()[:8]} does not fit the current "
            f"cluster (bundles={bundles} strategy={strategy}); it will stay "
            "pending until nodes join",
            stacklevel=2,
        )
    # created or queued: either way the handle is valid; ready() blocks.
    return pg


def remove_placement_group(pg: PlacementGroup):
    _ensure_init()
    ctx.client.call("remove_placement_group", {"pg_id": pg.id.binary()})


# ------------------------------------------------------------- introspection


def cluster_resources() -> Dict[str, float]:
    _ensure_init()
    return ctx.client.call("cluster_resources")["resources"]


def available_resources() -> Dict[str, float]:
    _ensure_init()
    return ctx.client.call("available_resources")["resources"]


def nodes() -> List[dict]:
    _ensure_init()
    return ctx.client.call("list_state", {"kind": "nodes"})["items"]


def timeline() -> List[dict]:
    _ensure_init()
    return ctx.client.call("list_state", {"kind": "timeline"})["items"]


def task_events(task_id: Optional[str] = None,
                errors: bool = False) -> List[dict]:
    """Retained per-task lifecycle histories (SUBMITTED/SCHEDULED/RUNNING/
    FINISHED/FAILED transitions with timestamps, placement, and the full
    traceback on failure).  Failed-task records survive worker and node
    death — they live at the head."""
    _ensure_init()
    body: Dict[str, Any] = {"kind": "task_events"}
    if task_id:
        body["task_id"] = task_id
    if errors:
        body["errors"] = True
    return ctx.client.call("list_state", body)["items"]


def iter_log_chunks(call, proc_id: str, offset: int = 0,
                    max_bytes: int = -1, follow: bool = False,
                    poll_s: float = 0.5, chunk_bytes: int = 1 << 20):
    """Yield raw byte chunks of a process's log via repeated ``get_log``
    head RPCs — the one paging loop shared by :func:`get_log` and the CLI.
    ``call`` is any head-RPC callable (``Client.call``).  ``max_bytes >= 0``
    caps the TOTAL bytes yielded, in follow mode too; ``follow=True`` keeps
    polling a live process and stops once it is dead and drained."""
    off, remaining = offset, max_bytes
    while True:
        want = chunk_bytes if remaining < 0 else min(chunk_bytes, remaining)
        if want == 0:
            return
        reply = call(
            "get_log", {"proc_id": proc_id, "offset": off, "max_bytes": want}
        )
        if not reply.get("found"):
            raise RuntimeError(reply.get("error", f"no log for {proc_id!r}"))
        data = reply.get("data") or b""
        if data:
            off = reply.get("next_offset", off + len(data))
            if remaining > 0:
                remaining -= len(data)
            yield data
        if follow:
            if not data:
                if not reply.get("alive", False):
                    return  # dead and drained: nothing more can arrive
                time.sleep(poll_s)
        elif reply.get("eof", True) or not data:
            return


def get_log(proc_id: str, offset: int = 0, max_bytes: int = -1,
            follow: bool = False):
    """Fetch a process's log through the head's cluster log index — works
    from any machine, for live AND exited processes (crash post-mortems).

    ``proc_id`` is a worker/node id (hex, unique prefix ok), an actor id
    (resolves to its hosting worker), or a pid.  A negative ``offset``
    addresses from the end of the file (tail).  ``max_bytes=-1`` reads to
    EOF; ``max_bytes >= 0`` caps the total bytes read (follow included).
    With ``follow=True`` returns a generator that yields text chunks as
    the process writes (stops once the process is dead and the file is
    drained)."""
    _ensure_init()
    chunks = iter_log_chunks(ctx.client.call, proc_id, offset, max_bytes,
                             follow)
    if follow:
        return (c.decode("utf-8", "replace") for c in chunks)
    return b"".join(chunks).decode("utf-8", "replace")


def stack_dump(worker_id: str, timeout: float = 10.0) -> str:
    """All-thread Python stacks from a live worker (id/prefix, or an actor
    id), collected without interrupting the running task — the first tool
    to reach for when a gang hangs in a collective."""
    _ensure_init()
    reply = ctx.client.call(
        "stack_dump", {"worker_id": worker_id, "timeout": timeout},
        timeout=timeout + 30,
    )
    if not reply.get("found") or not reply.get("ok"):
        raise RuntimeError(reply.get("error", "stack dump failed"))
    return reply["dump"]
