"""Worker process: executes tasks and hosts actor instances.

Role-equivalent to the reference's worker-side core worker
(reference: src/ray/core_worker/core_worker.h:350 RunTaskExecutionLoop,
transport/task_receiver.h, concurrency_group_manager.h for actor
concurrency, _raylet.pyx:1693 execute_task) — re-designed: tasks arrive as
pushes over one ordered connection from the control plane (which gives
per-actor FIFO for free), execution happens on a thread pool (or an asyncio
loop for async actors), results go inline or to node shared memory.

Workers are spawned with CUDA_VISIBLE_DEVICES="" so they never take a card
from the process that owns it; a task opts into cards by requesting
{"GPU": n} (``num_gpus=n``), and the worker sets CUDA_VISIBLE_DEVICES to the
granted IDs at task start (accelerators.apply_visibility; the reference does
the same with CUDA_VISIBLE_DEVICES for its GPU workers).
"""

from __future__ import annotations

import asyncio
import ctypes
import inspect
import os
import queue
import sys
import threading
import time
import traceback
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import cloudpickle

from .. import exceptions
from . import serialization
from ..devtools.locks import guarded, make_lock
from .client import Client
from .config import get_config, tmp_root
from .context import ctx
from .ids import ActorID, ObjectID, TaskID
from .object_ref import ObjectRef, _TopLevelRef

_DEBUG_PUSH = bool(os.environ.get("RT_DEBUG_PUSH"))


@guarded
class _LogTee:
    """Mirrors a worker stream to the driver via pubsub (reference:
    _private/log_monitor.py tails worker logs and republishes to the driver
    over GCS pubsub; here the worker pushes lines itself)."""

    # print() runs on every task thread concurrently: the line buffer AND
    # the in-flight publish window are shared state (rtlint RT007;
    # RT_DEBUG_LOCKS=2 asserts the guards at runtime).
    _RT_GUARDED_BY = {
        "_buf": "_buf_lock",
        "_inflight": "_buf_lock",
        "dropped": "_buf_lock",
    }

    def __init__(self, stream, client, kind: str):
        self._stream = stream
        self._client = client
        self._kind = kind
        self._buf = ""
        self._buf_lock = make_lock("worker.log_tee")
        self._local = threading.local()
        # Own in-flight window: log lines must never poison the client's
        # shared bg-error channel or block a task — past the window they
        # drop (the log file keeps the full copy).
        self._inflight: list = []
        self.dropped = 0
        self._drop_counter = None  # resolved lazily, once, on first drop

    def write(self, s):
        n = self._stream.write(s)
        if getattr(self._local, "publishing", False):
            return n  # a publish-path print must not recurse
        lines = []
        with self._buf_lock:
            self._buf += s
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                if line.strip():
                    lines.append(line)
        for line in lines:
            self._local.publishing = True
            try:
                with self._buf_lock:
                    self._inflight = [
                        f for f in self._inflight if not f.done()
                    ]
                    drop = len(self._inflight) >= 200
                    if drop:
                        self.dropped += 1
                if drop:
                    # Head is behind: drop rather than block — but visibly
                    # (the drop count ships with the process metrics, so a
                    # chatty worker outrunning the head is diagnosable).
                    try:
                        if self._drop_counter is None:
                            from ray_tpu_torch.util.metrics import get_counter

                            self._drop_counter = get_counter(
                                "ray_tpu_logs_dropped_total",
                                "worker log lines dropped past the "
                                "in-flight publish window (the log file "
                                "keeps them)",
                                tag_keys=("stream",),
                            )
                        self._drop_counter.inc(tags={"stream": self._kind})
                    except Exception:
                        pass
                    continue
                fut = self._client.rpc.call_async(
                    "publish", {
                        "topic": "worker_logs",
                        "data": {"pid": os.getpid(), "stream": self._kind,
                                 "actor": ctx.current_actor_id.hex()[:8]
                                 if ctx.current_actor_id else None,
                                 "line": line},
                    }
                )
                with self._buf_lock:
                    self._inflight.append(fut)
            except Exception:
                pass
            finally:
                self._local.publishing = False
        return n

    def flush(self):
        self._stream.flush()

    def flush_residual(self, timeout: float = 1.0):
        """Ship a trailing partial line (no newline) at worker shutdown —
        without this, a final ``print(..., end="")`` before exit never
        reaches the driver."""
        with self._buf_lock:
            line, self._buf = self._buf, ""
        if not line.strip():
            return
        self._local.publishing = True
        try:
            self._client.rpc.call_async("publish", {
                "topic": "worker_logs",
                "data": {"pid": os.getpid(), "stream": self._kind,
                         "actor": ctx.current_actor_id.hex()[:8]
                         if ctx.current_actor_id else None,
                         "line": line},
            }).result(timeout=timeout)
        except Exception:
            pass
        finally:
            self._local.publishing = False

    def __getattr__(self, name):
        return getattr(self._stream, name)


@guarded
class Worker:
    # rtlint RT007 verifies these statically; RT_DEBUG_LOCKS=2 asserts the
    # guards on field rebinds at runtime (devtools.locks).
    _RT_GUARDED_BY = {
        "direct_streams": "_streams_lock",
        "_direct_replies": "_direct_replies_lock",
        "_direct_replies_scheduled": "_direct_replies_lock",
        "_reconnecting": "_reconnect_guard",
        "_done_cache": "_dedup_lock",
        "_dedup_running": "_dedup_lock",
    }
    # Intentional cross-thread handoffs, vetted per CONTRIBUTING's
    # thread-role model: each is either ordered by the task queue (the
    # actor-creation task strictly precedes any concurrently-dispatched
    # method call) or a GIL-atomic monotonic best-effort signal.
    _RT_UNGUARDED = {
        "fn_cache": "content-addressed idempotent cache: a racing double "
                    "load stores the same value twice",
        "actor_creation_spec": "written by the actor-creation task (task "
                               "queue orders it before method dispatch); "
                               "the reconnect thread only reads it",
        "running_threads": "GIL-atomic dict set/pop keyed by task_id; "
                           "readers (cancel, stack dump) are best-effort",
        "cancelled": "GIL-atomic monotonic set.add; a cancel losing the "
                     "race is indistinguishable from arriving late",
        "actor_instance": "written by the actor-creation task, which the "
                          "task queue orders before any method dispatch",
        "actor_id": "creation-ordered (see actor_instance); the peer "
                    "server treats a mid-boot None as a stale route",
        "max_concurrency": "creation-ordered (see actor_instance)",
        "out_of_order": "creation-ordered (see actor_instance)",
        "method_groups": "creation-ordered (see actor_instance)",
        "_group_limits": "creation-ordered (see actor_instance)",
        "group_pools": "creation-ordered (see actor_instance)",
        "async_loop": "only the run-loop thread dispatches async methods, "
                      "so the lazy loop boot never races itself",
        "_async_group_sems": "dispatched from the run-loop thread only "
                             "(see async_loop)",
    }

    def __init__(self):
        from .node_main import own_log_path
        from .rpc import RpcServer, ServerThread

        self.head_addr = os.environ["RT_HEAD_ADDR"]
        self.node_id = bytes.fromhex(os.environ["RT_NODE_ID"])
        self.worker_id = os.urandom(16)
        # Peer RPC server: the direct-dataplane endpoint.  Drivers (and
        # other workers) submit actor calls and leased tasks HERE, never
        # through the head (reference: core_worker.proto PushTask — core
        # workers push tasks to each other directly).  Started before
        # registration so the head learns the address atomically with the
        # worker record; zygote-forked workers therefore come up with a
        # live peer endpoint before their first lease/call.
        self.direct_streams: Dict[bytes, dict] = {}
        # Stream state is shared between the peer-server loop (submit /
        # item pulls) and the executing task's thread (item appends,
        # completion marks): every direct_streams access holds this.
        self._streams_lock = make_lock("worker.streams")
        peer_host = os.environ.get("RT_PEER_HOST", "127.0.0.1")
        self.peer_server = RpcServer(host=peer_host, name="peer-server")
        self.peer_server.register("peer_submit", self.h_peer_submit)
        self.peer_server.register("peer_next_stream_item",
                                  self.h_peer_next_stream_item)
        self.peer_server.register("peer_cancel", self.h_peer_cancel)
        self.peer_thread = ServerThread(self.peer_server)
        peer_port = self.peer_thread.start()
        # Direct-reply coalescing: completions buffer here and one
        # call_soon_threadsafe per batch wakes the peer loop (the self-pipe
        # wakeup is a syscall; per-completion wakeups would bound direct
        # throughput at ~1k/s on virtualised kernels).
        self._direct_replies: list = []
        self._direct_replies_lock = make_lock("worker.direct_replies")
        self._direct_replies_scheduled = False
        self.client = Client(
            self.head_addr,
            kind="worker",
            worker_id=self.worker_id,
            node_id=self.node_id,
            pid=os.getpid(),
            # Object writes go under this worker's node store session (set
            # by the node daemon / head spawner), not the head's.
            session=os.environ.get("RT_SESSION"),
            # Cluster log index entry: `get_log` serves this file from any
            # machine, even after this process dies.
            log_path=own_log_path(),
            peer_addr=f"{peer_host}:{peer_port}",
        )
        ctx.client = self.client
        ctx.mode = "worker"
        ctx.session = self.client.session
        ctx.worker_id = self.worker_id

        self.task_queue: "queue.Queue" = queue.Queue()
        self.fn_cache: Dict[str, Any] = {}
        self.actor_instance = None
        # Retained actor-creation spec: the field-state report this worker
        # carries when it re-registers with a restarted head — enough for
        # the head to rebuild a full-fidelity ActorRecord (adoption) for
        # the live actor instead of recreating it fresh.
        self.actor_creation_spec: Optional[dict] = None
        self.actor_id: Optional[bytes] = None
        self.max_concurrency = 1
        self.pool: Optional[ThreadPoolExecutor] = None
        self.group_pools: Dict[str, ThreadPoolExecutor] = {}
        self.method_groups: Dict[str, str] = {}
        self._group_limits: Dict[str, int] = {}
        self._async_group_sems: Dict[str, Any] = {}
        self.out_of_order = False
        self.async_loop: Optional[asyncio.AbstractEventLoop] = None
        self.running_threads: Dict[bytes, int] = {}  # task_id -> thread ident
        self.cancelled: set = set()
        # Duplicate-delivery dedup: retries and re-routes (a direct call
        # degraded to the head path after its reply was lost, a head
        # re-dispatch across a partition) may deliver the SAME task_id
        # twice.  Completed results are cached (bounded, oldest-first
        # eviction) and replayed instead of re-executed; a duplicate of a
        # STILL-RUNNING task parks until the original completes
        # (reference: task_id-keyed dedup in the reference's actor task
        # submission — the receiver, not the network, owns exactly-once).
        self._dedup_lock = make_lock("worker.dedup")
        self._done_cache: "OrderedDict[bytes, dict]" = OrderedDict()
        self._dedup_running: Dict[bytes, list] = {}
        self._shutdown = threading.Event()

        def _on_exec(spec):
            if _DEBUG_PUSH:
                print(f"PUSH execute_task {spec.get('name')} "
                      f"{spec['task_id'].hex()[:8]}", file=sys.stderr,
                      flush=True)
            self.task_queue.put(spec)

        self.client.rpc.on_push("execute_task", _on_exec)
        self.client.rpc.on_push("cancel", self._on_cancel)
        self.client.rpc.on_push("shutdown", lambda b: self._shutdown.set())
        # Head-initiated kill: exit through the clean-shutdown drain (log
        # tees' trailing partial line + final metrics window) instead of a
        # bare os._exit that drops them.  On a fresh thread — the drain
        # fires RPCs and must not run on (and block) the rpc loop itself.
        self.client.rpc.on_push(
            "exit",
            lambda b: threading.Thread(
                target=self._exit_with_drain, args=(1,), daemon=True,
                name="exit-drain",
            ).start(),
        )
        # Liveness probe: ack from the rpc loop thread (call_async is safe
        # there; a blocking call would deadlock the loop).  A wedged
        # interpreter stops acking and the head reaps us.
        self.client.rpc.on_push(
            "health_check",
            lambda b: self.client.rpc.call_async("health_ack", {}),
        )
        # On-demand introspection: dump all-thread Python stacks without
        # touching the running task (collection happens on the rpc loop
        # thread — the tool you reach for when a gang hangs in a
        # collective; reference: `ray stack` attaches py-spy, here the
        # worker cooperates via sys._current_frames).
        self.client.rpc.on_push("stack_dump", self._on_stack_dump)
        # On-demand profiler capture (`ray_tpu_torch profile`): same token round
        # trip as stack_dump, but the capture sleeps for N seconds — it
        # runs on a fresh thread so the rpc loop keeps serving pushes.
        self.client.rpc.on_push("profile", self._on_profile)
        # Headless degraded mode: a lost head connection starts a reconnect
        # loop instead of killing the process — in-flight tasks, direct
        # peer calls, and peer streaming keep executing; completion reports
        # buffer in the client and replay at re-register.  The deadline
        # guarantees an orphaned worker (head never restarted) still dies.
        self._reconnect_guard = make_lock("worker.reconnect_guard")
        self._reconnecting = False
        self.client.resync_payload = self._resync_payload
        self.client.rpc.on_connection_lost = self._on_head_lost
        # Stream this worker's stdout/stderr to the driver (log files keep
        # the full copy); RT_LOG_TO_DRIVER=0 disables.
        if os.environ.get("RT_LOG_TO_DRIVER", "1") != "0":
            sys.stdout = _LogTee(sys.stdout, self.client, "stdout")
            sys.stderr = _LogTee(sys.stderr, self.client, "stderr")
        # Device-memory accounting: ship a util/devmem snapshot on the
        # metrics cadence.  Nothing is reported until the process has
        # imported torch and initialised CUDA (devmem.maybe_snapshot), so
        # CPU-only task workers pay nothing and never load torch for it.
        threading.Thread(target=self._devmem_loop, daemon=True,
                         name="devmem-report").start()
        # Handshake: only now may the head lease us (push handlers installed).
        self.client.call("worker_ready", {})

    # ---------------------------------------------------------------- loading

    def _load(self, key: str):
        obj = self.fn_cache.get(key)
        if obj is None:
            blob = self._load_blob_cached(key)
            if blob is None:
                raise RuntimeError(f"function table has no entry {key}")
            obj = cloudpickle.loads(blob)
            self.fn_cache[key] = obj
        return obj

    def _load_blob_cached(self, key: str):
        """Function-table blob with a node-local content-addressed file
        cache: an actor burst forks many fresh workers that all need the
        same class blob — the first fetch pays the head roundtrip, the
        rest read the session's cache dir (reference:
        gcs_function_manager.h function table + the runtime-env URI cache
        pattern).  Session-scoped so the head's teardown sweep bounds
        growth and concurrent clusters/users never share a directory."""
        import hashlib

        session = getattr(self.client, "session", None) or "default"
        cdir = os.path.join(tmp_root("fncache"), session)
        path = os.path.join(
            cdir, hashlib.sha1(key.encode()).hexdigest()[:24])
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            pass
        blob = self.client.kv_get(key)
        if blob is not None:
            try:
                os.makedirs(cdir, exist_ok=True)
                tmp = f"{path}.tmp-{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.rename(tmp, path)
            except OSError:
                pass
        return blob

    def _resolve_args(self, spec) -> tuple:
        if spec.get("args_ref") is not None:
            oid = ObjectID(spec["args_ref"])
            # Through get(): local-store hits and lost-object recovery apply
            # to spilled-arg payloads just like user-level gets.
            args, kwargs = self.client.get([ObjectRef(oid, owned=False)])[0]
        else:
            args, kwargs = serialization.unpack(spec["args"])
        # Resolve top-level refs to values.
        fetch = [a.raw for a in args if isinstance(a, _TopLevelRef)]
        fetch += [v.raw for v in kwargs.values() if isinstance(v, _TopLevelRef)]
        if fetch:
            refs = [ObjectRef(ObjectID(raw), owned=False) for raw in fetch]
            values = dict(zip(fetch, self.client.get(refs)))
            args = tuple(
                values[a.raw] if isinstance(a, _TopLevelRef) else a for a in args
            )
            kwargs = {
                k: values[v.raw] if isinstance(v, _TopLevelRef) else v
                for k, v in kwargs.items()
            }
        return args, kwargs

    def _setup_py_modules(self, keys) -> list:
        """Extract content-addressed module archives and put their import
        roots on sys.path (reference: runtime_env/py_modules.py — each
        module ships as its own URI-cached package)."""
        import io
        import zipfile

        roots = []
        for key in keys:
            _, name, digest = key.split(":", 2)
            root = os.path.join(tmp_root("pymod"), digest)
            dest = os.path.join(root, name)
            if not os.path.isdir(dest):
                blob = self.client.kv_get(key)
                if blob is None:
                    raise RuntimeError(f"py_module archive {key} not found")
                tmp = dest + f".tmp-{os.getpid()}"
                with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                    zf.extractall(tmp)
                os.makedirs(root, exist_ok=True)
                try:
                    os.rename(tmp, dest)
                except OSError:  # raced another worker: theirs is identical
                    import shutil

                    shutil.rmtree(tmp, ignore_errors=True)
            if root not in sys.path:
                sys.path.insert(0, root)
                roots.append(root)
        return roots

    def _setup_pip_env(self, pip_env: dict):
        """Build (once, content-addressed) and activate a per-env venv
        (reference: _private/runtime_env/pip.py — virtualenv per env hash,
        uri_cache.py for reuse).  The venv is created with
        --system-site-packages so framework deps stay importable; shipped
        wheel files install with --no-index (zero-egress clusters), named
        requirements go through pip's normal resolution.  Activation
        prepends the venv's site-packages to sys.path and exports
        VIRTUAL_ENV/PATH for user subprocesses; returns the site dir (the
        caller treats it like a py_modules root: removed + module-evicted
        on task teardown)."""
        import fcntl
        import subprocess
        import venv as venv_mod

        env_hash = pip_env["hash"]
        root = os.path.join(tmp_root("envs"), env_hash)
        venv_dir = os.path.join(root, "venv")
        site = os.path.join(
            venv_dir, "lib",
            f"python{sys.version_info[0]}.{sys.version_info[1]}",
            "site-packages",
        )
        ready = os.path.join(root, "READY")  # -> (site_dir, venv_dir)
        if not os.path.exists(ready):
            os.makedirs(root, exist_ok=True)
            with open(os.path.join(root, ".lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not os.path.exists(ready):
                    venv_mod.create(venv_dir, system_site_packages=True,
                                    with_pip=False, symlinks=True)
                    os.makedirs(site, exist_ok=True)
                    wheel_dir = os.path.join(root, "wheels")
                    os.makedirs(wheel_dir, exist_ok=True)
                    for key, base in pip_env.get("wheel_keys", []):
                        blob = self.client.kv_get(key)
                        if blob is None:
                            raise RuntimeError(
                                f"pip wheel {key} not found in cluster KV")
                        with open(os.path.join(wheel_dir, base), "wb") as f:
                            f.write(blob)
                    args, all_local = [], True
                    for entry in pip_env["reqs"]:
                        if entry[0] == "file":
                            args.append(os.path.join(wheel_dir, entry[1]))
                        else:
                            args.append(entry[1])
                            all_local = False
                    if args:
                        cmd = [sys.executable, "-m", "pip", "install",
                               "--quiet", "--target", site,
                               "--find-links", wheel_dir]
                        if all_local:
                            cmd.append("--no-index")
                        proc = subprocess.run(
                            cmd + args, capture_output=True, text=True,
                            timeout=600,
                        )
                        if proc.returncode != 0:
                            raise RuntimeError(
                                f"pip env build failed:\n{proc.stderr[-2000:]}")
                    with open(ready, "w") as f:
                        f.write("ok")
        if site not in sys.path:
            sys.path.insert(0, site)
        return site, venv_dir

    def _setup_conda_env(self, conda_env: dict):
        """Create (once, content-addressed) and activate a conda env
        (reference: _private/runtime_env/conda.py:260 — env created from a
        spec dict via the conda CLI, cached by content hash; named envs
        activate in place).  Activation mirrors the pip path: the env's
        site-packages joins sys.path (module eviction on teardown) and
        bin/ prepends PATH for subprocesses; the worker's interpreter is
        NOT swapped — a different-python conda env carries its packages,
        not its binary (documented limitation; the reference execs the
        env's python for that).  Returns (site_dir_or_None, prefix)."""
        import fcntl
        import glob as _glob
        import shutil
        import subprocess

        conda = shutil.which("conda")
        if conda is None:
            raise RuntimeError(
                "runtime_env['conda'] requested but no `conda` executable "
                "is on PATH for the worker")
        if "name" in conda_env:
            name = conda_env["name"]
            if os.path.isdir(name):
                prefix = name
            else:
                root = subprocess.run(
                    [conda, "info", "--base"], capture_output=True,
                    text=True, timeout=60,
                ).stdout.strip()
                prefix = os.path.join(root, "envs", name)
            if not os.path.isdir(prefix):
                raise RuntimeError(f"conda env {name!r} not found")
        else:
            env_hash = conda_env["hash"]
            root = os.path.join(tmp_root("envs"), f"conda-{env_hash}")
            prefix = os.path.join(root, "env")
            ready = os.path.join(root, "READY")
            if not os.path.exists(ready):
                os.makedirs(root, exist_ok=True)
                with open(os.path.join(root, ".lock"), "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not os.path.exists(ready):
                        spec_path = os.path.join(root, "environment.json")
                        with open(spec_path, "w") as f:
                            f.write(conda_env["spec"])
                        proc = subprocess.run(
                            [conda, "env", "create", "-p", prefix,
                             "-f", spec_path, "--yes"],
                            capture_output=True, text=True, timeout=1800,
                        )
                        if proc.returncode != 0:
                            raise RuntimeError(
                                "conda env create failed:\n"
                                f"{proc.stderr[-2000:]}")
                        with open(ready, "w") as f:
                            f.write("ok")
        sites = _glob.glob(os.path.join(
            prefix, "lib", "python*", "site-packages"))
        site = sites[0] if sites else None
        if site is not None and site not in sys.path:
            sys.path.insert(0, site)
        return site, prefix

    def _setup_working_dir(self, key: str):
        """Extract a content-addressed working_dir archive (cached per key)
        and enter it (reference: runtime_env/working_dir.py — URI-cached
        package, extracted and prepended to sys.path)."""
        dest = os.path.join(tmp_root("wd"), key.split(":", 1)[1])
        if not os.path.isdir(dest):
            import io
            import zipfile

            blob = self.client.kv_get(key)
            if blob is None:
                raise RuntimeError(f"working_dir archive {key} not found")
            tmp = dest + f".tmp-{os.getpid()}"
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(tmp)
            try:
                os.rename(tmp, dest)
            except OSError:  # raced another worker: theirs is identical
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        os.chdir(dest)
        if dest not in sys.path:
            sys.path.insert(0, dest)
        return dest

    # -------------------------------------------------------------- reporting

    def _store_value(self, oid: ObjectID, value) -> dict:
        cfg = get_config()
        meta, buffers = serialization.serialize(value)
        size = serialization.packed_size(meta, buffers)
        if size <= cfg.inline_object_max_bytes:
            blob = bytearray(size)
            serialization.pack_into(meta, buffers, memoryview(blob))
            return {"object_id": oid.binary(), "inline": bytes(blob)}
        buf = self.client.store().create(oid, size)
        serialization.pack_into(meta, buffers, buf)
        return {"object_id": oid.binary(), "size": size}

    def _report_done(self, spec, returns=None, error=None, retryable=False,
                     error_repr="", error_tb="", stream_count=0,
                     _replay=False):
        parked: list = []
        if not _replay:
            with self._dedup_lock:
                if error is None or not retryable:
                    # Retryable errors are NOT cached: the head re-issues a
                    # failed-retryable task under the SAME task_id, and a
                    # cached error would wrongly short-circuit the retry.
                    self._done_cache[spec["task_id"]] = {
                        "returns": returns or [], "error": error,
                        "retryable": retryable, "error_repr": error_repr,
                        "error_tb": error_tb, "stream_count": stream_count,
                    }
                    while len(self._done_cache) > 1024:
                        self._done_cache.popitem(last=False)
                parked = self._dedup_running.pop(spec["task_id"], [])
        direct_reply = spec.pop("_direct_reply", None)
        if direct_reply is not None:
            self._reply_direct(spec, direct_reply, returns or [], error,
                               retryable, error_repr, error_tb, stream_count)
        else:
            body = {
                "task_id": spec["task_id"],
                "returns": returns or [],
                "stream_count": stream_count,
            }
            if error is not None:
                body["error"] = error
                body["retryable"] = retryable
                body["error_repr"] = error_repr
                # Full traceback text: retained in the head's task-event
                # history so post-hoc debugging doesn't need the (possibly
                # unserializable or already-freed) exception object.
                body["error_tb"] = error_tb
                body["returns"] = [
                    {"object_id": raw} for raw in spec.get("return_ids", [])
                ]
            try:
                # Pipelined + batched: the worker moves on without a round
                # trip, and a burst of completions coalesces into one head
                # RPC; the run loop flushes when its queue drains
                # (reference: PushTask replies carry results
                # asynchronously).
                self.client.call_batched("task_done", body)
                if self.task_queue.empty():
                    # No follow-up work: the caller is blocking on this
                    # result.
                    self.client._flush_submit_batch()
                if _DEBUG_PUSH:
                    print(f"DONE-SENT {spec.get('name')} "
                          f"{spec['task_id'].hex()[:8]}", file=sys.stderr,
                          flush=True)
            except Exception:
                if _DEBUG_PUSH:
                    print(f"DONE-FAIL {spec.get('name')}: "
                          f"{traceback.format_exc()}", file=sys.stderr,
                          flush=True)
                os._exit(1)
        # Duplicates that arrived while this task ran: answer them with the
        # SAME completion — never a second execution.
        for dup in parked:
            self._report_done(dup, returns=returns, error=error,
                              retryable=retryable, error_repr=error_repr,
                              error_tb=error_tb, stream_count=stream_count,
                              _replay=True)

    def _reply_direct(self, spec, direct_reply, returns, error, retryable,
                      error_repr, error_tb, stream_count):
        """Complete a peer-submitted task: the result travels BACK over the
        peer connection (the submitter seals it locally and owns the object
        registration), while a batched ``direct_done`` report keeps the
        head's task history, timeline, and actor accounting complete —
        telemetry without per-call dispatch."""
        loop, fut = direct_reply
        body = {
            "returns": returns,
            "stream_count": stream_count,
            "session": self.client.session,
            "node_id": self.node_id,
        }
        if error is not None:
            body["error"] = error
            body["retryable"] = retryable
            body["error_repr"] = error_repr
            body["error_tb"] = error_tb
        with self._streams_lock:
            st = self.direct_streams.get(spec["task_id"])
            if st is not None:
                st["done"] = stream_count
                if error is not None:
                    st["error"] = error

        with self._direct_replies_lock:
            self._direct_replies.append((fut, body))
            wake = not self._direct_replies_scheduled
            if wake:
                self._direct_replies_scheduled = True
        if wake:
            try:
                loop.call_soon_threadsafe(self._drain_direct_replies)
            except RuntimeError:
                pass  # peer loop shutting down with the process
        done = {
            "task_id": spec["task_id"],
            "name": spec.get("name", ""),
            "failed": error is not None,
            "start": spec.get("_exec_start", 0.0),
            "end": time.time(),
        }
        if spec.get("actor_id"):
            done["actor_id"] = spec["actor_id"]
        if error is not None:
            done["error_repr"] = error_repr
            done["error_tb"] = error_tb
        try:
            # Batched background report — the run loop's idle flush and the
            # client's safety-net flusher bound its latency; nothing blocks
            # on it (the caller already has the result).
            self.client.call_batched("direct_done", done)
        except Exception:
            pass

    def _drain_direct_replies(self):
        """Peer loop thread: resolve every buffered completion (their
        ``h_peer_submit`` coroutines then send responses, which the
        Connection's write coalescer folds into one socket write).  Loops
        until observed empty with the flag still claimed so a completion
        racing the drain never pays a second wakeup."""
        while True:
            with self._direct_replies_lock:
                batch, self._direct_replies = self._direct_replies, []
                if not batch:
                    self._direct_replies_scheduled = False
                    return
            for fut, body in batch:
                if not fut.done():
                    fut.set_result(body)

    # -- peer dataplane server (direct actor calls + leased submissions) ------

    @staticmethod
    def _peer_validate(method: str, body):
        """In-handler schema validation: peer servers register outside the
        head's ``_validated`` wrapper, mirroring pull_object/read_log — the
        boundary guarantee must hold on every server speaking the method."""
        from . import schema as wire_schema
        from .rpc import RpcError

        try:
            wire_schema.validate(method, body)
        except wire_schema.SchemaError as e:
            raise RpcError(str(e)) from None

    async def h_peer_submit(self, conn, body):
        """Direct task submission from a peer (driver or another worker).
        The spec enters the same task queue head-pushed specs use, so
        arrival order — per-connection FIFO — is execution order for sync
        actors, and the reply resolves when the task completes."""
        self._peer_validate("peer_submit", body)
        if body["worker_id"] != self.worker_id:
            # Stale route: the caller resolved an address this process no
            # longer answers for (recycled port after a restart, confused
            # cache).  Refuse — executing would run on the wrong worker.
            return {"stale": True}
        spec = body["spec"]
        if spec.get("actor_id") and spec["actor_id"] != self.actor_id:
            # Stale incarnation: this process never hosted (or no longer
            # hosts) that actor — the caller must re-resolve via the head.
            return {"stale": True}
        with self._dedup_lock:
            rec = self._done_cache.get(spec["task_id"])
        if rec is not None:
            # Duplicate delivery (reply lost, submitter re-routed or the
            # injector duplicated the request): answer from the completion
            # cache — the task must not run twice.
            reply = {
                "returns": rec["returns"],
                "stream_count": rec["stream_count"],
                "session": self.client.session,
                "node_id": self.node_id,
            }
            if rec["error"] is not None:
                reply["error"] = rec["error"]
                reply["retryable"] = rec["retryable"]
                reply["error_repr"] = rec["error_repr"]
                reply["error_tb"] = rec["error_tb"]
            return reply
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        spec["_direct_reply"] = (loop, fut)
        if spec.get("num_returns") == "streaming":
            with self._streams_lock:
                if len(self.direct_streams) > 256:
                    # Bound retained stream state: shed fully-reported
                    # streams whose consumer never drained to the end.
                    for tid in list(self.direct_streams):
                        if self.direct_streams[tid]["done"] is not None:
                            del self.direct_streams[tid]
                        if len(self.direct_streams) <= 256:
                            break
                self.direct_streams[spec["task_id"]] = {
                    "items": [], "done": None, "error": None,
                }
        self.task_queue.put(spec)
        return await fut

    async def h_peer_next_stream_item(self, conn, body):
        """Direct-result streaming: the submitter pulls a streaming task's
        yielded items straight from the executing worker (head path analog:
        h_next_stream_item)."""
        self._peer_validate("peer_next_stream_item", body)
        if body["worker_id"] != self.worker_id:
            return {"stale": True}
        task_id = body["task_id"]
        index = int(body["index"])
        while True:
            # Brief hold per poll; released before the await (RT002).
            with self._streams_lock:
                st = self.direct_streams.get(task_id)
                if st is None:
                    return {"done": True}
                if index < len(st["items"]):
                    return {"item": st["items"][index]}
                if st["error"] is not None:
                    return {"error": st["error"]}
                if st["done"] is not None:
                    # Fully consumed: drop the retained stream state.
                    self.direct_streams.pop(task_id, None)
                    return {"done": True}
            await asyncio.sleep(0.005)

    async def h_peer_cancel(self, conn, body):
        self._peer_validate("peer_cancel", body)
        self._on_cancel(body)
        return {"cancelled": True}

    # -------------------------------------------------------------- execution

    def _execute(self, spec):
        task_id = spec["task_id"]
        # Duplicate-delivery gate: a completed task_id replays its cached
        # completion; a dup of a STILL-RUNNING task parks and is answered
        # by the original's _report_done.  Either way: no second execution.
        with self._dedup_lock:
            rec = self._done_cache.get(task_id)
            if rec is None:
                if task_id in self._dedup_running:
                    self._dedup_running[task_id].append(spec)
                    return
                self._dedup_running[task_id] = []
        if rec is not None:
            self._report_done(spec, returns=rec["returns"],
                              error=rec["error"],
                              retryable=rec["retryable"],
                              error_repr=rec["error_repr"],
                              error_tb=rec["error_tb"],
                              stream_count=rec["stream_count"],
                              _replay=True)
            return
        if _DEBUG_PUSH:
            print(f"EXEC start {spec.get('name')} {task_id.hex()[:8]}",
                  file=sys.stderr, flush=True)
        spec["_exec_start"] = time.time()
        ctx.current_task_id = TaskID(task_id)
        self.running_threads[task_id] = threading.get_ident()
        saved_env: Dict[str, Optional[str]] = {}
        saved_cwd: Optional[str] = None
        saved_wd_path: Optional[str] = None
        pymod_roots: list = []
        async_dispatched = False
        # Tracing: install the submitter's span context so user spans and
        # nested submissions inside this task become children (reference:
        # tracing_helper.py wraps execution in the propagated span).
        trace_token = None
        trace_start = 0.0
        injected = spec.get("trace_ctx")
        if injected is not None:
            from ray_tpu_torch.util import tracing

            trace_token = tracing.set_context({
                "trace_id": injected["trace_id"],
                "span_id": injected.get("task_span_id")
                or injected["span_id"],
            })
            trace_start = time.time()
        try:
            if task_id in self.cancelled:
                raise exceptions.TaskCancelledError(TaskID(task_id).hex())
            renv = spec.get("runtime_env") or {}
            env_vars = renv.get("env_vars") or {}
            saved_env = {k: os.environ.get(k) for k in env_vars}
            for k, v in env_vars.items():
                os.environ[k] = v
            if spec.get("gpus") is not None:
                # GPU grant from the scheduler: set this process's
                # CUDA_VISIBLE_DEVICES before user code first initialises
                # CUDA, which reads it only then.  Grants land on fresh
                # workers (dedicated actor processes do by construction),
                # and the variable is not restored after the task: an
                # actor whose methods first touch CUDA needs it set, and a
                # pooled worker retires after a granted task.
                from ray_tpu_torch import accelerators

                accelerators.apply_visibility(spec["gpus"])
            if renv.get("working_dir_key"):
                saved_cwd = os.getcwd()
                saved_wd_path = self._setup_working_dir(
                    renv["working_dir_key"]
                )
            if renv.get("py_module_keys"):
                pymod_roots = self._setup_py_modules(renv["py_module_keys"])
            if renv.get("pip_env"):
                site, venv_dir = self._setup_pip_env(renv["pip_env"])
                # The venv site behaves like a py_modules root from here:
                # teardown removes it from sys.path and evicts its modules.
                pymod_roots.append(site)
                vbin = os.path.join(venv_dir, "bin")
                for k, v in (("VIRTUAL_ENV", venv_dir),
                             ("PATH", vbin + os.pathsep
                              + os.environ.get("PATH", ""))):
                    saved_env.setdefault(k, os.environ.get(k))
                    os.environ[k] = v
            if renv.get("conda_env"):
                site, prefix = self._setup_conda_env(renv["conda_env"])
                if site is not None:
                    pymod_roots.append(site)
                cbin = os.path.join(prefix, "bin")
                for k, v in (("CONDA_PREFIX", prefix),
                             ("PATH", cbin + os.pathsep
                              + os.environ.get("PATH", ""))):
                    saved_env.setdefault(k, os.environ.get(k))
                    os.environ[k] = v

            if spec.get("is_actor_creation"):
                cls = self._load(spec["func_key"])
                args, kwargs = self._resolve_args(spec)
                self.actor_instance = cls(*args, **kwargs)
                # Retained for head-restart resync: the re-register report
                # ships this spec so a restarted head can adopt the live
                # actor (wire-clean copy: internal "_" keys stripped).
                self.actor_creation_spec = {
                    k: v for k, v in spec.items() if not k.startswith("_")
                }
                self.actor_id = spec["actor_id"]
                ctx.current_actor_id = ActorID(self.actor_id)
                self.max_concurrency = spec.get("max_concurrency", 1)
                self.out_of_order = bool(spec.get("execute_out_of_order"))
                groups = spec.get("concurrency_groups") or {}
                self.method_groups = spec.get("method_groups") or {}
                self._group_limits = dict(groups)
                # Per-group executors isolate workloads: a saturated group
                # never blocks another group's dispatch (reference:
                # concurrency_group_manager.h — one fiber/thread pool per
                # named group, plus the default group).
                self.group_pools = {
                    name: ThreadPoolExecutor(
                        limit, thread_name_prefix=f"cg-{name}")
                    for name, limit in groups.items()
                }
                if self.max_concurrency > 1 or self.group_pools \
                        or self.out_of_order:
                    # With groups (or unordered execution) the default
                    # lane must also be pool-dispatched — inline execution
                    # would block the dispatch loop and stall every group.
                    # The pool never exceeds max_concurrency: out-of-order
                    # actors get reordered DISPATCH (head-side, see
                    # Head._drain_actor_queue), not extra execution threads,
                    # so unsynchronized actor state cannot race beyond what
                    # the user opted into.
                    self.pool = ThreadPoolExecutor(
                        max(self.max_concurrency, 1),
                        thread_name_prefix="cg-default")
                self._report_done(
                    spec,
                    returns=[self._store_value(
                        ObjectID(spec["return_ids"][0]), None)],
                )
                return

            if spec.get("method_name"):
                fn = getattr(self.actor_instance, spec["method_name"])
            else:
                fn = self._load(spec["func_key"])
            args, kwargs = self._resolve_args(spec)

            if inspect.iscoroutinefunction(
                fn.__func__ if inspect.ismethod(fn) else fn
            ):
                if os.environ.get("RT_DEBUG_PUSH"):
                    print(f"ASYNC-DISPATCH {spec.get('name')} {spec['task_id'].hex()[:8]}",
                          file=sys.stderr, flush=True)
                async_dispatched = True
                self._execute_async(spec, fn, args, kwargs)
                return

            result = fn(*args, **kwargs)

            if spec.get("num_returns") == "streaming":
                direct = "_direct_reply" in spec
                count = 0
                for item in result:
                    oid = ObjectID.for_task_return(TaskID(task_id), count + 1000)
                    info = self._store_value(oid, item)
                    if direct:
                        # Peer-submitted stream: items stay here and the
                        # submitter pulls them via peer_next_stream_item —
                        # no per-item head traffic.
                        with self._streams_lock:
                            st = self.direct_streams.get(task_id)
                            if st is not None:
                                st["items"].append(info)
                    else:
                        self.client.call_bg(
                            "stream_item",
                            {"task_id": task_id, "index": count, **info},
                        )
                    count += 1
                self._report_done(spec, returns=[], stream_count=count)
                return

            self._finish_ok(spec, result)
        except BaseException as e:  # noqa: BLE001 — all errors cross the wire
            if _DEBUG_PUSH:
                print(f"EXEC-ERR {spec.get('name')} {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
            try:
                self._finish_err(spec, e)
            except BaseException:  # noqa: BLE001 — a lost task_done hangs
                # the caller forever; report with a plain-string error even
                # when serializing the real one failed.
                self._report_done(
                    spec, error=serialization.pack(
                        exceptions.TaskError(RuntimeError(repr(e)), "")
                    ),
                    error_repr=repr(e),
                )
        finally:
            # Actor processes keep their runtime_env; pooled task workers
            # restore so env vars / cwd / sys.path don't leak into unrelated
            # tasks.  (The module import cache can still carry working_dir
            # modules across tasks — matching the reference's per-worker
            # caching semantics; distinct envs should use distinct workers.)
            if self.actor_instance is None:
                for k, old in saved_env.items():
                    if old is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = old
                if saved_cwd is not None:
                    try:
                        os.chdir(saved_cwd)
                    except OSError:
                        pass
                    if saved_wd_path in sys.path:
                        sys.path.remove(saved_wd_path)
                for root in pymod_roots:
                    if root in sys.path:
                        sys.path.remove(root)
                if pymod_roots:
                    # Evict modules imported from the py_modules roots: a
                    # pooled worker may later receive a DIFFERENT version of
                    # the same module name (distinct content-addressed root),
                    # and a stale sys.modules hit would silently run old
                    # code — and leak shipped modules to env-less tasks.
                    for name, mod in list(sys.modules.items()):
                        f = getattr(mod, "__file__", None) or ""
                        if any(f.startswith(r + os.sep) or f == r
                               for r in pymod_roots):
                            del sys.modules[name]
            if injected is not None:
                from ray_tpu_torch.util import tracing

                tracing.reset_context(trace_token)
                if not async_dispatched:
                    # Async actor methods emit their span from the coroutine
                    # itself (the dispatch thread returns immediately).
                    span = tracing.task_span(spec, trace_start, time.time())
                    if span is not None:
                        tracing.emit_span(span)
            self.running_threads.pop(task_id, None)
            ctx.current_task_id = None
            if _DEBUG_PUSH:
                print(f"EXEC end {spec.get('name')} {task_id.hex()[:8]}",
                      file=sys.stderr, flush=True)

    def _finish_ok(self, spec, result):
        num_returns = spec.get("num_returns", 1)
        return_ids = spec.get("return_ids", [])
        if num_returns == 1 or len(return_ids) == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != len(return_ids):
                raise ValueError(
                    f"task declared {len(return_ids)} returns but produced "
                    f"{len(values)}"
                )
        returns = [
            self._store_value(ObjectID(raw), v)
            for raw, v in zip(return_ids, values)
        ]
        self._report_done(spec, returns=returns)

    def _finish_err(self, spec, e: BaseException):
        # From the exception object, not format_exc(): some callers reach
        # here OUTSIDE an except block (unknown-concurrency-group paths),
        # where format_exc() yields the garbage "NoneType: None".
        tb = "".join(
            traceback.format_exception(type(e), e, e.__traceback__)
        )
        if isinstance(e, exceptions.RayTpuError):
            wrapped = e
        else:
            wrapped = exceptions.TaskError(e, tb)
        try:
            blob = serialization.pack(wrapped)
        except Exception:
            blob = serialization.pack(
                exceptions.TaskError(RuntimeError(repr(e)), tb)
            )
        retryable = bool(spec.get("retry_exceptions")) and not isinstance(
            e, exceptions.TaskCancelledError
        )
        self._report_done(
            spec, error=blob, retryable=retryable, error_repr=repr(e),
            error_tb=tb,
        )

    def _execute_async(self, spec, fn, args, kwargs):
        """Async actor method: run as a coroutine on the actor's event loop,
        concurrently with other async methods (reference: fiber.h /
        actor_scheduling_queue async mode)."""
        if self.async_loop is None:
            self.async_loop = asyncio.new_event_loop()
            threading.Thread(
                target=self.async_loop.run_forever, daemon=True,
                name="actor-async-loop",
            ).start()

        injected = spec.get("trace_ctx")
        # Concurrency groups apply to async methods too (reference:
        # fiber.h — one fiber pool per group): an asyncio.Semaphore per
        # group caps in-flight coroutines.  Created lazily on the loop
        # thread's behalf; sized from the creation-time declaration.
        group = spec.get("concurrency_group") \
            or self.method_groups.get(spec.get("method_name", ""))
        sem = None
        if group is not None:
            limit = self._group_limits.get(group)
            if limit is None:
                self._finish_err(spec, ValueError(
                    f"unknown concurrency group {group!r}"))
                return
            sems = getattr(self, "_async_group_sems", None)
            if sems is None:
                sems = self._async_group_sems = {}
            sem = sems.get(group)
            if sem is None:
                sem = sems[group] = asyncio.Semaphore(limit)

        async def run():
            # Tracing: the span must cover the coroutine's real lifetime and
            # the context must live on THIS (event-loop) thread so nested
            # spans/submissions inside the method parent correctly — the
            # dispatching thread's context is useless here.
            token = None
            start = 0.0
            if injected is not None:
                from ray_tpu_torch.util import tracing

                token = tracing.set_context({
                    "trace_id": injected["trace_id"],
                    "span_id": injected.get("task_span_id")
                    or injected["span_id"],
                })
                start = time.time()
            try:
                if sem is not None:
                    async with sem:
                        result = await fn(*args, **kwargs)
                else:
                    result = await fn(*args, **kwargs)
                self._finish_ok(spec, result)
            except BaseException as e:  # noqa: BLE001
                self._finish_err(spec, e)
            finally:
                if injected is not None:
                    from ray_tpu_torch.util import tracing

                    tracing.reset_context(token)
                    span = tracing.task_span(spec, start, time.time())
                    if span is not None:
                        tracing.emit_span(span)

        asyncio.run_coroutine_threadsafe(run(), self.async_loop)

    # ------------------------------------------- headless mode / head restart

    def _resync_payload(self) -> dict:
        """Field-state report carried on a reconnect register: the hosted
        actor (with its full creation spec, so a restarted head can rebuild
        a full-fidelity record and adopt the LIVE instance) plus the tasks
        still executing here (for observability)."""
        out: Dict[str, Any] = {
            "running_tasks": list(self.running_threads.keys()),
        }
        if self.actor_id is not None:
            out["actor_id"] = self.actor_id
            spec = self.actor_creation_spec
            if spec is not None:
                out["creation_spec"] = spec
                meta = spec.get("actor_meta") or {}
                if meta.get("name"):
                    out["actor_name"] = meta["name"]
        return out

    def _on_head_lost(self):
        """Lost head connection (runs on the dying rpc loop thread): enter
        headless degraded mode.  One reconnect thread, claim-then-act."""
        if self._shutdown.is_set():
            # Already shutting down: exit now, but through the same drain
            # (trailing log line + final metrics) every other exit takes.
            self._exit_with_drain(0)
        with self._reconnect_guard:
            if self._reconnecting:
                return
            self._reconnecting = True
        threading.Thread(target=self._reconnect_loop, daemon=True,
                         name="head-reconnect").start()

    def _reconnect_loop(self):
        """Redial the head with jittered backoff until re-registered or the
        suicide deadline passes.  While this runs, the execution side keeps
        working: task threads run, peer_submit keeps accepting direct
        calls, and completed head-routed reports buffer in the client for
        replay at re-register."""
        from . import deadline as _dl

        budget = get_config().head_reconnect_deadline_s
        deadline = _dl.Deadline.after(budget)
        policy = _dl.reconnect_policy()
        attempt = 0
        while not self._shutdown.is_set():
            if deadline.expired:
                _dl.count_deadline_exceeded("reconnect")
                print(
                    f"ray_tpu_torch worker {self.worker_id.hex()[:8]}: head did "
                    f"not return within {budget:.0f}s "
                    "(head_reconnect_deadline_s); exiting",
                    file=sys.stderr, flush=True,
                )
                self._exit_with_drain(0)
            try:
                if self.client._try_reconnect():
                    with self._reconnect_guard:
                        self._reconnecting = False
                    return
            except Exception:
                pass
            if self.client.reconnect_refused is not None:
                # The head refused to adopt this identity (stale actor
                # incarnation, dead actor): this process's state is
                # unwanted — exit now, cleanly.
                print(
                    f"ray_tpu_torch worker {self.worker_id.hex()[:8]}: head "
                    f"refused re-register "
                    f"({self.client.reconnect_refused}); exiting",
                    file=sys.stderr, flush=True,
                )
                self._exit_with_drain(0)
            attempt += 1
            _dl.count_retry("reconnect")
            policy.sleep(attempt, deadline)
        # Shutdown won the race: the run loop owns the exit path.

    def _exit_with_drain(self, code: int):
        """Terminal exit through the clean-shutdown drain: ship the log
        tees' trailing partial lines and the final metrics window, then
        _exit.  Never raises; never returns."""
        try:
            for stream in (sys.stdout, sys.stderr):
                if isinstance(stream, _LogTee):
                    stream.flush_residual()
            # Trailing spans (the final task's execution span lands in the
            # ring AFTER its task_done) must not die with the process.
            from ..util import gangrec as _gangrec
            from ..util import steprec as _steprec
            from ..util import tracing as _tracing

            _tracing.flush_spans(self.client)
            # Flight recorders: final step/round batches + forced black-box
            # dumps (the sidecars next to the log file are what post-mortem
            # tools read when the head never saw these records).
            _steprec.flush_steps(self.client)
            _steprec.dump_black_box(force=True)
            _gangrec.flush_rounds(self.client)
            _gangrec.dump_black_box(force=True)
            self.client._flush_submit_batch()
            from ray_tpu_torch.util.metrics import _final_flush

            _final_flush()
        except BaseException:  # noqa: BLE001 — exiting regardless
            pass
        os._exit(code)

    # ---------------------------------------------------------- introspection

    def _on_stack_dump(self, body):
        """Collect every thread's Python stack and reply to the head.  Runs
        on the rpc loop thread: the executing task keeps running untouched
        (sys._current_frames is a snapshot, no signal, no interruption)."""
        try:
            names = {t.ident: t.name for t in threading.enumerate()}
            tasks_by_ident = {
                ident: tid for tid, ident in self.running_threads.items()
            }
            parts = []
            for ident, frame in sorted(sys._current_frames().items()):
                tid = tasks_by_ident.get(ident)
                note = f" [running task {tid.hex()[:16]}]" if tid else ""
                parts.append(
                    f"Thread {names.get(ident, '?')} (ident={ident}){note}:\n"
                    + "".join(traceback.format_stack(frame))
                )
            dump = "\n".join(parts)
            n_threads = len(parts)
        except Exception:
            dump = "stack collection failed:\n" + traceback.format_exc()
            n_threads = 0
        try:
            self.client.rpc.call_async("stack_dump_reply", {
                "token": body.get("token", 0),
                "pid": os.getpid(),
                "threads": n_threads,
                "dump": dump,
            })
        except Exception:
            pass

    def _on_profile(self, body):
        """On-demand profiler capture (head push, stack_dump-shaped token
        round trip): run util.profiling.device_trace around the live
        process for N seconds, then reply with the TensorBoard trace dir.
        A worker granted a card traces the card and its host; one granted
        none (``CUDA_VISIBLE_DEVICES`` empty, as every worker starts) has
        no card to trace and captures its host alone.
        The capture sleeps, so it MUST leave the rpc loop thread — a
        second concurrent request fails typed (ProfilerBusyError) rather
        than wedging the first."""
        def capture():
            token = body.get("token", 0)
            seconds = float(body.get("seconds", 3.0))
            logdir = body.get("logdir") or os.path.join(
                tmp_root("profiles"),
                f"worker-{self.worker_id.hex()[:8]}-{os.getpid()}")
            reply: Dict[str, Any] = {"token": token, "pid": os.getpid()}
            try:
                from ..util import profiling as _profiling

                granted = bool(os.environ.get("CUDA_VISIBLE_DEVICES"))
                with _profiling.device_trace(
                        logdir, device=None if granted else "cpu"):
                    time.sleep(max(0.05, seconds))
                reply["logdir"] = logdir
                try:
                    from ray_tpu_torch.util.metrics import get_counter

                    get_counter(
                        "ray_tpu_profile_captures_total",
                        "completed on-demand device-trace captures",
                    ).inc()
                except Exception:
                    pass
            except Exception as e:
                reply["error"] = f"{type(e).__name__}: {e}"
            try:
                self.client.rpc.call_async("profile_reply", reply)
            except Exception:
                pass

        threading.Thread(target=capture, daemon=True,
                         name="profile-capture").start()

    def _devmem_loop(self):
        """Periodic device-memory report (util/devmem snapshot → head),
        joined into node snapshots and served by ``list_state("devmem")``
        / ``ray_tpu_torch top``.  Headless windows just skip reports (the
        snapshot is cheap to retake; stale ones aren't worth replaying)."""
        while not self._shutdown.is_set():
            interval = max(1.0, get_config().metrics_flush_interval_s)
            self._shutdown.wait(interval)
            if self._shutdown.is_set() or self.client.rpc.closed:
                continue
            if "torch" not in sys.modules:
                continue  # devmem imports torch: never force that here
            try:
                from ..util import devmem as _devmem

                snap = _devmem.maybe_snapshot()
                if snap is not None:
                    self.client.call_bg(
                        "devmem_report",
                        {"pid": os.getpid(), "devmem": snap})
            except Exception:
                pass

    # ------------------------------------------------------------ cancellation

    def _on_cancel(self, body):
        task_id = body["task_id"]
        self.cancelled.add(task_id)
        if body.get("force"):
            os._exit(1)
        ident = self.running_threads.get(task_id)
        if ident is not None:
            # Raise TaskCancelledError inside the executing thread (same
            # mechanism as the reference's cancellation handler in
            # _raylet.pyx execute_task_with_cancellation_handler).
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_long(ident),
                ctypes.py_object(exceptions.TaskCancelledError),
            )

    # ------------------------------------------------------------------- loop

    def run(self):
        while not self._shutdown.is_set():
            try:
                spec = self.task_queue.get(timeout=0.1)
            except queue.Empty:
                # Idle: completed-task reports must not sit in the batch
                # (their callers block until the head processes them).
                # Spans flush first so a finished task's execution span
                # rides the same coalesced head RPC as its task_done.
                from ..util import tracing as _tracing

                _tracing.flush_spans(self.client)
                self.client._flush_submit_batch()
                continue
            is_method = bool(spec.get("method_name"))
            fn = getattr(self.actor_instance, spec["method_name"], None) \
                if is_method and self.actor_instance is not None else None
            is_async = fn is not None and inspect.iscoroutinefunction(
                fn.__func__ if inspect.ismethod(fn) else fn
            )
            if is_method and not is_async:
                group = spec.get("concurrency_group") \
                    or self.method_groups.get(spec["method_name"])
                gpool = self.group_pools.get(group) if group else None
                if group and gpool is None:
                    self._finish_err(spec, ValueError(
                        f"unknown concurrency group {group!r}"))
                elif gpool is not None:
                    gpool.submit(self._execute, spec)
                elif self.pool is not None:
                    self.pool.submit(self._execute, spec)
                else:
                    self._execute(spec)
            else:
                # Async methods dispatch to the actor loop from here without
                # blocking, preserving queue order for sync methods.
                self._execute(spec)
        # Clean shutdown: os._exit skips atexit, so drain the log tees'
        # trailing partial lines and ship the final metrics window (incl.
        # the logs-dropped counter) explicitly.
        self._exit_with_drain(0)


def main():
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)  # kill -USR1 <pid> dumps all stacks
    worker = Worker()
    worker.run()


if __name__ == "__main__":
    sys.exit(main())
