"""ServeReplica: hosts one copy of a deployment's user callable (port of
``ray_tpu/serve/replica.py``: a replica granted a card sees it as its only
CUDA device, one granted none sees no card at all; its health and queue
probes are coroutines, see ``ping``).

Role-equivalent to the reference's ReplicaActor
(reference: serve/_private/replica.py:231 — runs the user class, exposes a
queue-length probe used by the power-of-two router).
"""

from __future__ import annotations

import asyncio
import inspect
import threading
from typing import Any

import cloudpickle

import ray_tpu_torch


@ray_tpu_torch.remote(max_concurrency=16)
class ServeReplica:
    def __init__(self, deployment_name: str, cls_blob: bytes,
                 init_args_blob: bytes):
        import os

        from ..util.metrics import get_gauge, get_histogram

        self.deployment_name = deployment_name
        cls = cloudpickle.loads(cls_blob)
        args, kwargs = cloudpickle.loads(init_args_blob)
        self.user = cls(*args, **kwargs) if inspect.isclass(cls) else None
        self.user_fn = None if self.user is not None else cls
        self._ongoing = 0
        self._count_lock = threading.Lock()
        # Auto-instrumentation, hoisted off the request path (instrument
        # lookup takes the process-global registry lock).  Queue depth
        # carries a pid tag: two replicas of one deployment must stay
        # distinct series (the head's gauge merge is last-writer-wins
        # per (name, tags)); the latency histogram sums safely across
        # replicas so deployment alone suffices.
        self._m_latency = get_histogram(
            "ray_tpu_serve_request_latency_seconds",
            "Serve request handling latency per deployment",
            boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10),
            tag_keys=("deployment",))
        self._m_depth = get_gauge(
            "ray_tpu_serve_replica_queue_depth",
            "In-flight requests on this replica",
            tag_keys=("deployment", "pid"))
        self._m_tags = {"deployment": deployment_name}
        self._m_depth_tags = {"deployment": deployment_name,
                              "pid": str(os.getpid())}

    # The controller's probes are coroutines, so they answer on the
    # replica's event loop: sync requests and streams run on the actor's
    # max_concurrency lanes, and streams holding every lane past the
    # controller's 5 s probe deadline made a busy replica look dead (the
    # JAX replica's sync probes queue behind them and it is killed
    # mid-stream).
    async def ping(self) -> str:
        return "ok"

    async def queue_len(self) -> int:
        """Outstanding requests (reference: the router's queue-length probe,
        pow_2_scheduler.py)."""
        return self._ongoing

    def _resolve_target(self, method: str):
        if self.user_fn is not None:
            return self.user_fn
        if method == "__call__":
            return self.user
        return getattr(self.user, method)

    def _request_scope(self, model_id: str):
        """Ongoing-count + multiplex-model-id bracket shared by the unary
        and streaming paths.  Also the replica's auto-instrumentation
        point: request latency histogram + queue-depth gauge (instruments
        created in __init__; reference: serve's
        ray_serve_deployment_request_* via the replica's metrics pusher)."""
        import contextlib
        import time as _time

        from ..util import tracing
        from .multiplex import _reset_model_id, _set_model_id

        @contextlib.contextmanager
        def scope():
            with self._count_lock:
                self._ongoing += 1
                self._m_depth.set(self._ongoing, tags=self._m_depth_tags)
            token = _set_model_id(model_id)
            start = _time.perf_counter()
            try:
                # Per-request replica span: nests under the propagated
                # execution span when the caller traced (ingress, handle,
                # or an explicit tracing.trace) — the engine's
                # queue/prefill/decode tree hangs off it.  Propagation-
                # only: untraced/unsampled requests stay span-free.
                with tracing.trace_if_active(
                    f"replica:{self.deployment_name}",
                    **({"model_id": model_id} if model_id else {}),
                ):
                    yield
            finally:
                self._m_latency.observe(_time.perf_counter() - start,
                                        tags=self._m_tags)
                _reset_model_id(token)
                with self._count_lock:
                    self._ongoing -= 1
                    self._m_depth.set(self._ongoing, tags=self._m_depth_tags)

        return scope()

    async def handle_request(self, method: str, args: tuple, kwargs: dict,
                             model_id: str = ""):
        with self._request_scope(model_id):
            target = self._resolve_target(method)
            if inspect.iscoroutinefunction(target):
                return await target(*args, **kwargs)
            # Sync callables run off-loop: blocking user code must not stall
            # the replica's event loop (concurrent requests keep flowing and
            # queue pressure stays observable for autoscaling).  The model-id
            # contextvar rides along via copy_context.
            import contextvars as _cv

            ctx = _cv.copy_context()
            out = await asyncio.get_running_loop().run_in_executor(
                None, lambda: ctx.run(target, *args, **kwargs)
            )
            if inspect.iscoroutine(out):
                out = await out
            return out

    def handle_request_streaming(self, method: str, args: tuple,
                                 kwargs: dict, model_id: str = ""):
        """Generator execution path: the user generator's items flow out
        through the core streaming-returns channel one at a time
        (reference: replica.py handle_request_streaming — the proxy and
        handles consume an ObjectRefGenerator).  Runs as a SYNC generator
        on the actor's thread pool, so a slow stream occupies one lane
        while other requests keep flowing.  Called with
        num_returns="streaming" by the handle layer."""
        with self._request_scope(model_id):
            target = self._resolve_target(method)
            if inspect.iscoroutinefunction(target) or \
                    inspect.isasyncgenfunction(target):
                raise TypeError(
                    "streaming deployments must use sync generators "
                    "(async callables would need the replica's event "
                    "loop, which belongs to unary async requests)")
            out = target(*args, **kwargs)
            if inspect.isasyncgen(out) or inspect.iscoroutine(out):
                if inspect.iscoroutine(out):
                    out.close()  # never awaited by design
                raise TypeError(
                    "streaming deployments must use sync generators "
                    "(async generators would need the replica's event "
                    "loop, which belongs to unary async requests)")
            if inspect.isgenerator(out) or (
                    hasattr(out, "__iter__")
                    and not isinstance(out, (str, bytes, dict))):
                for item in out:
                    yield item
            else:
                yield out  # non-generator: a one-item stream
