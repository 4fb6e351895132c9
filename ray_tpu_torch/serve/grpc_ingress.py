"""gRPC ingress for Serve (port of ``ray_tpu/serve/grpc_ingress.py``; the
service is named after this package, so its methods are
``/ray_tpu_torch.serve.ServeAPI/Call`` and ``.../CallStream``).  ``grpc``
is imported only when the ingress starts.

Role-equivalent to the reference's gRPCProxy (reference:
serve/_private/proxy.py:545 gRPCProxy routed beside the HTTP proxy) —
re-designed without protobuf codegen: one generic unary method,

    /ray_tpu_torch.serve.ServeAPI/Call

whose request/response bodies are JSON bytes::

    request:  {"deployment": "Name", "method": "__call__",
               "args": [...], "kwargs": {...},
               "multiplexed_model_id": ""}
    response: {"result": <json>}

Application errors surface as gRPC INTERNAL status with the exception
text; unknown deployments as NOT_FOUND.  Any gRPC client in any language
can call it with a bytes-in/bytes-out stub — no generated code needed on
either side.
"""

from __future__ import annotations

import json
from concurrent import futures
from typing import Dict, Optional

CALL_METHOD = "/ray_tpu_torch.serve.ServeAPI/Call"
# Server-streaming variant: same request body, one JSON frame per item the
# generator deployment yields: {"item": <json>} ... {"done": true}
# (reference: proxy.py:537-598 — the gRPC proxy's streaming responses are
# the main reason a model server wants gRPC: token streaming).
CALL_STREAM_METHOD = "/ray_tpu_torch.serve.ServeAPI/CallStream"


class _GrpcIngress:
    def __init__(self, host: str, port: int):
        import grpc

        from .handle import DeploymentHandle

        # LRU-bounded: one entry per (deployment, method, model_id) route;
        # unbounded model-id fan-out must not grow the dict forever.  The
        # lock guards the OrderedDict against the gRPC thread pool
        # (get/move_to_end/popitem are not a single atomic step).
        import threading
        from collections import OrderedDict

        handles: "OrderedDict[tuple, DeploymentHandle]" = OrderedDict()
        handles_lock = threading.Lock()
        max_handles = 256

        def _abort_for(e: BaseException, context):
            """Shared exception -> gRPC status mapping for both methods."""
            if isinstance(e, RuntimeError) and "no running replicas" in str(e):
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")

        def call(request: bytes, context):
            from ray_tpu_torch.util import tracing

            req, h = _route(request, context)
            try:
                # Per-request root span (head-configured sampling;
                # "force_trace": true in the body is the per-call
                # override); the trace id travels back in the trailing
                # metadata, to look up at the head.
                with tracing.trace(
                    f"ingress:{req['deployment']}",
                    force=bool(req.get("force_trace")), proto="grpc",
                ) as tctx:
                    # Metadata set BEFORE the call: a failing request —
                    # the one worth tracing — must still
                    # return its trace id with the error status.
                    if tctx.get("trace_id"):
                        context.set_trailing_metadata(
                            (("x-rt-trace-id", tctx["trace_id"]),))
                    result = h.remote(
                        *(req.get("args") or []),
                        **(req.get("kwargs") or {})
                    ).result()
                # Serialize inside the mapping too: a non-JSON result
                # (arrays, bytes) must answer INTERNAL with the reason,
                # not a blank UNKNOWN.
                return json.dumps({"result": result}).encode()
            except Exception as e:  # noqa: BLE001 — mapped to a status
                _abort_for(e, context)

        def _route(request: bytes, context, stream: bool = False):
            """Shared request parse + handle lookup for both methods.
            Stream-mode handles cache separately so their p2c load counts
            persist across requests."""
            try:
                req = json.loads(request)
                if not isinstance(req, dict):
                    raise TypeError(
                        f"body must be a JSON object, got "
                        f"{type(req).__name__}")
                name = req["deployment"]
            except (ValueError, KeyError, TypeError) as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                              f"bad request body: {e}")
            key = (name, req.get("method", "__call__"),
                   req.get("multiplexed_model_id", ""), stream)
            with handles_lock:
                h = handles.get(key)
                if h is not None:
                    handles.move_to_end(key)
            if h is None:
                from .api import status as serve_status

                try:
                    known = serve_status()
                except Exception:
                    known = None
                if known is not None and name not in known:
                    context.abort(grpc.StatusCode.NOT_FOUND,
                                  f"no deployment named {name!r}")
                h = DeploymentHandle(
                    name, key[1], multiplexed_model_id=key[2],
                    stream=stream)
                with handles_lock:
                    h = handles.setdefault(key, h)
                    handles.move_to_end(key)
                    while len(handles) > max_handles:
                        handles.popitem(last=False)
            return req, h

        def call_stream(request: bytes, context):
            """unary_stream: one response frame per generator item.  The
            stream is pulled item-by-item (consumer-side buffering is one
            item; the rest waits in the object store), so a slow client
            applies backpressure to this worker thread only."""
            import os
            import time

            from ray_tpu_torch.util import tracing

            req, h = _route(request, context, stream=True)
            stream = None
            completed = False
            # Root span WITHOUT the trace() context manager: this is a
            # generator the gRPC server may resume on different pool
            # threads, and a contextvar held across yields would leak the
            # request's context into unrelated work on the opening
            # thread.  Install the context only around the same-thread
            # submission (where propagation happens); emit the ingress
            # span manually at finalization.
            span_ctx = None
            start = time.time()
            if tracing.should_sample(bool(req.get("force_trace"))):
                span_ctx = {"trace_id": tracing.new_id(),
                            "span_id": tracing.new_id()}
                context.set_trailing_metadata(
                    (("x-rt-trace-id", span_ctx["trace_id"]),))
            try:
                token = tracing.set_context(span_ctx) if span_ctx else None
                try:
                    stream = h.remote(
                        *(req.get("args") or []),
                        **(req.get("kwargs") or {}))
                finally:
                    if token is not None:
                        tracing.reset_context(token)
                for item in stream:
                    if not context.is_active():
                        return  # client cancelled between frames
                    yield json.dumps({"item": item}).encode()
                yield json.dumps({"done": True}).encode()
                completed = True
            except Exception as e:  # noqa: BLE001 — mapped to a status
                _abort_for(e, context)
            finally:
                if span_ctx is not None:
                    tracing.emit_span({
                        "trace_id": span_ctx["trace_id"],
                        "span_id": span_ctx["span_id"],
                        "parent_id": None,
                        "name": f"ingress:{req['deployment']}",
                        "start": start,
                        "end": time.time(),
                        "pid": os.getpid(),
                        "attrs": {"proto": "grpc", "stream": True,
                                  "completed": completed},
                    })
                # Any non-complete exit — the is_active() poll, a client
                # cancellation surfacing AT the yield (grpc closes this
                # generator: GeneratorExit, a BaseException), or an abort
                # — cancels the replica-side generator so an
                # engine-backed deployment frees its KV pages mid-flight.
                if stream is not None and not completed:
                    stream.cancel()

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == CALL_METHOD:
                    return grpc.unary_unary_rpc_method_handler(
                        call,
                        request_deserializer=None,   # raw bytes
                        response_serializer=None,
                    )
                if details.method == CALL_STREAM_METHOD:
                    return grpc.unary_stream_rpc_method_handler(
                        call_stream,
                        request_deserializer=None,
                        response_serializer=None,
                    )
                return None

        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16),
        )
        self.server.add_generic_rpc_handlers((Handler(),))
        self.port = self.server.add_insecure_port(f"{host}:{port}")
        self.server.start()

    def close(self):
        self.server.stop(grace=1).wait()


_grpc: Optional[_GrpcIngress] = None


def start_grpc(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start the gRPC ingress; returns the bound port."""
    global _grpc
    if _grpc is None:
        _grpc = _GrpcIngress(host, port)
    return _grpc.port


def stop_grpc() -> None:
    global _grpc
    if _grpc is not None:
        _grpc.close()
        _grpc = None
