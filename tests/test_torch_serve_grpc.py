"""The port's gRPC ingress against the JAX package's
(``_torch_serve_scenarios.grpc``, both clusters at once): unary calls,
a named method, server-streaming frames, and the status codes of an
unknown deployment, a malformed body and an application error.  The
port's service is named after its package
(``/ray_tpu_torch.serve.ServeAPI/Call``); the bodies are the same."""

import pytest

import _torch_serve_scenarios as sc
from ray_tpu.serve import grpc_ingress as jgrpc
from ray_tpu_torch.serve import grpc_ingress as tgrpc

_results = {}


def _grpc():
    if "grpc" not in _results:
        _results["grpc"] = sc.run_pair("grpc")
    return _results["grpc"]


@pytest.mark.parametrize("key", ["unary", "method", "not_found",
                                 "bad_body", "app_error", "stream",
                                 "stream_not_found"])
def test_grpc_matches_jax(key):
    ref, got = _grpc()
    assert got[key] == ref[key]


def test_grpc_values():
    _, got = _grpc()
    assert got["unary"] == {"result": {"sum": 42}}
    assert got["method"] == {"result": -7}
    assert got["not_found"] == {"code": "NOT_FOUND"}
    assert got["bad_body"] == {"code": "INVALID_ARGUMENT"}
    assert got["app_error"] == "INTERNAL"
    assert got["stream"] == [{"item": {"t": i}} for i in range(5)] + [
        {"done": True}]


def test_method_names():
    """The service is the package's; its service and method names are
    the JAX ingress's."""
    assert tgrpc.CALL_METHOD == "/ray_tpu_torch.serve.ServeAPI/Call"
    for j, t in ((jgrpc.CALL_METHOD, tgrpc.CALL_METHOD),
                 (jgrpc.CALL_STREAM_METHOD, tgrpc.CALL_STREAM_METHOD)):
        assert j.split(".", 1)[1] == t.split(".", 1)[1]


def test_grpc_is_imported_lazily():
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    code = ("import sys, ray_tpu_torch.serve.grpc_ingress; "
            "print('grpc' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(root),
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
