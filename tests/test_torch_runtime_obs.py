"""Observability across the process boundary: a tiny engine actor on the
CPU (``device="cpu"``) serves two requests under a forced root trace, and
its step records and spans reach the head's ``list_state`` with the JAX
engine actor's fields and span names.  Then the port's ``util`` modules as
the runtime wires them: their ``_cfg()`` reads the runtime's config, the
flushes default to the runtime's client, and ``task_span`` builds the JAX
package's execution span.
"""

import os

import pytest

import _torch_runtime_scenarios as sc
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.core import config as tconfig
from ray_tpu_torch.core.context import ctx
from ray_tpu_torch.util import metrics, steprec, tracing

_results = {}


def _engine():
    if "engine" not in _results:
        _results["engine"] = sc.run_pair("engine_actor")
    return _results["engine"]


@pytest.mark.parametrize("key", ["lens", "step_groups", "step_fields",
                                 "steps_admitted", "trace_keys",
                                 "span_names"])
def test_engine_actor_observability_matches_jax(key):
    ref, got = _engine()
    assert got[key] == ref[key]
    if key == "span_names":
        assert {"engine:queue", "engine:prefill",
                "engine:decode"} <= set(got[key])
    if key == "steps_admitted":
        assert got[key] == 2


def test_util_config_is_the_runtimes(monkeypatch):
    cfg = tconfig.Config()
    cfg.metrics_flush_interval_s = 0.7
    cfg.span_ring_size = 123
    cfg.step_ring_size = 77
    monkeypatch.setattr(tconfig, "get_config", lambda: cfg)
    assert metrics._flush_interval() == 0.7
    assert tracing._ring_cap() == 123
    assert steprec._ring_cap() == 77


def test_flushes_default_to_the_runtime_client(monkeypatch):
    calls = []

    class Client:
        trace_sample_rate = 0.0

        class rpc:
            closed = False

        def call_bg(self, method, body):
            calls.append((method, len(body["rows"])))

        def call_batched(self, method, body):
            calls.append((method, len(body.get("spans")
                                      or body.get("steps"))))

    monkeypatch.setattr(ctx, "client", Client())
    metrics.get_counter("rt_runtime_obs_test_total").inc()
    tracing.drain_buffered()
    steprec.drain_buffered()
    tracing.emit_span({"trace_id": "t", "span_id": "s", "name": "x"})
    steprec.record_step({"engine": "e.0", "step": 1})
    assert metrics.flush_metrics() >= 1
    assert tracing.flush_spans() == 1
    assert steprec.flush_steps() == 1
    assert [c[0] for c in calls] == ["metrics_report", "span_batch",
                                     "engine_step_batch"]
    # The head-configured rate (the client's) wins over the local config.
    assert tracing._sample_rate() == 0.0
    assert not tracing.should_sample()


def test_task_span_matches_jax():
    spec = {"name": "f", "trace_ctx": {"trace_id": "ab", "span_id": "cd",
                                       "task_span_id": "ef"}}
    got = tracing.task_span(spec, 1.0, 2.5, attempt=1)
    ref = jtracing.task_span(spec, 1.0, 2.5, attempt=1)
    assert got == ref
    assert got["pid"] == os.getpid() and got["name"] == "task:f"
    assert tracing.task_span({"name": "f"}, 1.0, 2.0) is None
