"""CPU parity of the port's serving observability with the JAX package:
the metric instruments and their Prometheus text, tracing spans and their
ring, the step flight recorder and its black box, the recompile sentinel
and ``paged.trace_counts`` over it, device-memory pools, the profiler's
capture rules, span analysis, and the two engines serving one script with
the same step records, metric deltas and request spans.

The rings and registries belong to the process, so every check filters by
engine id or trace id and compares deltas, never absolute values; the JAX
and port registries are different modules and are read apart."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.models import paged as jpaged
from ray_tpu.serve import engine as jengine
from ray_tpu.util import devmem as jdevmem
from ray_tpu.util import metrics as jmetrics
from ray_tpu.util import steprec as jsteprec
from ray_tpu.util import trace_analysis as jta
from ray_tpu.util import tracing as jtracing
from ray_tpu_torch.devtools import jitguard
from ray_tpu_torch.models import paged as tpaged
from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax
from ray_tpu_torch.serve import engine as tengine
from ray_tpu_torch.util import (devmem, metrics, profiling, steprec,
                                trace_analysis, tracing)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The 17 fields of a step record (tests/test_flight_recorder.py).
STEP_FIELDS = {
    "t", "engine", "step", "wall_s", "stall_s", "occupancy", "slots",
    "admitted", "evicted", "shed", "queued", "pages_used", "pages_free",
    "pages_shared", "prefix_hits", "adapter_pins", "tenants",
}
# The fields that depend on the clock; the rest must match exactly.
TIME_FIELDS = {"t", "engine", "wall_s", "stall_s"}

# The geometry of test_torch_multitenant (the JAX engine's programs are
# compiled once per process for it); max_queue 3 makes a 4th queued
# request a shed.
GEOMETRY = dict(batch_slots=4, page_size=8, max_prompt_len=16,
                max_new_tokens_cap=32, max_adapters=2, lora_rank=4)


# ------------------------------------------------------------------ metrics

_ROWS = {
    "counter_tags_escaped": [
        {"name": "c_total", "kind": "counter", "description": "A counter",
         "tags": {"b": "2", "a": 'x"y\\z\nw'}, "value": 3.0},
        {"name": "c_total", "kind": "counter", "description": "A counter",
         "tags": {}, "value": 0.5}],
    "gauge_no_description": [
        {"name": "g", "kind": "gauge", "tags": {"pid": "7"}, "value": 12}],
    "histogram": [
        {"name": "h_seconds", "kind": "histogram",
         "description": "line1\nline2 \\ back", "tags": {"t": "a"},
         "boundaries": [0.005, 0.1, 1], "buckets": [1, 0, 2, 3],
         "sum": 4.25, "count": 6, "value": 6}],
    "histogram_missing_buckets": [
        {"name": "h2", "kind": "histogram", "tags": {},
         "boundaries": [1, 2.5], "buckets": [], "sum": 0.1, "count": 3,
         "value": 3}],
}


@pytest.mark.parametrize("case", sorted(_ROWS))
def test_prometheus_text_matches_jax(case):
    """The same rows render to the same exposition text (escaping, number
    format, cumulative buckets, +Inf equal to the count)."""
    rows = _ROWS[case]
    assert metrics.prometheus_text(rows) == jmetrics.prometheus_text(rows)


def _apply_ops(mod, seed):
    """One seeded sequence of inc / set / observe calls on fresh,
    unregistered instruments of ``mod``; returns their snapshot rows."""
    rng = np.random.default_rng(seed)
    c = mod.Counter("t_c", "c", ("k",), register=False)
    g = mod.Gauge("t_g", "g", ("k",), register=False)
    h = mod.Histogram("t_h", "h", (0.01, 0.1, 1.0), ("k",), register=False)
    hd = mod.Histogram("t_hd", "default bounds", register=False)
    for _ in range(300):
        tags = {"k": str(rng.integers(3))} if rng.random() < 0.7 else None
        v = float(rng.exponential(0.3))
        which = rng.integers(4)
        if which == 0:
            c.inc(v, tags=tags)
        elif which == 1:
            g.set(v, tags=tags)
        elif which == 2:
            h.observe(v, tags=tags)
        else:
            hd.observe(v * 10)
    return [r for m in (c, g, h, hd) for r in m._snapshot()]


@pytest.mark.parametrize("seed", [0, 1])
def test_instrument_rows_match_jax(seed):
    port, ref = _apply_ops(metrics, seed), _apply_ops(jmetrics, seed)
    assert port == ref
    assert metrics.prometheus_text(port) == jmetrics.prometheus_text(ref)


def test_getters_are_get_or_create_and_flush_needs_a_client():
    a = metrics.get_counter("rt_obs_test_getter_total", "first", ("x",))
    b = metrics.get_counter("rt_obs_test_getter_total", "second")
    assert a is b and b.description == "first" and b.tag_keys == ("x",)
    h = metrics.get_histogram("rt_obs_test_getter_seconds",
                              boundaries=(1, 2))
    assert metrics.get_histogram("rt_obs_test_getter_seconds") is h
    assert h.boundaries == (1, 2)
    a.inc(2, tags={"x": "1"})
    rows = [r for r in metrics.snapshot_rows()
            if r["name"] == "rt_obs_test_getter_total"
            and r["kind"] == "counter"]
    assert rows == [{"name": "rt_obs_test_getter_total", "kind": "counter",
                     "description": "first", "tags": {"x": "1"},
                     "value": 2.0}]
    # No runtime: nothing to ship to, nothing shipped, no thread started.
    threads = threading.active_count()
    assert metrics.flush_metrics() == 0
    assert threading.active_count() == threads
    sent = []
    client = types.SimpleNamespace(
        call_bg=lambda method, body: sent.append((method, body)))
    n = metrics.flush_metrics(client)
    assert n == len(sent[0][1]["rows"]) >= 1
    assert sent[0][0] == "metrics_report"
    assert sent[0][1]["pid"] == os.getpid()


# ------------------------------------------------------------------ tracing


def _tree(spans):
    """[(name, parent name, attrs)] sorted: ids replaced by names."""
    names = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], names.get(s["parent_id"]),
                   json.dumps(s.get("attrs"), sort_keys=True))
                  for s in spans)


def _nested(tr):
    tr.drain_buffered()
    with tr.trace("root", force=True, a=1) as root:
        assert tr.current_context() is root
        with tr.trace("child") as child:
            assert tr.context_for_submit() is child
            child["attrs"] = {"late": 2}
            with tr.trace("grand", b="x"):
                pass
        with tr.trace_if_active("active_only"):
            pass
        tr.emit_span(tr.make_span(root, "made", 1.0, 2.0, tokens=3))
    assert tr.context_for_submit() is None
    assert tr.current_context() is None
    with tr.trace_if_active("inactive") as d:  # no sampled context: nothing
        assert d == {}
    spans = tr.drain_buffered()
    assert {s["trace_id"] for s in spans} == {root["trace_id"]}
    assert all(s["pid"] == os.getpid() for s in spans)
    by = {s["name"]: s for s in spans}
    assert by["root"]["parent_id"] is None
    assert by["made"]["start"] == 1.0 and by["made"]["end"] == 2.0
    for s in spans:
        assert s["start"] <= s["end"]
        assert len(s["span_id"]) == 16
    return _tree(spans)


def test_nested_trace_parents_match_jax():
    got = _nested(tracing)
    assert got == _nested(jtracing)
    assert got == [
        ("active_only", "root", "null"),
        ("child", "root", '{"late": 2}'),
        ("grand", "child", '{"b": "x"}'),
        ("made", "root", '{"tokens": 3}'),
        ("root", None, '{"a": 1}'),
    ]


def _unsampled(tr):
    tr.drain_buffered()
    with tr.trace("root") as root:
        assert root == {"sampled": False}
        assert tr.context_for_submit() is None
        with tr.trace("child") as child:
            assert child is root
    with tr.trace("forced", force=True):
        assert tr.context_for_submit() is not None
    return [s["name"] for s in tr.drain_buffered()]


def test_context_for_submit_in_unsampled_root_matches_jax(monkeypatch):
    monkeypatch.setattr(tracing, "_cfg", lambda: types.SimpleNamespace(
        span_ring_size=4096, trace_sample_rate=0.0))
    monkeypatch.setattr(jtracing, "_sample_rate", lambda: 0.0)
    assert _unsampled(tracing) == _unsampled(jtracing) == ["forced"]
    assert not tracing.should_sample() and tracing.should_sample(True)


def _ring(tr, mt):
    tr.drain_buffered()
    dropped0 = tr._dropped_total
    m0 = sum(r["value"] for r in mt.get_counter(
        "ray_tpu_spans_dropped_total")._snapshot())
    for i in range(40):
        tr.emit_span({"trace_id": "t", "span_id": str(i), "name": "s",
                      "start": 0.0, "end": 1.0})
    kept = [int(s["span_id"]) for s in tr.drain_buffered()]
    m1 = sum(r["value"] for r in mt.get_counter(
        "ray_tpu_spans_dropped_total")._snapshot())
    return kept, tr._dropped_total - dropped0, m1 - m0


def test_span_ring_bounded_and_drops_counted_as_jax(monkeypatch):
    monkeypatch.setattr(tracing, "_cfg", lambda: types.SimpleNamespace(
        span_ring_size=16, trace_sample_rate=1.0))
    monkeypatch.setattr(jtracing, "_ring_cap", lambda: 16)
    got = _ring(tracing, metrics)
    assert got == _ring(jtracing, jmetrics)
    assert got == (list(range(16)), 24, 24.0)


def test_flush_spans_needs_a_client():
    for tr, mt in ((tracing, metrics), (jtracing, jmetrics)):
        tr.drain_buffered()
        with tr.trace("x", force=True):
            pass
        assert tr.flush_spans() == 0          # no client: spans stay
        sent = []
        client = types.SimpleNamespace(
            rpc=types.SimpleNamespace(closed=False),
            call_batched=lambda method, body: sent.append((method, body)))
        e0 = sum(r["value"] for r in mt.get_counter(
            "ray_tpu_spans_emitted_total")._snapshot())
        assert tr.flush_spans(client) == 1
        assert sent[0][0] == "span_batch"
        assert [s["name"] for s in sent[0][1]["spans"]] == ["x"]
        assert tr.drain_buffered() == []
        assert sum(r["value"] for r in mt.get_counter(
            "ray_tpu_spans_emitted_total")._snapshot()) - e0 == 1


def test_chrome_trace_matches_jax():
    events = [
        {"kind": "span", "trace_id": "t", "span_id": "a", "parent_id": None,
         "name": "submit:f", "start": 1.0, "end": 1.5, "pid": 3,
         "attrs": {"flow_id": "b"}},
        {"kind": "span", "trace_id": "t", "span_id": "b", "parent_id": "a",
         "name": "task:f", "start": 2.0, "end": 3.0, "pid": 4},
        {"kind": "span", "trace_id": "t", "span_id": "c", "name": "bad",
         "start": None, "end": 1.0},
        {"kind": "task", "name": "not a span"},
    ]
    assert tracing.chrome_trace(events) == jtracing.chrome_trace(events)
    assert len(tracing.chrome_trace(events)) == 4  # 2 spans + a flow pair


def test_new_id_unique_hex():
    ids = {tracing.new_id() for _ in range(2000)}
    assert len(ids) == 2000
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids)


# ------------------------------------------------------------------ steprec


@pytest.fixture(params=["jax", "torch"])
def small_ring(request, monkeypatch):
    """Each package's recorder with a shrunken config (through its
    ``_cfg`` hook, as tests/test_flight_recorder.py does)."""
    mod = jsteprec if request.param == "jax" else steprec
    cfg = types.SimpleNamespace(
        step_ring_size=16, step_dump_records=8, step_dump_interval_s=0.0)
    mod.drain_buffered()
    monkeypatch.setattr(mod, "_cfg", lambda: cfg)
    yield mod, cfg
    mod.drain_buffered()


def test_step_ring_bounded_and_drops_counted(small_ring):
    mod, _ = small_ring
    dropped0 = mod.dropped_total()
    for i in range(40):
        mod.record_step({"engine": "ringtest.0", "step": i})
    buffered = mod.drain_buffered()
    assert len(buffered) == 16
    assert [r["step"] for r in buffered] == list(range(16))
    assert mod.dropped_total() - dropped0 == 24


def test_black_box_last_n_atomic_and_throttled(small_ring, tmp_path,
                                               monkeypatch):
    mod, cfg = small_ring
    monkeypatch.setenv("RT_LOG_PATH", str(tmp_path / "worker-abc.log"))
    assert mod.black_box_path() == str(tmp_path / "worker-abc.steps.log")
    for i in range(20):
        mod.record_step({"engine": "boxtest.0", "step": i})
    box = tmp_path / "box.steps.log"
    assert mod.dump_black_box(str(box), force=True)
    lines = [ln for ln in box.read_text().splitlines()
             if not ln.startswith("#")]
    assert [json.loads(ln)["step"] for ln in lines] == list(range(12, 20))
    assert not list(tmp_path.glob("*.tmp.*"))  # renamed into place
    cfg.step_dump_interval_s = 3600.0
    box.write_text("sentinel-unchanged")
    assert not mod.dump_black_box(str(box))
    assert box.read_text() == "sentinel-unchanged"
    assert mod.dump_black_box(str(box), force=True)
    assert "boxtest.0" in box.read_text()
    # flush_steps with no client: the box next to RT_LOG_PATH refreshes,
    # nothing ships, the records stay buffered.
    cfg.step_dump_interval_s = 0.0
    assert mod.flush_steps() == 0
    side = tmp_path / "worker-abc.steps.log"
    assert side.exists() and "boxtest.0" in side.read_text()
    assert len(mod.drain_buffered()) == 16
    # A dump that cannot be written reports False, never raises.
    assert not mod.dump_black_box(str(tmp_path / "no" / "such" / "dir"),
                                  force=True)


def test_flush_steps_ships_one_batch_to_a_client(small_ring):
    mod, _ = small_ring
    for i in range(3):
        mod.record_step({"engine": "flushtest.0", "step": i})
    sent = []
    client = types.SimpleNamespace(
        rpc=types.SimpleNamespace(closed=False),
        call_batched=lambda method, body: sent.append((method, body)))
    assert mod.flush_steps(client) == 3
    assert sent == [("engine_step_batch",
                     {"steps": [{"engine": "flushtest.0", "step": i}
                                for i in range(3)]})]
    assert mod.drain_buffered() == []


# ------------------------------------------------------------------ jitguard


@pytest.fixture
def clean_registry(monkeypatch):
    """Run on an empty registry, then RESTORE the prior state: the paged
    programs' counts stand for signatures this process already met, and
    wiping them would break other files' trace-count assertions."""
    monkeypatch.delenv(jitguard.ENV_FLAG, raising=False)
    with jitguard._lock:
        saved = (dict(jitguard._counts), dict(jitguard._sigs),
                 dict(jitguard._baseline))
    jitguard.reset_sentinel_state()
    yield
    with jitguard._lock:
        for store, snap in zip(
                (jitguard._counts, jitguard._sigs, jitguard._baseline),
                saved):
            store.clear()
            store.update(snap)


def test_jitguard_registry_and_sentinel(clean_registry, monkeypatch):
    jitguard.register_program("p")
    assert jitguard.counts() == {"p": 0}
    sig = jitguard.signature_of({"x": torch.zeros(2, 3), "n": 7})
    assert sig["x"] == ((2, 3), "torch.float32", "cpu")
    assert sig["n"].startswith("int:")
    jitguard.bump("p", sig)
    assert jitguard.arm() is False and not jitguard.armed()  # flag off
    monkeypatch.setenv(jitguard.ENV_FLAG, "1")
    assert jitguard.arm() and jitguard.armed()

    def program():  # stand-in for a program meeting a new signature
        jitguard.bump("p", jitguard.signature_of({"x": torch.zeros(2, 4),
                                                  "n": 7}))

    with pytest.raises(jitguard.RecompileError) as ei:
        program()
    msg = str(ei.value)
    assert "'p'" in msg and "(2, 3)" in msg and "(2, 4)" in msg
    assert "test_torch_observability" in msg  # the call site
    # A late program is unarmed; re-registration stands a baseline down.
    jitguard.bump("late")
    jitguard.register_program("p")
    jitguard.bump("p")
    jitguard.disarm()
    assert not jitguard.armed()
    assert jitguard.counts() == {"p": 3, "late": 1}


def test_paged_trace_counts_alias_the_registry(clean_registry, monkeypatch):
    """A program's first run with a new signature bumps the registry; once
    armed under RT_DEBUG_JIT=1 it raises RecompileError naming the drifted
    argument and the caller, and keeps raising until disarmed."""
    for prog in tpaged.PAGED_PROGRAMS:
        jitguard.register_program(prog)
    assert tpaged.trace_counts() == jitguard.counts() == {
        p: 0 for p in tpaged.PAGED_PROGRAMS}
    pools = {"k": torch.zeros(1, 3, 1, 2, 5), "v": torch.zeros(1, 3, 1, 2, 5)}
    calls0 = tpaged.call_count("page_copy")
    tpaged.copy_page(pools, 0, 1)
    tpaged.copy_page(pools, 1, 2)
    assert tpaged.trace_count("page_copy") == jitguard.count("page_copy") == 1
    assert tpaged.call_count("page_copy") == calls0 + 2
    monkeypatch.setenv(jitguard.ENV_FLAG, "1")
    assert jitguard.arm()
    tpaged.copy_page(pools, 0, 2)  # a known signature: no raise
    wide = {"k": torch.zeros(1, 3, 1, 2, 6), "v": torch.zeros(1, 3, 1, 2, 6)}
    with pytest.raises(jitguard.RecompileError) as ei:
        tpaged.copy_page(wide, 0, 1)
    with pytest.raises(jitguard.RecompileError):  # not kept: raises again
        tpaged.copy_page(wide, 0, 1)
    msg = str(ei.value)
    assert "'page_copy'" in msg
    assert "(1, 3, 1, 2, 5)" in msg and "(1, 3, 1, 2, 6)" in msg
    assert "test_torch_observability.py" in msg  # the caller, past torch
    jitguard.disarm()
    tpaged.copy_page(wide, 0, 1)
    assert tpaged.trace_count("page_copy") == 4  # 1 + two raises + 1


def test_engine_warmup_arms_and_steady_state_never_retraces(tmp_path):
    """In a fresh process with RT_DEBUG_JIT=1: warmup() arms the sentinel
    after running every program, and a mix served afterwards (a batch, a
    late request, a prefix hit, an adapter) meets no new signature."""
    script = tmp_path / "engine_under_sentinel.py"
    script.write_text(textwrap.dedent("""
        import torch

        from ray_tpu_torch.devtools import jitguard
        from ray_tpu_torch.models.llama import LlamaConfig, llama_init
        from ray_tpu_torch.serve import (EngineConfig, InferenceEngine,
                                         random_lora)

        cfg = LlamaConfig.tiny(dtype=torch.float32)
        params = llama_init(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        eng = InferenceEngine(
            cfg, params,
            EngineConfig(batch_slots=4, page_size=8, max_prompt_len=16,
                         max_new_tokens_cap=32, max_queue=16),
            seed=0, device="cpu")
        eng.warmup()
        assert jitguard.armed(), "warmup must arm under RT_DEBUG_JIT=1"
        eng.register_adapter("a", random_lora(cfg, 1, device="cpu"))
        streams = [eng.submit([5, 7, 11], max_new_tokens=6),
                   eng.submit(list(range(1, 13)), max_new_tokens=9),
                   eng.submit([2] * 16, max_new_tokens=3, adapter="a")]
        late = eng.submit([3, 1], max_new_tokens=4)
        toks = [list(s) for s in streams + [late]]
        # A prefix hit, and a copy-on-write fork of the cached page.
        toks.append(list(eng.submit(list(range(1, 11)), max_new_tokens=4)))
        toks.append(list(eng.submit([1, 2, 3, 9], max_new_tokens=2)))
        assert [len(t) for t in toks] == [6, 9, 3, 4, 4, 2], toks
        assert eng.stats()["prefix_hits"] >= 2
        assert jitguard.count("decode") == 1, jitguard.counts()
        eng.shutdown()
        print("SENTINEL_OK", jitguard.counts())
    """))
    out = subprocess.run(
        [sys.executable, str(script)], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "RT_DEBUG_JIT": "1", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SENTINEL_OK" in out.stdout


# ------------------------------------------------------------------ devmem


def test_devmem_cpu_pools_sum_to_live_bytes():
    """On the CPU torch keeps no allocator count: the live bytes are what
    the pools attribute, "other" is 0, and a raising pool reports 0; the
    JAX package's invariant (pools sum to live_bytes) holds on both."""
    anchor = torch.arange(4096.0)
    janchor = jnp.arange(4096.0)
    names = ("t_anchor", "t_raises")
    try:
        for dm, a in ((devmem, anchor), (jdevmem, janchor)):
            dm.register_pool("t_anchor", lambda a=a: a.nbytes)
            dm.register_pool("t_raises", lambda: 1 // 0)
        snap = devmem.snapshot("cpu")
        jsnap = jdevmem.snapshot()
        for s in (snap, jsnap):
            assert sum(s["pools"].values()) == s["live_bytes"]
            assert s["pools"]["t_anchor"] == 4096 * 4
            assert s["pools"]["t_raises"] == 0
            assert s["pools"]["other"] >= 0
        assert snap["pools"]["other"] == 0 and snap["devices"] == []
        assert snap["trace_counts"] == jitguard.counts()
        rows = {r["tags"]["pool"]: r["value"] for r in metrics.get_gauge(
            "ray_tpu_devmem_pool_bytes")._snapshot()}
        assert {k: rows[k] for k in snap["pools"]} == snap["pools"]
    finally:
        for dm in (devmem, jdevmem):
            for name in names:
                dm.unregister_pool(name)
    for dm in (devmem, jdevmem):
        dm.record_compile("t_obs_prog", 0.25)
        dm.record_compile("t_obs_prog", 0.5)
    assert devmem.compile_stats()["t_obs_prog"] == \
        jdevmem.compile_stats()["t_obs_prog"] == {"count": 2, "wall_s": 0.75}


def test_devmem_card_snapshot_reads_the_allocator(monkeypatch):
    """A snapshot of the card reads torch's CUDA allocator (the CPU rule
    does not run there): live bytes from memory_allocated, the allocator
    row from memory_stats and the card's total memory, "other" the rest,
    and over-attribution scaled down to the live bytes."""
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "is_available", lambda: True)
    monkeypatch.setattr(cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda, "memory_allocated", lambda dev=None: 1000)
    monkeypatch.setattr(cuda, "memory_stats", lambda dev=None: {
        "allocated_bytes.all.current": 1000,
        "allocated_bytes.all.peak": 1500})
    monkeypatch.setattr(cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=8e10))
    saved = dict(devmem._pools)
    devmem._pools.clear()
    try:
        devmem.register_pool("a", lambda: 300)
        devmem.register_pool("b", lambda: 200)
        snap = devmem.snapshot()
        assert snap["live_bytes"] == 1000
        assert snap["pools"] == {"a": 300, "b": 200, "other": 500}
        assert snap["devices"] == [{
            "device": 0, "platform": "gpu", "bytes_in_use": 1000,
            "peak_bytes_in_use": 1500, "bytes_limit": 80_000_000_000}]
        devmem.register_pool("liar", lambda: 10_000)
        snap = devmem.snapshot()
        assert sum(snap["pools"].values()) == 1000
        assert snap["pools"]["other"] >= 0
        assert snap["pools"]["liar"] <= 1000
    finally:
        devmem._pools.clear()
        devmem._pools.update(saved)


def test_maybe_snapshot_never_initialises_cuda():
    code = ("import torch; from ray_tpu_torch.util import devmem; "
            "assert not torch.cuda.is_initialized(); "
            "assert devmem.maybe_snapshot() is None; "
            "assert not torch.cuda.is_initialized(); print('clean')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


# ---------------------------------------------------------------- profiling


def test_device_trace_busy_is_typed_and_writes_a_trace(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    with profiling.device_trace(a, device="cpu"):
        assert profiling.active_trace_dir() == a
        with pytest.raises(profiling.ProfilerBusyError):
            with profiling.device_trace(b, device="cpu"):
                pass
        with profiling.annotation("obs-region"):
            torch.ones(64).sum()
        with profiling.step_annotation(3):
            torch.ones(64).sum()
    assert profiling.active_trace_dir() is None
    traces = list(pathlib.Path(a).glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in
             json.loads(traces[0].read_text())["traceEvents"]}
    assert {"obs-region", "train#3"} <= names
    assert not pathlib.Path(b).exists()


def test_device_trace_follows_the_device(tmp_path, monkeypatch):
    """The card is the default: no CUDA raises, and a torch that cannot
    capture CUDA activity raises too, instead of tracing the host alone.
    Neither leaves a capture marked active."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.device_trace(str(tmp_path)):
            pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot capture CUDA"):
        with profiling.device_trace(str(tmp_path)):
            pass
    assert profiling.active_trace_dir() is None


# ----------------------------------------------------------- trace analysis

_PREFIXES = ("ingress:a", "handle:b", "submit:c", "reroute:d", "replica:e",
             "engine:queue", "engine:prefill", "engine:decode", "task:f",
             "misc")


def _random_trace(seed, n=14):
    """A seeded span tree with overlapping children, children that outlive
    their parents, a dangling parent, a flow pair and a second trace."""
    rng = np.random.default_rng(seed)
    spans = []
    for i in range(n):
        parent = spans[int(rng.integers(len(spans)))] if spans else None
        lo = parent["start"] if parent else 0.0
        start = lo + float(rng.uniform(0, 0.5))
        spans.append({
            "kind": "span", "trace_id": "t1" if i < n - 2 else "t2",
            "span_id": f"s{i}", "pid": 1,
            "parent_id": parent["span_id"] if parent else None,
            "name": _PREFIXES[int(rng.integers(len(_PREFIXES)))],
            "start": start, "end": start + float(rng.uniform(0.01, 1.0))})
    spans[3]["parent_id"] = "missing"
    spans[2]["attrs"] = {"flow_id": spans[5]["span_id"]}
    return spans


@pytest.mark.parametrize("seed", range(4))
def test_trace_analysis_matches_jax(seed):
    spans = _random_trace(seed)
    t1 = [s for s in spans if s["trace_id"] == "t1"]
    assert trace_analysis.summarize(spans) == jta.summarize(spans)
    assert trace_analysis.summarize(spans, limit=1) == jta.summarize(
        spans, limit=1)
    roots, kids = trace_analysis.build_tree(t1)
    jroots, jkids = jta.build_tree(t1)
    assert roots == jroots and kids == jkids
    assert trace_analysis.critical_path(t1) == jta.critical_path(t1)
    assert trace_analysis.stage_breakdown(t1) == jta.stage_breakdown(t1)
    assert trace_analysis.render_waterfall(t1) == jta.render_waterfall(t1)
    assert trace_analysis.format_trace(t1) == jta.format_trace(t1)
    for name in _PREFIXES:
        assert trace_analysis.stage_of(name) == jta.stage_of(name)


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def models():
    jc = JaxConfig.tiny(remat=False, dtype=jnp.float32)
    jp = jax_llama_init(jc, jax.random.PRNGKey(0))
    tc = LlamaConfig.tiny(dtype=torch.float32)
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    lora = jax.tree.map(np.asarray, jengine.random_lora(
        jc, 1, rank=GEOMETRY["lora_rank"]))
    return jc, jp, tc, tp, lora


#: The instruments the engine updates by counts that do not depend on the
#: clock, compared as deltas (counters: summed values; histograms: counts).
_COUNTED = ("ray_tpu_gen_tokens_total", "ray_tpu_gen_prefill_tokens_total",
            "ray_tpu_serve_engine_shed_total",
            "ray_tpu_serve_engine_completed_total",
            "ray_tpu_serve_engine_cancelled_total",
            "ray_tpu_serve_prefix_cache_hits_total",
            "ray_tpu_serve_adapter_evictions_total",
            "ray_tpu_serve_tenant_shed_total")
_HISTOGRAMS = ("ray_tpu_serve_engine_ttft_seconds",
               "ray_tpu_serve_engine_itl_seconds")


def _metric_totals(mt):
    out = {n: sum(r["value"] for r in mt.get_counter(n)._snapshot())
           for n in _COUNTED + ("ray_tpu_engine_stall_seconds_total",)}
    out.update({n: sum(r["count"] for r in mt.get_histogram(n)._snapshot())
                for n in _HISTOGRAMS})
    return out


class _Pkg:
    """One package's engine and observability modules."""

    def __init__(self, engine, tracing_mod, steprec_mod, metrics_mod,
                 overloaded):
        self.engine, self.tr, self.rec = engine, tracing_mod, steprec_mod
        self.mt, self.overloaded = metrics_mod, overloaded

    def records(self):
        """This engine's records so far.  The record of a step lands after
        its tokens are consumable: a control op on the loop runs only after
        the step in flight has recorded."""
        self.engine._run_on_loop(lambda: None)
        return [r for r in self.rec.drain_buffered()
                if r["engine"] == self.engine.engine_id]

    def held(self):
        """Hold the loop thread in a control op (after its admission pass)
        until the returned release() is called, so requests submitted
        meanwhile are admitted together by the next pass."""
        gate, entered = threading.Event(), threading.Event()

        def hold():
            entered.set()
            gate.wait(30)

        th = threading.Thread(target=self.engine._run_on_loop, args=(hold,))
        th.start()
        assert entered.wait(30)

        def release():
            gate.set()
            th.join(30)
            assert not th.is_alive()

        return release


_P1 = list(range(60, 72))                          # 12 tokens: one page
_BATCH = [([5, 7, 11], 4), (list(range(20, 36)), 6), ([9] * 10, 2)]
_FORK = _P1[:5] + [3, 4, 5, 6, 7, 8, 9, 10]         # diverges mid-page


def _serve_script(pkg):
    """The script, on one engine: a drained single request, a batch of
    three admitted together with a fourth shed at submit, a prefix hit
    (copy-on-write fork) and an adapter request, all under one forced root
    trace; then a cancel under a root of its own."""
    eng = pkg.engine
    pkg.rec.drain_buffered()
    pkg.tr.drain_buffered()
    m0 = _metric_totals(pkg.mt)
    out = {"records": [], "tokens": []}
    with pkg.tr.trace("script", force=True) as root:
        s1 = eng.submit(_P1, max_new_tokens=3)
        out["tokens"].append(list(s1))
        out["ttft_s"] = s1.ttft_s
        out["records"].append(pkg.records())
        release = pkg.held()
        try:
            streams = [eng.submit(p, max_new_tokens=n) for p, n in _BATCH]
            with pytest.raises(pkg.overloaded):
                eng.submit([1, 2], max_new_tokens=2)
        finally:
            release()
        out["tokens"] += [list(s) for s in streams]
        out["records"].append(pkg.records())
        out["tokens"].append(list(eng.submit(_FORK, max_new_tokens=2)))
        out["records"].append(pkg.records())
        out["tokens"].append(list(eng.submit([4, 8, 15, 16],
                                             max_new_tokens=3,
                                             adapter="a")))
        out["records"].append(pkg.records())
    out["spans"] = [s for s in pkg.tr.drain_buffered()
                    if s["trace_id"] == root["trace_id"]]
    out["root"] = root
    with pkg.tr.trace("cancel", force=True) as croot:
        s = eng.submit([7] * 5, max_new_tokens=30)
        streamed = [next(s)]
        release = pkg.held()  # one more step at most before the reap
        s.cancel()
        release()
        streamed += list(s)
    out["cancel_streamed"] = len(streamed)
    out["cancel_records"] = pkg.records()
    out["cancel_spans"] = [s for s in pkg.tr.drain_buffered()
                           if s["trace_id"] == croot["trace_id"]]
    out["cancel_root"] = croot
    m1 = _metric_totals(pkg.mt)
    out["metrics"] = {k: m1[k] - m0[k] for k in m0}
    return out


def _untimed(recs):
    return [{k: v for k, v in r.items() if k not in TIME_FIELDS}
            for r in recs]


def _span_view(spans, root):
    """(name, parented to the root, the attrs that do not depend on the
    clock) sorted, and the attrs' key sets."""
    view = []
    for s in spans:
        attrs = dict(s.get("attrs") or {})
        view.append((s["name"], s["parent_id"] == root["span_id"],
                     json.dumps({k: v for k, v in attrs.items()
                                 if k not in ("ttft_s", "mean_itl_s")},
                                sort_keys=True),
                     tuple(sorted(attrs))))
    return sorted(view)


def test_engine_records_metrics_and_spans_match_jax(models):
    """The JAX engine and the port's serve one script: equal tokens; step
    records equal field for field apart from the clock's (t, wall_s,
    stall_s, the engine id) where the script fixes the order, and equal
    totals and end state around the cancel; equal deltas of every counter
    and histogram count; the same request spans (names, parents, token
    counts, reasons, prompt and bucket attrs)."""
    jc, jp, tc, tp, lora = models
    cfg = dict(GEOMETRY, max_queue=3)
    j_eng = jengine.InferenceEngine(jc, jp, jengine.EngineConfig(**cfg))
    t_eng = tengine.InferenceEngine(tc, tp, tengine.EngineConfig(**cfg),
                                    device="cpu")
    try:
        for eng in (j_eng, t_eng):
            eng.register_adapter("a", lora)
        ref = _serve_script(_Pkg(j_eng, jtracing, jsteprec, jmetrics,
                                 jengine.EngineOverloadedError))
        got = _serve_script(_Pkg(t_eng, tracing, steprec, metrics,
                                 tengine.EngineOverloadedError))
        pid, seq = t_eng.engine_id.split(".")
        assert int(pid) == os.getpid() and seq.isdigit()
    finally:
        j_eng.shutdown()
        t_eng.shutdown()

    assert got["tokens"] == ref["tokens"]
    for phase, (g, r) in enumerate(zip(got["records"], ref["records"])):
        assert g and all(STEP_FIELDS == set(x) for x in g), phase
        assert _untimed(g) == _untimed(r), phase
        assert all(x["engine"] == t_eng.engine_id for x in g)
        assert all(x["wall_s"] >= 0 and x["stall_s"] >= 0 for x in g)
    flat = [x for recs in got["records"] for x in recs]
    assert sum(x["admitted"] for x in flat) == 6
    assert sum(x["prefix_hits"] for x in flat) == 1
    assert any(x["adapter_pins"] == 1 for x in got["records"][3])
    # Around the cancel the step count depends on the loop's timing:
    # compare totals and the end state.
    # (A cancel is reaped between steps: no step record counts it.)
    for recs in (got["cancel_records"], ref["cancel_records"]):
        assert sum(x["admitted"] for x in recs) == 1
        assert sum(x["evicted"] for x in recs) == 0
    end = ("pages_used", "pages_free", "pages_shared", "occupancy")
    assert ({k: got["cancel_records"][-1][k] for k in end}
            == {k: ref["cancel_records"][-1][k] for k in end})

    # Metric deltas: equal counts; the stall counter is a clock (> 0).
    stall = "ray_tpu_engine_stall_seconds_total"
    assert got["metrics"][stall] > 0 and ref["metrics"][stall] > 0
    cancel_tokens = {"jax": ref["cancel_streamed"],
                     "torch": got["cancel_streamed"]}
    for d, side in ((got["metrics"], "torch"), (ref["metrics"], "jax")):
        # The cancel's tokens depend on the loop's timing: take them out.
        d["ray_tpu_gen_tokens_total"] -= cancel_tokens[side]
        d["ray_tpu_serve_engine_itl_seconds"] -= cancel_tokens[side] - 1
        d.pop(stall)
    assert got["metrics"] == ref["metrics"]
    assert got["metrics"]["ray_tpu_serve_engine_completed_total"] == 6
    assert got["metrics"]["ray_tpu_serve_engine_shed_total"] == 1
    assert got["metrics"]["ray_tpu_serve_engine_cancelled_total"] == 1
    assert got["metrics"]["ray_tpu_serve_engine_ttft_seconds"] == 7

    # Spans: three stages per admitted request, parented to the root.
    assert _span_view(got["spans"], got["root"]) == _span_view(
        ref["spans"], ref["root"])
    names = [s["name"] for s in got["spans"]]
    assert all(names.count(n) == 6 for n in
               ("engine:queue", "engine:prefill", "engine:decode"))
    assert all(s["parent_id"] == got["root"]["span_id"]
               for s in got["spans"] if s["name"] != "script")
    decode = sorted((s["attrs"]["tokens"], s["attrs"]["reason"])
                    for s in got["spans"] if s["name"] == "engine:decode")
    assert decode == sorted((len(t), "complete") for t in got["tokens"])
    # TTFT read from the spans (prefill end - queue start) against the
    # engine's own (perf_counter) TTFT, for the first request: the two
    # clocks are read microseconds apart on each side; 20 ms of slack
    # covers a thread switch on a loaded CPU.
    first = {s["name"]: s for s in got["spans"]
             if (s.get("attrs") or {}).get("prompt_len") == len(_P1)
             and s["name"] != "engine:decode"}
    span_ttft = first["engine:prefill"]["end"] - first["engine:queue"][
        "start"]
    assert abs(span_ttft - got["ttft_s"]) < 0.02
    # The cancel: its decode span says so, with every token streamed.
    for out in (got, ref):
        cdec = [s for s in out["cancel_spans"]
                if s["name"] == "engine:decode"]
        assert len(cdec) == 1
        assert cdec[0]["attrs"]["reason"] == "cancelled"
        assert cdec[0]["attrs"]["tokens"] == out["cancel_streamed"]


def test_engine_registers_device_memory_pools_as_jax(models):
    """The engine names its allocations: weights, KV pool and adapter pool
    carry the JAX engine's byte counts, and shutdown unregisters them."""
    jc, jp, tc, tp, _ = models
    j_eng = jengine.InferenceEngine(jc, jp, jengine.EngineConfig(**GEOMETRY))
    t_eng = tengine.InferenceEngine(tc, tp, tengine.EngineConfig(**GEOMETRY),
                                    device="cpu")
    try:
        snap = devmem.snapshot("cpu")
        jpools = jdevmem.snapshot()["pools"]
        for name in ("model_weights", "kv_pool", "adapter_pool"):
            assert snap["pools"][name] == jpools[name] > 0, name
        c = tc
        kv = (2 * c.n_layers * (t_eng.config.pool_pages + 1) * c.n_kv_heads
              * t_eng.config.page_size * c.head_dim * 4)
        assert snap["pools"]["kv_pool"] == kv
        assert snap["pools"]["model_weights"] == sum(
            p.numel() * 4 for p in tp.parameters())
        assert sum(snap["pools"].values()) == snap["live_bytes"]
    finally:
        j_eng.shutdown()
        t_eng.shutdown()
    assert not {"model_weights", "kv_pool", "adapter_pool"} & set(
        devmem.snapshot("cpu")["pools"])


def test_failed_step_emits_error_decode_span_as_jax(models, monkeypatch):
    """A failing decode errors the in-flight stream; its decode span says
    reason "error" with the tokens it had, on both engines."""
    jc, jp, tc, tp, _ = models
    boom = RuntimeError("injected device failure")

    def failing(*a, **kw):
        raise boom

    monkeypatch.setattr(jpaged, "paged_decode_step", failing)
    monkeypatch.setattr(tengine, "paged_decode_step", failing)
    views = []
    for eng, tr in ((jengine.InferenceEngine(
            jc, jp, jengine.EngineConfig(**GEOMETRY)), jtracing),
            (tengine.InferenceEngine(tc, tp, tengine.EngineConfig(**GEOMETRY),
                                     device="cpu"), tracing)):
        try:
            tr.drain_buffered()
            with tr.trace("fail", force=True) as root:
                with pytest.raises(RuntimeError, match="injected"):
                    list(eng.submit([1, 2, 3], max_new_tokens=4))
            spans = [s for s in tr.drain_buffered()
                     if s["trace_id"] == root["trace_id"]]
            views.append(sorted(
                (s["name"], *((s.get("attrs") or {}).get(k)
                              for k in ("reason", "tokens", "error")))
                for s in spans))
            assert eng.allocator.free_count == eng.allocator.total
        finally:
            eng.shutdown()
    assert views[0] == views[1]
    assert ("engine:decode", "error", 1, repr(boom)) in views[1]


def test_step_record_off_switch(models):
    """step_record=False keeps the decode loop silent."""
    _, _, tc, tp, _ = models
    eng = tengine.InferenceEngine(
        tc, tp, tengine.EngineConfig(**GEOMETRY, step_record=False),
        device="cpu")
    try:
        steprec.drain_buffered()
        assert list(eng.submit([3, 5], max_new_tokens=3))
        eng._run_on_loop(lambda: None)
        time.sleep(0.1)
        assert not [r for r in steprec.drain_buffered()
                    if r.get("engine") == eng.engine_id]
        assert eng.slo_signals()["step_p50_s"] == 0.0
    finally:
        eng.shutdown()
