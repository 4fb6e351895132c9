"""The port engine's ``engine:step`` spans on the tiny CPU engine: one span
a step while a traced request is admitted or holds a slot, none for
untraced traffic; phase stamps in order; the KV counters from the slot
lengths and the pool's geometry; the step number of the step record; the
spans kept out of every request's trace; and the hot path's bookkeeping
(traced requests' inter-token sums, one integer of program traces)."""

import threading

import pytest
import torch

from ray_tpu_torch.devtools import jitguard
from ray_tpu_torch.models.llama import LlamaConfig, llama_init
from ray_tpu_torch.serve import engine as tengine
from ray_tpu_torch.util import devmem, steprec, tracing

GEOMETRY = dict(batch_slots=4, page_size=8, max_prompt_len=32,
                max_new_tokens_cap=16, prefix_cache=False)
STAMPS = ("admitted", "prefilled", "launch", "launched", "synced")


@pytest.fixture(scope="module")
def model():
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    return cfg, llama_init(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.fixture
def engine(model):
    cfg, params = model
    eng = tengine.InferenceEngine(cfg, params,
                                  tengine.EngineConfig(**GEOMETRY),
                                  device="cpu")
    tracing.drain_buffered()
    steprec.drain_buffered()
    yield eng
    eng.shutdown()


def _held(eng):
    """Hold the loop in a control op until the returned release() runs, so
    requests submitted meanwhile are admitted together."""
    gate, entered = threading.Event(), threading.Event()

    def hold():
        entered.set()
        gate.wait(30)

    th = threading.Thread(target=eng._run_on_loop, args=(hold,))
    th.start()
    assert entered.wait(30)

    def release():
        gate.set()
        th.join(30)

    return release


def _serve(eng, prompts, max_new, traced):
    """Submit every prompt in one admission pass (under one forced root
    when ``traced``), drain the streams; returns (root, tokens, this
    engine's step spans, its step records, every other span)."""
    release = _held(eng)
    try:
        if traced:
            with tracing.trace("r", force=True) as root:
                streams = [eng.submit(p, max_new_tokens=max_new)
                           for p in prompts]
        else:
            root = None
            streams = [eng.submit(p, max_new_tokens=max_new)
                       for p in prompts]
    finally:
        release()
    tokens = [list(s) for s in streams]
    eng._run_on_loop(lambda: None)  # the last step has recorded
    spans = tracing.drain_buffered()
    steps = [s for s in spans if s["name"] == "engine:step"
             and s["attrs"]["engine"] == eng.engine_id]
    recs = [r for r in steprec.drain_buffered()
            if r["engine"] == eng.engine_id]
    rest = [s for s in spans if s["name"] != "engine:step"]
    return root, tokens, steps, recs, rest


PROMPTS = [[5, 7, 11], list(range(20, 30)), list(range(40, 57))]


def test_one_step_span_per_traced_step_and_none_untraced(engine):
    _, tokens, steps, recs, _ = _serve(engine, PROMPTS, 4, traced=True)
    assert all(len(t) == 4 for t in tokens)
    # Every step served the traced requests (the first prefills them and
    # decodes their second tokens): a span for each record, in order,
    # joined by engine and step.
    assert len(steps) == len(recs) == 3
    assert [s["attrs"]["step"] for s in steps] == [r["step"] for r in recs]
    assert [s["attrs"]["prefills"] for s in steps] == [
        r["admitted"] for r in recs] == [3, 0, 0]
    assert [s["attrs"]["decoded"] for s in steps] == [True] * 3
    _, tokens, steps, recs, rest = _serve(engine, PROMPTS, 4, traced=False)
    assert all(len(t) == 4 for t in tokens) and len(recs) == 3
    assert steps == [] and rest == []
    assert engine._traced_slots == 0


def test_prefill_only_step_has_no_decode_stamps(engine):
    """Requests that end at their first token: the step prefills and
    decodes nothing, so its span has no launch stamps or KV counters."""
    _, _, steps, recs, _ = _serve(engine, PROMPTS[:2], 1, traced=True)
    assert len(steps) == len(recs) == 1
    a = steps[0]["attrs"]
    assert a["decoded"] is False and a["prefills"] == 2
    assert a["step"] == recs[0]["step"]
    assert not {"launch", "launched", "synced", "kv_live", "kv_read",
                "occupancy"} & set(a)
    assert steps[0]["start"] <= a["admitted"] <= a["prefilled"] \
        <= steps[0]["end"]


def test_step_stamps_are_ordered(engine):
    _, _, steps, _, _ = _serve(engine, PROMPTS, 6, traced=True)
    assert len(steps) == 5
    for s in steps:
        t = [s["start"]] + [s["attrs"][k] for k in STAMPS] + [s["end"]]
        assert t == sorted(t), t
    # Consecutive steps do not overlap: a step's end comes before the next
    # one's start, and the loop's host work lies between them.
    for a, b in zip(steps, steps[1:]):
        assert a["end"] <= b["start"]


def test_kv_counters_follow_the_slots(engine):
    """Three prompts admitted together, four tokens each (three steps):
    each decode step attends every busy slot's cache and its new token,
    and the gather reads every slot's whole page table."""
    _, _, steps, _, _ = _serve(engine, PROMPTS, 4, traced=True)
    assert len(steps) == 3
    lens = [len(p) for p in PROMPTS]
    read = (GEOMETRY["batch_slots"] * engine.config.pages_per_seq
            * GEOMETRY["page_size"])
    for i, s in enumerate(steps):
        a = s["attrs"]
        assert a["occupancy"] == 3
        assert a["kv_live"] == sum(n + 1 + i for n in lens)
        assert a["kv_read"] == read == 4 * 6 * 8


def test_step_spans_stay_out_of_request_traces(engine):
    root, _, steps, _, rest = _serve(engine, PROMPTS, 3, traced=True)
    # The request spans: the root and three stages a request, all in the
    # root's trace, none of them a step span.
    assert sorted(s["name"] for s in rest) == sorted(
        ["r"] + ["engine:queue", "engine:prefill", "engine:decode"] * 3)
    assert {s["trace_id"] for s in rest} == {root["trace_id"]}
    # Every step span of the engine in one trace of its own, unparented.
    assert {s["trace_id"] for s in steps} == {engine._step_trace}
    assert engine._step_trace != root["trace_id"]
    assert all(s["parent_id"] is None for s in steps)
    # A traced request's decode span still carries its mean ITL.
    dec = [s for s in rest if s["name"] == "engine:decode"]
    assert all(s["attrs"]["mean_itl_s"] > 0 for s in dec)


def test_traced_request_admitted_beside_untraced_ones(engine):
    """An untraced batch decodes with no spans until a traced request
    joins it; from then on each step has one, until it leaves."""
    release = _held(engine)
    try:
        plain = [engine.submit(p, max_new_tokens=16) for p in PROMPTS[:2]]
    finally:
        release()
    # The loop takes the next hold after the step that admitted the
    # batch: the traced request joins a batch that is still decoding.
    release = _held(engine)
    try:
        with tracing.trace("late", force=True) as root:
            traced = engine.submit([9, 9, 9], max_new_tokens=3)
    finally:
        release()
    assert len(list(traced)) == 3
    assert all(len(list(s)) == 16 for s in plain)
    engine._run_on_loop(lambda: None)
    spans = tracing.drain_buffered()
    steps = [s for s in spans if s["name"] == "engine:step"]
    # The traced request's two steps (prefill and its second token, then
    # its third), no more: its first step starts at its admission.
    assert [s["attrs"]["prefills"] for s in steps] == [1, 0]
    assert all(s["attrs"]["decoded"] for s in steps)
    assert [s["attrs"]["occupancy"] for s in steps] == [3, 3]
    queue = next(s for s in spans if s["name"] == "engine:queue"
                 and s["trace_id"] == root["trace_id"])
    assert steps[0]["start"] == queue["end"]
    assert engine._traced_slots == 0


def test_itl_sums_kept_for_traced_requests_only(engine):
    """The per-token ITL bookkeeping: a running sum and count on traced
    requests, nothing on untraced ones."""
    seen = {}
    real = engine._evict

    def spy(slot, reason):
        req = engine.slots[slot]
        seen[req.req_id] = (req.trace_ctx is not None, req.itl_n,
                            req.itl_sum)
        real(slot, reason)

    engine._evict = spy
    _serve(engine, PROMPTS[:1], 5, traced=True)
    _serve(engine, PROMPTS[:1], 5, traced=False)
    (tr, n, total), (un, n2, total2) = seen.values()
    assert tr and n == 4 and total > 0
    assert not un and n2 == 0 and total2 == 0.0


def test_program_traces_are_one_integer_and_name_the_program(model):
    """A step that meets a new program signature is still attributed to
    the program by name, from one integer compared a step."""
    jitguard.reset_sentinel_state()
    assert jitguard.total() == 0
    jitguard.bump("a")
    jitguard.bump("b")
    jitguard.bump("a")
    assert jitguard.total() == 3
    assert jitguard.traced_since(1) == ["b", "a"]
    assert jitguard.traced_since(3) == []
    jitguard.reset_sentinel_state()
    cfg, params = model
    before = devmem.compile_stats()
    eng = tengine.InferenceEngine(
        cfg, params, tengine.EngineConfig(**dict(GEOMETRY, batch_slots=3)),
        device="cpu")
    try:
        assert len(list(eng.submit([1, 2, 3], max_new_tokens=3))) == 3
        eng._run_on_loop(lambda: None)
    finally:
        eng.shutdown()
    after = devmem.compile_stats()
    grew = {k for k, v in after.items()
            if v["count"] > before.get(k, {"count": 0})["count"]}
    assert grew == {"prefill", "decode"}
    assert jitguard.total() == 2
