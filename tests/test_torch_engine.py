"""CPU parity of the PyTorch port's paged programs and inference engine
with the JAX package: ``paged_prefill`` / ``paged_decode_step`` on the same
pools, page tables, lengths and LoRA adapter arrays (tokens exact, pools to
1e-5), the allocator's contract, and the port engine's greedy streams
against JAX ``generate`` with pages, shedding and cancellation checked on
the way."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.models import paged as jpaged
from ray_tpu.models.generate import generate as jax_generate
from ray_tpu_torch.models import paged as tpaged
from ray_tpu_torch.models.llama import LlamaConfig, params_from_jax
from ray_tpu_torch.serve.engine import (EngineConfig, EngineOverloadedError,
                                        InferenceEngine)

GEOMETRY = dict(batch_slots=4, page_size=8, max_prompt_len=16,
                max_new_tokens_cap=32, prefix_cache=False)


@pytest.fixture(scope="module")
def models():
    jc = JaxConfig.tiny(remat=False, dtype=jnp.float32)
    jp = jax_llama_init(jc, jax.random.PRNGKey(0))
    tc = LlamaConfig.tiny(dtype=torch.float32)
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _adapters(cfg, rng, slots=2, rank=4):
    """Random LoRA arrays for ``slots`` adapters plus the zero slot."""
    L, d = cfg.n_layers, cfg.d_model
    kv = cfg.n_kv_heads * cfg.d_model // cfg.n_heads
    arr = {
        "qa": rng.standard_normal((slots + 1, L, d, rank)) * 0.1,
        "qb": rng.standard_normal((slots + 1, L, rank, d)) * 0.1,
        "va": rng.standard_normal((slots + 1, L, d, rank)) * 0.1,
        "vb": rng.standard_normal((slots + 1, L, rank, kv)) * 0.1,
        "scale": np.full((slots + 1,), 2.0),
    }
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    for v in arr.values():
        v[slots] = 0  # the zero slot
    return arr


def _assert_pools_close(t_pools, j_pools, scratch):
    for name in ("k", "v"):
        got = t_pools[name].numpy()
        want = np.asarray(j_pools[name])
        # Duplicate writes into the scratch page land in either order.
        np.testing.assert_allclose(np.delete(got, scratch, axis=1),
                                   np.delete(want, scratch, axis=1),
                                   atol=1e-5)


def test_paged_prefill_and_decode_match_jax(models):
    jc, jp, tc, tp = models
    rng = np.random.default_rng(0)
    P, ps, maxp = 12, 8, 4
    scratch = P
    ad = _adapters(tc, rng)
    j_ad = {k: jnp.asarray(v) for k, v in ad.items()}
    t_ad = {k: torch.from_numpy(v) for k, v in ad.items()}
    j_pools = jpaged.init_paged_pools(jc, P, ps)
    t_pools = tpaged.init_paged_pools(tc, P, ps)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    # Two sequences: 13 tokens on adapter 1 (bucket 16), 5 tokens on the
    # zero slot (bucket 8); page tables scratch-filled past their pages.
    seqs = [(13, [3, 7, 1], 1), (5, [9, 2], 2)]
    tables, firsts = [], []
    for n, pages, aid in seqs:
        s_pad = 16 if n > 8 else 8
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :n] = rng.integers(0, 512, n)
        pt = np.full((maxp,), scratch, np.int32)
        pt[:len(pages)] = pages
        tables.append(pt)
        j_tok, key, j_pools = jpaged.paged_prefill(
            jc, jp, j_pools, j_ad, jnp.asarray(toks), jnp.asarray(n),
            jnp.asarray(pt), jnp.asarray(aid), jnp.asarray(0.0), key)
        t_tok, gen, t_pools = tpaged.paged_prefill(
            tc, tp, t_pools, t_ad, torch.from_numpy(toks), n,
            torch.from_numpy(pt), aid, torch.tensor(0.0), gen)
        assert int(t_tok) == int(j_tok)
        firsts.append(int(t_tok))
    _assert_pools_close(t_pools, j_pools, scratch)

    # Three slots: both sequences plus an inactive (all-scratch) slot.
    tokens = np.array(firsts + [0], np.int32)
    page_tables = np.stack(tables + [np.full((maxp,), scratch, np.int32)])
    lens = np.array([13, 5, 0], np.int32)
    active = np.array([True, True, False])
    temps = np.zeros(3, np.float32)
    aids = np.array([1, 2, 2], np.int32)
    for _ in range(3):
        j_toks, j_lens, key, j_pools = jpaged.paged_decode_step(
            jc, jp, j_pools, j_ad, jnp.asarray(tokens),
            jnp.asarray(page_tables), jnp.asarray(lens), jnp.asarray(active),
            jnp.asarray(temps), jnp.asarray(aids), key)
        t_toks, t_lens, gen, t_pools = tpaged.paged_decode_step(
            tc, tp, t_pools, t_ad, torch.from_numpy(tokens),
            torch.from_numpy(page_tables), torch.from_numpy(lens),
            torch.from_numpy(active), torch.from_numpy(temps),
            torch.from_numpy(aids), gen)
        np.testing.assert_array_equal(t_toks.numpy()[:2],
                                      np.asarray(j_toks)[:2])
        np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
        _assert_pools_close(t_pools, j_pools, scratch)
        tokens, lens = t_toks.numpy(), t_lens.numpy()
    assert tpaged.call_count("decode") >= 3
    assert tpaged.call_count("prefill") >= 2


def test_sample_tokens_temperature_is_seeded():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0])
    a = tpaged._sample_tokens(logits, temps,
                              torch.Generator().manual_seed(5))
    b = tpaged._sample_tokens(logits, temps,
                              torch.Generator().manual_seed(5))
    assert a.equal(b) and a.dtype == torch.int32
    assert a[0] == logits[0].argmax() and a[2] == logits[2].argmax()


def _alloc_all_or_nothing():
    a = tpaged.PageAllocator(4)
    assert a.alloc(5) is None and a.free_count == 4
    pages = a.alloc(3)
    assert len(set(pages)) == 3 and a.used_count == 3
    assert a.alloc(2) is None
    a.free(pages)
    assert a.free_count == 4


def _alloc_share_refcounts():
    a = tpaged.PageAllocator(3)
    pages = a.alloc(2)
    a.share(pages[:1])
    assert a.shared_count == 1 and a.refs(pages[0]) == 2
    a.free(pages)
    assert a.free_count == 2 and a.refs(pages[0]) == 1
    a.free(pages[:1])
    assert a.free_count == 3 and a.shared_count == 0


def _alloc_double_free_raises():
    a = tpaged.PageAllocator(2)
    pages = a.alloc(1)
    a.free(pages)
    with pytest.raises(AssertionError, match="double free"):
        a.free(pages)


def _alloc_share_unallocated_raises():
    a = tpaged.PageAllocator(2)
    with pytest.raises(AssertionError, match="unallocated"):
        a.share([0])


@pytest.mark.parametrize("case", [_alloc_all_or_nothing,
                                  _alloc_share_refcounts,
                                  _alloc_double_free_raises,
                                  _alloc_share_unallocated_raises],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_page_allocator(case):
    case()


def _engine(models, **overrides):
    _, _, tc, tp = models
    kw = dict(GEOMETRY, max_queue=16)
    kw.update(overrides)
    return InferenceEngine(tc, tp, EngineConfig(**kw), seed=0, device="cpu")


def _wait_pages_free(engine, timeout=10.0):
    alloc = engine.allocator
    deadline = time.time() + timeout
    while time.time() < deadline and alloc.free_count != alloc.total:
        time.sleep(0.02)
    assert alloc.free_count == alloc.total


def test_engine_greedy_streams_match_jax_generate(models):
    jc, jp, _, _ = models
    engine = _engine(models)
    try:
        prompts = [[5, 7, 11], [1] * 9, [100, 200, 300, 400, 5, 6],
                   list(range(30, 46))]
        streams = [engine.submit(p, max_new_tokens=6) for p in prompts]
        # One more admitted while those decode (a slot frees first).
        late = engine.submit([42, 43], max_new_tokens=4)
        got = [list(s) for s in streams] + [list(late)]
        for p, toks in zip(prompts + [[42, 43]], got):
            want = np.asarray(jax_generate(
                jc, jp, np.asarray([p], np.int32),
                max_new_tokens=len(toks)))[0, len(p):]
            assert toks == want.tolist()
        _wait_pages_free(engine)
        st = engine.stats()
        assert st["completed"] == 5 and st["tokens"] == 28
        assert st["prefill_calls"] >= 5 and st["decode_calls"] >= 5
        assert all(s.ttft_s is not None and s.ttft_s > 0 for s in streams)
    finally:
        engine.shutdown()


def test_one_decode_signature_for_any_mix(models):
    """The reference's compile-count contract on a port engine: after
    warmup, no admission mix (occupancy, lengths, churn, cancellation)
    adds a signature to the decode or prefill program; calls still
    count."""
    engine = _engine(models)
    try:
        engine.warmup()  # the decode step and every prefill bucket
        decode_before = tpaged.trace_count("decode")
        prefill_before = tpaged.trace_count("prefill")
        calls_before = tpaged.call_count("decode")
        assert decode_before >= 1 and prefill_before >= 2
        streams = [engine.submit([1], max_new_tokens=3),
                   engine.submit([2, 3, 4, 5, 6, 7, 8, 9], max_new_tokens=9),
                   engine.submit([4, 5], max_new_tokens=1)]
        mid = engine.submit([8] * 12, max_new_tokens=5)
        for s in streams:
            list(s)
        list(mid)
        c = engine.submit([6], max_new_tokens=17)
        next(c)
        c.cancel()
        _wait_pages_free(engine)
        assert tpaged.trace_count("decode") == decode_before
        assert tpaged.trace_count("prefill") == prefill_before
        assert tpaged.call_count("decode") > calls_before
        st = engine.stats()
        assert st["decode_traces"] == decode_before
        assert st["prefill_traces"] == prefill_before
    finally:
        engine.shutdown()


#: The keys of the JAX engine's ``stats()`` (ray_tpu/serve/engine.py), less
#: ``adapters``, which comes with the adapter pool.
_REFERENCE_STATS_KEYS = (
    "steps", "active_seqs", "queued", "free_pages", "total_pages",
    "shared_pages", "completed", "shed", "cancelled", "decode_traces",
    "prefill_traces", "prefill_prefix_traces", "mode", "tenants",
    "prefix_cache")


def test_engine_stats_carry_reference_keys(models):
    engine = _engine(models)
    try:
        assert len(list(engine.submit([1, 2, 3], max_new_tokens=3))) == 3
        st = engine.stats()
        missing = [k for k in _REFERENCE_STATS_KEYS if k not in st]
        assert not missing, missing
        assert st["shared_pages"] == engine.allocator.shared_count
        assert st["decode_traces"] == tpaged.trace_count("decode") >= 1
        assert st["prefill_traces"] == tpaged.trace_count("prefill") >= 1
        assert st["prefill_prefix_traces"] == 0  # not ported yet
        assert st["prefix_cache"] is None
        assert st["mode"] == "continuous" and "default" in st["tenants"]
    finally:
        engine.shutdown()


def test_engine_sheds_at_max_queue(models):
    engine = _engine(models, max_queue=2)
    try:
        busy = []
        for _ in range(engine.config.batch_slots):
            s = engine.submit([1] * 8, max_new_tokens=32)
            next(s)  # in a slot and decoding before the next submit
            busy.append(s)
        queued = [engine.submit([2], max_new_tokens=1) for _ in range(2)]
        with pytest.raises(EngineOverloadedError):
            for _ in range(engine.config.max_queue + 4):
                engine.submit([3], max_new_tokens=1)
        for s in busy + queued:
            assert len(list(s)) > 0  # admitted work still completes
        assert engine.stats()["shed"] >= 1
        _wait_pages_free(engine)
    finally:
        engine.shutdown()


def test_engine_cancel_frees_pages(models):
    engine = _engine(models)
    try:
        engine.warmup()  # one request per prefill bucket, run to the end
        assert engine.stats()["completed"] == len(
            engine.config.prefill_buckets())
        s = engine.submit([7, 7, 7], max_new_tokens=32)
        next(s)
        assert engine.allocator.used_count > 0
        s.cancel()
        assert len(list(s)) < 31  # the stream ends early
        _wait_pages_free(engine)
        assert engine.stats()["cancelled"] == 1
    finally:
        engine.shutdown()


def test_engine_whole_request_mode_gang_admission(models):
    """The baseline mode admits only into an EMPTY batch: a request
    arriving mid-gang waits for the gang to drain."""
    engine = _engine(models, mode="whole_request")
    try:
        a = engine.submit([1, 2], max_new_tokens=12)
        next(a)
        b = engine.submit([3, 4], max_new_tokens=2)
        b_toks = list(b)
        list(a)
        assert len(b_toks) == 2
        assert b.steps[0] >= a.steps[-1]
    finally:
        engine.shutdown()


def test_engine_model_failure_fails_streams_not_the_loop(models,
                                                        monkeypatch):
    """A failing decode call errors the in-flight streams, returns their
    pages, rebuilds the pools and keeps serving; a shutdown mid-generation
    errors the stream instead of truncating it silently."""
    import ray_tpu_torch.serve.engine as engine_mod

    engine = _engine(models)
    try:
        assert len(list(engine.submit([1, 2, 3], max_new_tokens=4))) == 4
        real = engine_mod.paged_decode_step
        calls = {"n": 0}

        def boom(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return real(*a, **kw)

        monkeypatch.setattr(engine_mod, "paged_decode_step", boom)
        with pytest.raises(RuntimeError, match="injected"):
            list(engine.submit([4, 5], max_new_tokens=6))
        assert len(list(engine.submit([1, 2, 3], max_new_tokens=4))) == 4
        _wait_pages_free(engine)
    finally:
        engine.shutdown()

    engine = _engine(models)
    s = engine.submit([1], max_new_tokens=16)
    next(s)
    engine.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        list(s)


def test_engine_refuses_unported_features(models):
    _, _, tc, tp = models
    with pytest.raises(NotImplementedError, match="prefix cache"):
        InferenceEngine(tc, tp, EngineConfig(), device="cpu")
    engine = _engine(models)
    try:
        with pytest.raises(NotImplementedError, match="adapters"):
            engine.submit([1, 2], adapter="a")
    finally:
        engine.shutdown()
