"""CPU parity of the PyTorch port's multi-tenant serving plane with the JAX
package: the radix prefix cache (matches, allocator refcounts and stats
under the same operation sequences), ``copy_page``, ``pack_lora`` +
``adapter_load``, the cached-prefix prefill ``paged_prefill_prefix`` (the
K/V it writes to 1e-5, the greedy token exact), and the port engine's
prefix-hit, copy-on-write and adapter-mix streams against JAX ``generate``
(on ``lora_merge``d parameters for adapters) and against the JAX engine
serving the same script."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.models import paged as jpaged
from ray_tpu.models.generate import generate as jax_generate
from ray_tpu.models.llama import lora_merge as jax_lora_merge
from ray_tpu.serve import engine as jengine
from ray_tpu.serve.prefix_cache import RadixPrefixCache as JaxRadixCache
from ray_tpu_torch.models import paged as tpaged
from ray_tpu_torch.models.llama import (LlamaConfig, lora_from_jax,
                                        params_from_jax)
from ray_tpu_torch.serve import (AdapterNotFoundError, AdapterPool,
                                 EngineConfig, InferenceEngine,
                                 RadixPrefixCache, random_lora)

GEOMETRY = dict(batch_slots=4, page_size=8, max_prompt_len=16,
                max_new_tokens_cap=32, max_adapters=2, lora_rank=4)
RANK = GEOMETRY["lora_rank"]


@pytest.fixture(scope="module")
def models():
    jc = JaxConfig.tiny(remat=False, dtype=jnp.float32)
    jp = jax_llama_init(jc, jax.random.PRNGKey(0))
    tc = LlamaConfig.tiny(dtype=torch.float32)
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def jax_loras(models):
    """JAX ``random_lora`` adapters by seed, as numpy trees."""
    jc = models[0]
    return {s: jax.tree.map(np.asarray, jengine.random_lora(jc, s, rank=RANK))
            for s in (1, 2, 3)}


@pytest.fixture(scope="module")
def engine(models):
    _, _, tc, tp = models
    eng = InferenceEngine(tc, tp, EngineConfig(**GEOMETRY, max_queue=16),
                          seed=0, device="cpu")
    eng.warmup()
    yield eng
    eng.shutdown()


def _jax_ref(jc, params, prompt, n):
    return np.asarray(jax_generate(
        jc, params, np.asarray([prompt], np.int32),
        max_new_tokens=n))[0, len(prompt):].tolist()


def _drain(engine, timeout=10.0):
    """Clear the prefix cache until every page is back on the free list."""
    alloc = engine.allocator
    deadline = time.time() + timeout
    while time.time() < deadline:
        engine.clear_prefix_cache()
        if alloc.free_count == alloc.total:
            break
        time.sleep(0.02)
    assert alloc.free_count == alloc.total
    assert alloc.shared_count == 0


# ------------------------------------------------------------ prefix cache


class _CachePair:
    """The JAX cache and the port's, each over its package's allocator,
    driven by one operation sequence and compared after every step."""

    def __init__(self, page_size=4, pages=24):
        self.ps = page_size
        self.caches = (JaxRadixCache(page_size),
                       RadixPrefixCache(page_size))
        self.allocs = (jpaged.PageAllocator(pages),
                       tpaged.PageAllocator(pages))
        self.total = pages

    def _both(self, fn):
        out = [fn(c, a) for c, a in zip(self.caches, self.allocs)]
        self.check()
        assert out[0] == out[1]
        return out[0]

    def check(self):
        (jc, tc), (ja, ta) = self.caches, self.allocs
        assert jc.stats() == tc.stats()
        assert ja.free_count == ta.free_count
        assert ja.shared_count == ta.shared_count
        assert ([ja.refs(p) for p in range(self.total)]
                == [ta.refs(p) for p in range(self.total)])

    def prefill(self, adapter, tokens):
        """Admit, "prefill" and finish one sequence as the engine does:
        look up and claim the match, allocate the rest, insert the full
        pages, then release the sequence's refs."""
        n_pages = -(-len(tokens) // self.ps)

        def run(cache, alloc):
            m = cache.lookup(adapter, tokens)
            cache.claim(m, alloc)
            fresh = alloc.alloc(n_pages - len(m.pages))
            if fresh is None:  # pool pressure: roll the claim back
                alloc.free(m.pages + ([m.cow_src] if m.cow_src is not None
                                      else []))
                return ("full", m.prefix_len)
            if m.cow_src is not None:
                alloc.free([m.cow_src])  # the copy ran
            pages = m.pages + fresh
            full = len(tokens) // self.ps
            added = cache.insert(adapter, tokens[:full * self.ps],
                                 pages[:full], alloc)
            alloc.free(pages)
            return (m.pages, m.matched_len, m.cow_src, m.cow_overlap,
                    m.prefix_len, m.hit, added)

        return self._both(run)

    def evict(self, want):
        return self._both(lambda c, a: c.evict_leaves(want, a))

    def drop(self, adapter):
        return self._both(lambda c, a: c.drop_adapter(adapter, a))

    def clear(self):
        return self._both(lambda c, a: c.clear(a))


_BASE = list(range(1, 13))
_CACHE_SEQUENCES = {
    "hit_and_cow": [("prefill", None, _BASE), ("prefill", None, _BASE),
                    ("prefill", None, _BASE[:6] + [90, 91, 92, 93]),
                    ("prefill", None, _BASE[:2] + [70]),
                    ("prefill", None, _BASE[:4]), ("clear",)],
    "adapters_apart": [("prefill", None, _BASE), ("prefill", "a", _BASE),
                       ("prefill", "a", _BASE), ("drop", "a"),
                       ("prefill", "a", _BASE), ("drop", "b"), ("clear",)],
    "lru_eviction": [("prefill", None, _BASE), ("prefill", None, [5] * 12),
                     ("prefill", None, _BASE), ("evict", 2),
                     ("prefill", None, [5] * 12), ("evict", 100),
                     ("clear",)],
    "pool_pressure": [("prefill", None, list(range(40))),
                      ("prefill", "x", list(range(50, 90))),
                      ("prefill", None, list(range(100, 196))),
                      ("evict", 3), ("prefill", None, list(range(40))),
                      ("clear",)],
}


def _apply(pair, ops):
    for op in ops:
        getattr(pair, op[0])(*op[1:])
    pair.clear()
    assert pair.allocs[1].free_count == pair.total


@pytest.mark.parametrize("name", sorted(_CACHE_SEQUENCES))
def test_prefix_cache_matches_jax(name):
    _apply(_CachePair(), _CACHE_SEQUENCES[name])


_op = st.one_of(
    st.tuples(st.just("prefill"), st.sampled_from([None, "a"]),
              st.lists(st.integers(0, 3), min_size=1, max_size=14)),
    st.tuples(st.just("evict"), st.integers(0, 4)),
    st.tuples(st.just("drop"), st.sampled_from([None, "a"])),
    st.tuples(st.just("clear")))


@settings(max_examples=30, deadline=None)
@given(st.lists(_op, max_size=12))
def test_prefix_cache_matches_jax_random_sequences(ops):
    _apply(_CachePair(page_size=2, pages=16), ops)


# ----------------------------------------------------- page copy, adapters


@pytest.mark.parametrize("src,dst", [(0, 3), (5, 1), (2, 2)])
def test_copy_page_matches_jax_bit_for_bit(models, src, dst):
    jc, _, tc, _ = models
    rng = np.random.default_rng(src * 7 + dst)
    shape = (tc.n_layers, 7, tc.n_kv_heads, 8, tc.head_dim)
    pools = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    want = jpaged.copy_page({n: jnp.asarray(a) for n, a in pools.items()},
                            jnp.asarray(src), jnp.asarray(dst))
    t_pools = {n: torch.from_numpy(a.copy()) for n, a in pools.items()}
    calls = tpaged.call_count("page_copy")
    got = tpaged.copy_page(t_pools, src, dst)
    assert got is t_pools  # in place
    assert tpaged.call_count("page_copy") == calls + 1
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


@pytest.mark.parametrize("via", ["numpy_tree", "lora"])
def test_pack_lora_and_adapter_load_match_jax(models, jax_loras, via):
    jc, _, tc, _ = models
    tree = jax_loras[1]
    j_packed = jpaged.pack_lora(jc, tree)
    j_pool = jpaged.adapter_load(jpaged.init_adapter_pool(jc, 2, RANK),
                                 jnp.asarray(1, jnp.int32), j_packed)
    src = tree if via == "numpy_tree" else lora_from_jax(tc, tree, "cpu")
    t_packed = tpaged.pack_lora(tc, src, device="cpu")
    t_pool = tpaged.init_adapter_pool(tc, 2, RANK, device="cpu")
    assert tpaged.adapter_load(t_pool, 1, t_packed) is t_pool
    for name in ("qa", "qb", "va", "vb", "scale"):
        np.testing.assert_array_equal(t_packed[name].numpy(),
                                      np.asarray(j_packed[name]))
        np.testing.assert_array_equal(t_pool[name].numpy(),
                                      np.asarray(j_pool[name]))
    wrong = tpaged.pack_lora(tc, random_lora(tc, 1, rank=RANK + 1,
                                             device="cpu"))
    with pytest.raises(ValueError, match="does not fit"):
        tpaged.adapter_load(t_pool, 0, wrong)


# ------------------------------------------------- paged_prefill_prefix


def _adapters(cfg, rng, slots=2, rank=RANK):
    """Random LoRA arrays for ``slots`` adapters plus the zero slot."""
    L, d = cfg.n_layers, cfg.d_model
    kv = cfg.n_kv_heads * cfg.head_dim
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


def _pools_close(t_pools, j_pools, scratch):
    for name in ("k", "v"):
        # Duplicate writes into the scratch page land in either order.
        np.testing.assert_allclose(
            np.delete(t_pools[name].numpy(), scratch, axis=1),
            np.delete(np.asarray(j_pools[name]), scratch, axis=1),
            atol=1e-5, rtol=1e-5)


# (maxp, prompt A's length, prefix_len, prompt B's length, suffix bucket):
# B = A[:prefix_len] + a new tail, served from A's cached pages.
_PREFIX_CASES = {
    "full_page_hit": (4, 20, 16, 22, 8),
    "mid_page_split": (4, 20, 11, 18, 8),
    # prefix_len + S_pad = 25 > MAXP * ps = 24: padded rows past the table.
    "past_the_table": (3, 22, 17, 22, 8),
}


@pytest.mark.parametrize("case", sorted(_PREFIX_CASES))
def test_paged_prefill_prefix_matches_jax(models, case):
    jc, jp, tc, tp = models
    maxp, n_a, prefix_len, n_b, s_pad = _PREFIX_CASES[case]
    ps, P, aid = 8, 10, 1
    scratch = P
    rng = np.random.default_rng(len(case))
    ad = _adapters(tc, rng)
    j_ad = {k: jnp.asarray(v) for k, v in ad.items()}
    t_ad = {k: torch.from_numpy(v) for k, v in ad.items()}
    j_pools = jpaged.init_paged_pools(jc, P, ps)
    t_pools = tpaged.init_paged_pools(tc, P, ps)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    prompt_a = rng.integers(0, 512, n_a).astype(np.int32)
    prompt_b = np.concatenate([prompt_a[:prefix_len],
                               rng.integers(0, 512, n_b - prefix_len)]
                              ).astype(np.int32)
    # Both pools prefill A cold into pages [0, maxp).
    pt_a = np.arange(maxp, dtype=np.int32)
    toks = np.zeros((1, maxp * ps), np.int32)
    toks[0, :n_a] = prompt_a
    j_tok, key, j_pools = jpaged.paged_prefill(
        jc, jp, j_pools, j_ad, jnp.asarray(toks), jnp.asarray(n_a),
        jnp.asarray(pt_a), jnp.asarray(aid), jnp.asarray(0.0), key)
    t_tok, gen, t_pools = tpaged.paged_prefill(
        tc, tp, t_pools, t_ad, torch.from_numpy(toks), n_a,
        torch.from_numpy(pt_a), aid, torch.tensor(0.0), gen)
    assert int(t_tok) == int(j_tok)
    # B's table: A's full prefix pages, then fresh pages; a mid-page split
    # copies A's divergent page into the first fresh one.
    shared = prefix_len // ps
    pt_b = np.concatenate([pt_a[:shared],
                           np.arange(maxp, 2 * maxp - shared)]
                          ).astype(np.int32)
    if prefix_len % ps:
        j_pools = jpaged.copy_page(j_pools, jnp.asarray(pt_a[shared]),
                                   jnp.asarray(pt_b[shared]))
        t_pools = tpaged.copy_page(t_pools, int(pt_a[shared]),
                                   int(pt_b[shared]))
    suffix = np.zeros((1, s_pad), np.int32)
    suffix[0, :n_b - prefix_len] = prompt_b[prefix_len:]
    if case == "past_the_table":
        assert prefix_len + s_pad > maxp * ps
    before = tpaged.call_count("prefill_prefix")
    j_tok, key, j_pools = jpaged.paged_prefill_prefix(
        jc, jp, j_pools, j_ad, jnp.asarray(suffix), jnp.asarray(prefix_len),
        jnp.asarray(n_b), jnp.asarray(pt_b), jnp.asarray(aid),
        jnp.asarray(0.0), key)
    t_tok, gen, t_pools = tpaged.paged_prefill_prefix(
        tc, tp, t_pools, t_ad, torch.from_numpy(suffix), prefix_len, n_b,
        torch.from_numpy(pt_b), aid, torch.tensor(0.0), gen)
    assert tpaged.call_count("prefill_prefix") == before + 1
    assert int(t_tok) == int(j_tok)
    _pools_close(t_pools, j_pools, scratch)


# ----------------------------------------------------------------- engine


def test_prefix_cache_hit_and_cow_parity(models, engine):
    """Cached-prefix decode (full-page hit and mid-page copy-on-write) is
    token-exact against JAX ``generate``, and adds no decode signature."""
    jc, jp, _, _ = models
    _drain(engine)
    before = engine.stats()["prefix_cache"]
    decode_before = tpaged.trace_count("decode")
    prompt = list(range(2, 14))           # 12 tokens -> one full page
    cold = list(engine.submit(prompt, max_new_tokens=6))
    assert cold == _jax_ref(jc, jp, prompt, 6)
    warm = list(engine.submit(prompt, max_new_tokens=6))
    assert warm == cold
    # Divergence INSIDE the cached page: 5 tokens shared.
    fork = prompt[:5] + [91, 92, 93, 94, 95, 96, 97]
    assert list(engine.submit(fork, max_new_tokens=6)) == _jax_ref(
        jc, jp, fork, 6)
    st_ = engine.stats()
    assert st_["prefix_cache"]["hits"] - before["hits"] >= 2
    assert st_["prefill_prefix_traces"] >= 1
    assert tpaged.trace_count("decode") == decode_before
    _drain(engine)


def test_adapter_mix_parity_and_one_decode_program(models, jax_loras,
                                                   engine):
    """Requests on different adapters decode in one batch, each equal to
    JAX ``generate`` on the JAX adapter merged into the base, with one
    decode signature for the whole mix."""
    jc, jp, tc, _ = models
    # One adapter as the port's Lora, one as a lazy numpy tree.
    engine.register_adapter("a1", lora_from_jax(tc, jax_loras[1], "cpu"))
    engine.register_adapter("a2", lambda: jax_loras[2])
    decode_before = tpaged.trace_count("decode")
    prompt = [5, 7, 11]
    streams = {None: engine.submit(prompt, max_new_tokens=6),
               "a1": engine.submit(prompt, max_new_tokens=6, adapter="a1"),
               "a2": engine.submit(prompt, max_new_tokens=6, adapter="a2")}
    got = {k: list(s) for k, s in streams.items()}
    for name, seed in (("a1", 1), ("a2", 2)):
        merged = jax_lora_merge(jc, jp, jax.tree.map(jnp.asarray,
                                                     jax_loras[seed]))
        assert got[name] == _jax_ref(jc, merged, prompt, 6), name
    assert got[None] == _jax_ref(jc, jp, prompt, 6)
    assert tpaged.trace_count("decode") == decode_before
    assert engine.stats()["adapters"]["loads"] >= 2
    _drain(engine)


def test_free_list_balances_with_cache_hits_and_cancels(engine):
    _drain(engine)
    prompt = list(range(50, 62))          # 12 tokens, shares one page
    for _ in range(4):
        streams = [engine.submit(prompt, max_new_tokens=4)
                   for _ in range(3)]
        victim = engine.submit(prompt, max_new_tokens=32)
        next(victim)
        victim.cancel()
        for s in streams:
            assert len(list(s)) == 4
    _drain(engine)


def test_adapter_pool_lru_eviction_and_pinning(models):
    """Pinned residents are never evicted, LRU unpinned ones are, and
    misuse fails loudly; unreadable sources raise TypeError."""
    tc = models[2]
    pool = AdapterPool(tc, max_adapters=2, rank=4, device="cpu")
    for name, seed in (("a", 1), ("b", 2), ("c", 3)):
        pool.register(name, lambda s=seed: random_lora(tc, s, rank=4,
                                                       device="cpu"))
    with pytest.raises(AdapterNotFoundError):
        pool.acquire("never-registered")
    assert pool.acquire(None) == pool.zero_slot
    slot_a = pool.acquire("a")
    pool.acquire("b")
    assert not pool.can_acquire("c")
    with pytest.raises(RuntimeError, match="pinned"):
        pool.acquire("c")
    pool.release("a")
    assert pool.can_acquire("c")
    assert pool.acquire("c") == slot_a
    assert pool.resident("c") and pool.resident("b")
    assert not pool.resident("a")
    assert pool.evictions == 1
    assert pool.loads == 3 and pool.pinned_count == 2
    with pytest.raises(AssertionError, match="unpinned"):
        pool.release("a")
    with pytest.raises(RuntimeError, match="pinned"):
        pool.register("b", lambda: random_lora(tc, 9, rank=4, device="cpu"))
    pool.release("b")
    assert pool.register("b", lambda: random_lora(tc, 9, rank=4,
                                                  device="cpu"))
    assert not pool.resident("b")

    class ObjectRef:  # named like the runtime's ref, but not one
        pass

    with pytest.raises(TypeError, match="expected"):
        pool.register("d", ObjectRef())
    with pytest.raises(TypeError, match="expected"):
        pool.register("d", 3.0)
    pool.register("d", lambda: 3.0)
    pool.release("c")
    with pytest.raises(TypeError, match="expected"):
        pool.acquire("d")


def test_slo_signals_shape(engine):
    list(engine.submit([4, 5, 6], max_new_tokens=3))
    sig = engine.slo_signals()
    assert sig["batch_slots"] == engine.config.batch_slots
    assert sig["ttft_count"] > 0
    assert sig["ttft_p90_s"] > 0
    assert sig["ttft_p90_s"] >= sig["ttft_p50_s"]
    assert sig["step_p99_s"] >= sig["step_p50_s"] > 0
    assert isinstance(sig["queue_depth"], int)
    _drain(engine)


def test_default_engine_config_serves_on_the_cpu(models):
    """``EngineConfig()`` (prefix cache on) builds and serves: a repeated
    prompt hits the cache and matches JAX ``generate``."""
    jc, jp, tc, tp = models
    eng = InferenceEngine(tc, tp, EngineConfig(), device="cpu")
    try:
        prompt = list(range(3, 23))  # 20 tokens: one full 16-token page
        first = list(eng.submit(prompt, max_new_tokens=4))
        again = list(eng.submit(prompt, max_new_tokens=4))
        assert first == again == _jax_ref(jc, jp, prompt, 4)
        st_ = eng.stats()
        assert st_["prefix_hits"] == 1 and st_["prefix_cache"]["pages"] == 1
        _drain(eng)
    finally:
        eng.shutdown()


def test_register_adapter_replacing_resident_drops_its_tree(models,
                                                            jax_loras,
                                                            engine):
    jc, jp, _, _ = models
    _drain(engine)
    prompt = list(range(20, 32))  # one full page cached under "r"
    engine.register_adapter("r", jax_loras[1])
    list(engine.submit(prompt, max_new_tokens=2, adapter="r"))
    assert engine.stats()["prefix_cache"]["pages"] == 1
    assert engine.adapter_pool.resident("r")
    engine.register_adapter("r", jax_loras[3])
    assert engine.stats()["prefix_cache"]["pages"] == 0
    assert not engine.adapter_pool.resident("r")
    merged = jax_lora_merge(jc, jp, jax.tree.map(jnp.asarray, jax_loras[3]))
    got = list(engine.submit(prompt, max_new_tokens=2, adapter="r"))
    assert got == _jax_ref(jc, merged, prompt, 2)
    _drain(engine)


def test_fail_inflight_clears_cache_and_resets_pool(models, jax_loras,
                                                    monkeypatch):
    """A failed decode errors the in-flight streams, drops the cache's
    pages and the resident adapters with the rebuilt pools, and the
    engine then serves the adapter again, reloaded."""
    import ray_tpu_torch.serve.engine as engine_mod

    jc, jp, tc, tp = models
    eng = InferenceEngine(tc, tp, EngineConfig(**GEOMETRY), device="cpu")
    try:
        eng.register_adapter("f", jax_loras[2])
        prompt = list(range(40, 52))
        list(eng.submit(prompt, max_new_tokens=2, adapter="f"))
        assert eng.stats()["prefix_cache"]["pages"] == 1
        real = engine_mod.paged_decode_step
        calls = {"n": 0}

        def boom(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return real(*a, **kw)

        monkeypatch.setattr(engine_mod, "paged_decode_step", boom)
        with pytest.raises(RuntimeError, match="injected"):
            list(eng.submit(prompt, max_new_tokens=4, adapter="f"))
        st_ = eng.stats()
        assert st_["prefix_cache"]["pages"] == 0
        assert st_["adapters"]["resident"] == []
        assert eng.allocator.free_count == eng.allocator.total
        merged = jax_lora_merge(jc, jp, jax.tree.map(jnp.asarray,
                                                     jax_loras[2]))
        got = list(eng.submit(prompt, max_new_tokens=4, adapter="f"))
        assert got == _jax_ref(jc, merged, prompt, 4)
        assert eng.stats()["adapters"]["loads"] == 2
        _drain(eng)
    finally:
        eng.shutdown()


def test_engine_serves_the_jax_engines_script(models, jax_loras):
    """The JAX engine and the port's serve one script one request at a
    time (cold, hit, copy-on-write fork, an adapter's cold and hit):
    equal tokens, prefix-cache stats and adapter loads."""
    jc, jp, tc, tp = models
    script = [(list(range(60, 72)), None), (list(range(60, 72)), None),
              (list(range(60, 66)) + [1, 2, 3], None),
              (list(range(60, 72)), "a"), (list(range(60, 72)), "a")]
    j_eng = jengine.InferenceEngine(jc, jp, jengine.EngineConfig(**GEOMETRY))
    t_eng = InferenceEngine(tc, tp, EngineConfig(**GEOMETRY), device="cpu")
    try:
        j_eng.register_adapter("a", jax_loras[1])
        t_eng.register_adapter("a", jax_loras[1])
        for prompt, adapter in script:
            want = list(j_eng.submit(prompt, max_new_tokens=3,
                                     adapter=adapter))
            got = list(t_eng.submit(prompt, max_new_tokens=3,
                                    adapter=adapter))
            assert got == want, (prompt, adapter)
        j_st, t_st = j_eng.stats(), t_eng.stats()
        assert t_st["prefix_cache"] == j_st["prefix_cache"]
        assert t_st["prefix_cache"]["hits"] == 3
        assert t_st["adapters"]["loads"] == j_st["adapters"]["loads"] == 1
        assert t_eng.clear_prefix_cache() == j_eng.clear_prefix_cache()
    finally:
        j_eng.shutdown()
        t_eng.shutdown()
