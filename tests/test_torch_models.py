"""CPU parity of the PyTorch port's Llama forward pass and KV-cache decoding
with the JAX package: the same numpy weights (``params_from_jax``) and
tokens go through both; fp32 logits agree to 1e-4 and greedy decoding
agrees token for token."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.models.generate import generate as jax_generate
from ray_tpu.models.llama import llama_apply as jax_llama_apply
from ray_tpu_torch.models.generate import generate
from ray_tpu_torch.models.llama import (LlamaConfig, llama_apply, llama_init,
                                        params_from_jax)

# (n_heads, n_kv_heads): tiny's own GQA group 2, full MHA, and group 4.
_HEADS = {"tiny": (4, 2), "mha": (4, 4), "gqa4": (8, 2)}


def _pair(name, dtype=jnp.float32):
    h, hkv = _HEADS[name]
    jc = dataclasses.replace(JaxConfig.tiny(remat=False, dtype=dtype),
                             n_heads=h, n_kv_heads=hkv)
    tc = dataclasses.replace(
        LlamaConfig.tiny(dtype=torch.float32), n_heads=h, n_kv_heads=hkv)
    jp = jax_llama_init(jc, jax.random.PRNGKey(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


@pytest.mark.parametrize("name", sorted(_HEADS))
def test_llama_apply_matches_jax(name):
    jc, jp, tc, tp = _pair(name)
    toks = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(np.int32)
    want = np.asarray(jax_llama_apply(jc, jp, jnp.asarray(toks)))
    got = llama_apply(tc, tp, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


# bf16, the tiny model's default dtype (head_dim 32): each side rounds
# every weight, activation and attention output to bf16 (unit roundoff
# 2^-8) at its own places, so each lies about 0.6 % (relative norm) from
# the fp32 logits and the two about 0.7 % apart; 2e-2 bounds that with
# room, and top-1 flips only where the top-2 margin is inside it.
@pytest.mark.parametrize("name", ["tiny", "mha"])
def test_llama_apply_bf16_matches_jax(name):
    jc, jp, _, _ = _pair(name, dtype=jnp.bfloat16)
    tc = dataclasses.replace(LlamaConfig.tiny(), n_heads=jc.n_heads,
                             n_kv_heads=jc.n_kv_heads)
    assert tc.dtype == torch.bfloat16 and tc.head_dim == 32
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, 512, (2, 64)).astype(np.int32)
    want = np.asarray(jax_llama_apply(jc, jp, jnp.asarray(toks)),
                      dtype=np.float32)
    got = llama_apply(tc, tp, torch.from_numpy(toks).long()).float().numpy()
    assert got.shape == want.shape
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    top1 = (got.argmax(-1) == want.argmax(-1)).mean()
    assert rel <= 2e-2 and top1 >= 0.9, (rel, top1)


@pytest.mark.parametrize("name,batch", [("tiny", 1), ("tiny", 2),
                                        ("gqa4", 2)])
def test_generate_greedy_matches_jax(name, batch):
    jc, jp, tc, tp = _pair(name)
    prompt = np.random.default_rng(1).integers(
        0, 512, (batch, 7)).astype(np.int32)
    want = np.asarray(jax_generate(jc, jp, prompt, max_new_tokens=8))
    streamed = []
    got = generate(tc, tp, prompt, max_new_tokens=8,
                   stream=streamed.append).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(streamed) == 8 and streamed[0].shape == (batch,)


def test_params_from_jax_keeps_bf16_weights_exactly():
    jc = JaxConfig.tiny(remat=False, dtype=jnp.bfloat16)
    jp = jax_llama_init(jc, jax.random.PRNGKey(1))
    tc = LlamaConfig.tiny()
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp), device="cpu")
    assert tp.embed.dtype == torch.bfloat16
    want = np.asarray(jp["layers"][1]["mlp"]["w2"]).astype(np.float32)
    np.testing.assert_array_equal(tp.layers[1].mlp.w2.float().numpy(), want)


def test_llama_init_distributions():
    cfg = dataclasses.replace(LlamaConfig.tiny(dtype=torch.float32),
                              vocab_size=2048)
    gen = torch.Generator().manual_seed(3)
    p = llama_init(cfg, gen, device="cpu")
    assert p.device == torch.device("cpu")
    assert not any(t.requires_grad for t in p.parameters())
    assert abs(float(p.embed.std()) - 1.0) < 0.02
    assert abs(float(p.layers[0].attn.wq.std()) * cfg.d_model ** 0.5
               - 1.0) < 0.05
    assert abs(float(p.layers[0].mlp.w2.std()) * cfg.d_ff ** 0.5
               - 1.0) < 0.05
    assert bool((p.final_norm == 1).all()) and bool(
        (p.layers[1].mlp_norm == 1).all())
    # Same generator seed, same weights.
    q = llama_init(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert p.lm_head.equal(q.lm_head)
