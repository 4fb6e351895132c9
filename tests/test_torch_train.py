"""CPU parity of the port's training path with the JAX package: the masked
NLL, ``llama_loss`` with every gradient, AdamW train steps (plain, with
gradient accumulation, and over LoRA adapters) and ``lora_merge``.

Both packages get the same numpy weights (``params_from_jax`` /
``lora_from_jax``) and tokens, in fp32.  On the CPU the JAX package's
attention takes ``mha_reference`` and the port's the plain versions of
kernels K1-K3; the two agree to fp32 summation-order noise, hence the
tolerances below.  Parameters are compared by name: the port's
``layers.0.attn.wq`` is the JAX tree's ``["layers"][0]["attn"]["wq"]``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import TrainState as JaxTrainState
from ray_tpu.models import llama_apply as jax_llama_apply
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.models import llama_loss as jax_llama_loss
from ray_tpu.models import lora_init as jax_lora_init
from ray_tpu.models import lora_merge as jax_lora_merge
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models.train_state import default_optimizer as jax_optimizer
from ray_tpu.ops.losses import masked_nll as jax_masked_nll
from ray_tpu_torch.models import (LlamaConfig, TrainState, default_optimizer,
                                  llama_apply, llama_loss, lora_from_jax,
                                  lora_merge, make_train_step,
                                  params_from_jax)
from ray_tpu_torch.ops.losses import masked_cross_entropy, masked_nll

# (n_heads, n_kv_heads): tiny's own GQA group 2, and full MHA.
_HEADS = {"tiny": (4, 2), "mha": (4, 4)}


def _pair(name="tiny", loss_chunk=256, remat=False, seed=0):
    h, hkv = _HEADS[name]
    jc = dataclasses.replace(JaxConfig.tiny(remat=False, dtype=jnp.float32),
                             n_heads=h, n_kv_heads=hkv, loss_chunk=loss_chunk)
    tc = dataclasses.replace(LlamaConfig.tiny(dtype=torch.float32),
                             n_heads=h, n_kv_heads=hkv, loss_chunk=loss_chunk,
                             remat=remat)
    jp = jax_llama_init(jc, jax.random.PRNGKey(seed))
    return jc, jp, tc, jax.tree.map(np.asarray, jp)


def _batch(B=4, S=32, seed=1, ignored=3):
    """Tokens and next-token targets (roll by one, as bench.py does), with
    a few targets set to the ignore index."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, 512, (B, S)).astype(np.int32)
    tgt = np.roll(toks, -1, axis=1)
    tgt[r.integers(0, B, ignored), r.integers(0, S, ignored)] = -100
    return toks, tgt


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[int(key)] if key.isdigit() else tree[key]
    return np.asarray(tree)


def _assert_tree(module, tree, attr, atol, rtol):
    """Every parameter (or its .grad) of the torch module against the JAX
    tree leaf of the same name."""
    names = []
    for name, p in module.named_parameters():
        got = getattr(p, attr) if attr else p
        np.testing.assert_allclose(got.detach().numpy(), _leaf(tree, name),
                                   atol=atol, rtol=rtol, err_msg=name)
        names.append(name)
    assert len(names) == len(jax.tree.leaves(tree))


@pytest.mark.parametrize("ignore_index", [-100, 7])
def test_masked_nll_matches_jax(ignore_index):
    r = np.random.default_rng(2)
    logits = (3 * r.standard_normal((2, 5, 50))).astype(np.float32)
    tgt = r.integers(0, 50, (2, 5)).astype(np.int32)
    tgt[0, 1] = tgt[1, 3] = ignore_index if ignore_index >= 0 else -100
    tot_j, cnt_j = jax_masked_nll(jnp.asarray(logits), jnp.asarray(tgt),
                                  ignore_index)
    tot, cnt = masked_nll(torch.from_numpy(logits), torch.from_numpy(tgt),
                          ignore_index)
    n = int((tgt != ignore_index).sum())
    assert int(cnt) == int(cnt_j) == n < tgt.size
    np.testing.assert_allclose(float(tot), float(tot_j), rtol=1e-6)
    np.testing.assert_allclose(
        float(masked_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(tgt), ignore_index)),
        float(tot_j) / n, rtol=1e-6)


# loss_chunk 8 divides S = 32 (four checkpointed chunks); 12 does not (one
# unchunked pass).
@pytest.mark.parametrize("name,loss_chunk", [("tiny", 8), ("tiny", 12),
                                             ("mha", 8), ("mha", 12)])
def test_llama_loss_and_grads_match_jax(name, loss_chunk):
    jc, jp, tc, np_tree = _pair(name, loss_chunk)
    toks, tgt = _batch()
    want, jgrads = jax.value_and_grad(
        lambda p: jax_llama_loss(jc, p, jnp.asarray(toks),
                                 jnp.asarray(tgt)))(jp)
    tp = params_from_jax(tc, np_tree, device="cpu", trainable=True)
    loss = llama_loss(tc, tp, torch.from_numpy(toks).long(),
                      torch.from_numpy(tgt).long())
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    # Gradients reach ~1e-1; fp32 noise through two layers stays < 1e-6.
    _assert_tree(tp, jgrads, "grad", atol=2e-6, rtol=1e-4)


def test_remat_gives_the_same_loss_and_grads():
    """Checkpointed blocks recompute the same forward: loss and every
    gradient equal the unrematerialised ones."""
    _, _, tc, np_tree = _pair("tiny", loss_chunk=8)
    toks, tgt = (torch.from_numpy(a).long() for a in _batch())
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        tp = params_from_jax(cfg, np_tree, device="cpu", trainable=True)
        loss = llama_loss(cfg, tp, toks, tgt)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    tp.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.allclose(l0, l1, rtol=0, atol=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-6, atol=1e-7,
                                   msg=n)


def test_unported_training_options_raise():
    _, _, tc, np_tree = _pair("tiny")
    tp = params_from_jax(tc, np_tree, device="cpu", trainable=True)
    toks = torch.zeros((1, 8), dtype=torch.long)
    cfg = dataclasses.replace(tc, remat=True, remat_policy="save_attn")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama_loss(cfg, tp, toks, toks)
    with torch.no_grad():  # the policy only matters under autograd
        assert llama_apply(cfg, tp, toks).shape == (1, 8, tc.vocab_size)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(lambda p, b: p, default_optimizer(), mesh=object())


@pytest.mark.parametrize("count", [0, 1, 4, 5, 9, 20, 30])
def test_learning_rate_schedule_matches_optax(count):
    tx = default_optimizer(lr=3e-4, warmup_steps=5, total_steps=20)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 20)
    np.testing.assert_allclose(tx.learning_rate(count), float(sched(count)),
                               rtol=1e-6, atol=1e-12)
    assert default_optimizer(lr=3e-4).learning_rate(count) == 3e-4


def _lora_np(jc, rank=4, seed=3):
    """JAX adapters with a random (non-zero) B, so they change the model."""
    r = np.random.default_rng(seed)
    lora = jax.tree.map(np.asarray, jax_lora_init(jc, jax.random.PRNGKey(1),
                                                  rank=rank))
    for ll in lora["layers"]:
        for key in ("wq_lora_b", "wv_lora_b"):
            ll[key] = (0.1 * r.standard_normal(ll[key].shape)).astype(
                np.float32)
    return lora


# (what is trained, grad_accum, accumulate in fp32, optimizer): the anchors
# of the JAX package's own tests (tiny, B=4, S=32, lr 1e-3); "sched" adds
# a warmup-cosine schedule and weight decay.
@pytest.mark.parametrize("what,grad_accum,acc32,opt", [
    ("full", 1, False, "plain"), ("full", 2, False, "plain"),
    ("full", 2, True, "plain"), ("full", 1, False, "sched"),
    ("lora", 1, False, "plain")])
def test_train_steps_match_jax(what, grad_accum, acc32, opt):
    jc, jp, tc, np_tree = _pair("tiny", loss_chunk=8)
    toks, tgt = _batch()
    kw = (dict(lr=1e-3) if opt == "plain" else
          dict(lr=1e-3, warmup_steps=2, total_steps=5, weight_decay=0.1))
    jtx, ttx = jax_optimizer(**kw), default_optimizer(**kw)
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "targets": torch.from_numpy(tgt).long()}
    if what == "full":
        j_state = JaxTrainState.create(jp, jtx)
        j_loss = lambda p, b: jax_llama_loss(jc, p, b["tokens"],
                                             b["targets"])
        tmodel = params_from_jax(tc, np_tree, device="cpu", trainable=True)
        t_loss = lambda p, b: llama_loss(tc, p, b["tokens"], b["targets"])
    else:
        lora = _lora_np(jc)
        j_state = JaxTrainState.create(jax.tree.map(jnp.asarray, lora), jtx)
        j_loss = lambda lp, b: jax_llama_loss(jc, jp, b["tokens"],
                                              b["targets"], lp)
        base = params_from_jax(tc, np_tree, device="cpu")
        tmodel = lora_from_jax(tc, lora, device="cpu")
        t_loss = lambda lp, b: llama_loss(tc, base, b["tokens"],
                                          b["targets"], lp)
    j_step = jax_make_train_step(j_loss, jtx, grad_accum=grad_accum,
                                 accum_dtype=jnp.float32 if acc32 else None)
    t_step = make_train_step(t_loss, ttx, grad_accum=grad_accum,
                             accum_dtype=torch.float32 if acc32 else None)
    t_state = TrainState.create(tmodel, ttx)
    for i in range(3):
        j_state, jm = j_step(j_state, jbatch)
        t_state, tm = t_step(t_state, tbatch)
        assert tm["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    # Adam divides by sqrt(v): on elements whose gradient is near zero the
    # fp32 noise of the two gradients moves an update by up to ~lr, so the
    # parameters agree to a few lr-sized ulps, not to fp32 precision.
    _assert_tree(t_state.params, j_state.params, None, atol=2e-5, rtol=1e-4)


def test_lora_loss_and_merge_match_jax():
    jc, jp, tc, np_tree = _pair("tiny")
    lora = _lora_np(jc)
    toks, tgt = _batch()
    want, jgrads = jax.value_and_grad(
        lambda lp: jax_llama_loss(jc, jp, jnp.asarray(toks),
                                  jnp.asarray(tgt), lp))(
        jax.tree.map(jnp.asarray, lora))
    base = params_from_jax(tc, np_tree, device="cpu")
    tl = lora_from_jax(tc, lora, device="cpu")
    ttoks, ttgt = torch.from_numpy(toks).long(), torch.from_numpy(tgt).long()
    loss = llama_loss(tc, base, ttoks, ttgt, tl)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _assert_tree(tl, jgrads, "grad", atol=2e-6, rtol=1e-4)
    assert all(p.grad is None for p in base.parameters())

    merged = lora_merge(tc, base, tl)
    jmerged = jax_lora_merge(jc, jp, lora)
    _assert_tree(merged, jmerged, None, atol=1e-6, rtol=1e-6)
    assert merged.embed.data_ptr() == base.embed.data_ptr()  # shared
    with torch.no_grad():
        got = llama_apply(tc, merged, ttoks)
        adapted = llama_apply(tc, base, ttoks, tl)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_llama_apply(jc, jmerged, jnp.asarray(toks))),
        atol=1e-4)
    np.testing.assert_allclose(got.numpy(), adapted.numpy(), atol=1e-4)


def test_lora_init_starts_at_the_base_model():
    """Fresh adapters (B = 0) leave the model unchanged, as in the JAX
    package's LoRA test; A ~ N(0, d^-1/2), scale = alpha / rank, and every
    adapter parameter is trainable."""
    from ray_tpu_torch.models import lora_init

    jc, jp, tc, np_tree = _pair("tiny")
    base = params_from_jax(tc, np_tree, device="cpu")
    lora = lora_init(tc, torch.Generator().manual_seed(4), rank=8,
                     alpha=16.0, device="cpu")
    assert all(p.requires_grad for p in lora.parameters())
    ll = lora.layers[1]
    assert ll.scale.item() == 2.0 and not ll.wv_lora_b.any()
    assert ll.wv_lora_b.shape == (8, tc.n_kv_heads * tc.head_dim)
    assert abs(ll.wq_lora_a.std().item() * tc.d_model ** 0.5 - 1) < 0.15
    toks = torch.from_numpy(_batch(B=2, S=16)[0]).long()
    with torch.no_grad():
        torch.testing.assert_close(llama_apply(tc, base, toks, lora),
                                   llama_apply(tc, base, toks), rtol=0,
                                   atol=1e-6)
