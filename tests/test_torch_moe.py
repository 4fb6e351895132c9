"""CPU parity of the port's Mixtral-family MoE model with the JAX package:
the expert FFN (capacity overflow, tied router rows, the one-expert
anchor), ``moe_apply``, ``moe_loss`` with every gradient, AdamW train
steps, weight transfer and initialisation.

Both packages get the same numpy weights (``moe_params_from_jax``) and
inputs, in fp32.  On the CPU the JAX package's attention takes
``mha_reference`` and the port's the plain versions of kernels K1-K3; they
agree to fp32 summation-order noise, hence the tolerances below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import MoEConfig as JaxConfig
from ray_tpu.models import TrainState as JaxTrainState
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models import moe_apply as jax_moe_apply
from ray_tpu.models import moe_init as jax_moe_init
from ray_tpu.models import moe_loss as jax_moe_loss
from ray_tpu.models.moe import _moe_ffn as jax_moe_ffn
from ray_tpu.models.train_state import default_optimizer as jax_optimizer
from ray_tpu_torch.models import (MoEConfig, TrainState, default_optimizer,
                                  make_train_step, moe_apply, moe_init,
                                  moe_loss, moe_params_from_jax)
from ray_tpu_torch.models.moe import Experts, _moe_ffn, _route


def _pair(seed=0, **kw):
    jc = JaxConfig.tiny(remat=False, dtype=jnp.float32, **kw)
    tc = MoEConfig.tiny(remat=False, dtype=torch.float32, **kw)
    jp = jax_moe_init(jc, jax.random.PRNGKey(seed))
    return jc, jp, tc, jax.tree.map(np.asarray, jp)


def _batch(B=4, S=32, seed=1, ignored=3):
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
    names = []
    for name, p in module.named_parameters():
        got = getattr(p, attr) if attr else p
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   _leaf(tree, name).astype(np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)
        names.append(name)
    assert len(names) == len(jax.tree.leaves(tree))


def _ffn_case(case):
    """(config kw, expert weights, x [2, 16, 128]) of one FFN case."""
    r = np.random.default_rng(7)
    d, f = 128, 256
    kw, E = {}, 4
    if case == "single":
        kw, E = dict(n_experts=1, top_k=1, capacity_factor=2.0), 1
    elif case == "overflow":
        kw = dict(capacity_factor=0.5)
    x = r.standard_normal((2, 16, d)).astype(np.float32)
    router = (r.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    if case == "overflow":
        # Skew the router towards expert 2, whose claims then overflow.
        router[:, 2] += 0.3 * np.sign(x.reshape(-1, d).mean(0))
    elif case == "tied":
        x[0, 3] = 0.0       # a zero row: every expert equally likely
        x[1, 7] = 0.0
    elif case == "single":
        router[:] = 0.0
    moe = {"router": router,
           "w1": (0.05 * r.standard_normal((E, d, f))).astype(np.float32),
           "w3": (0.05 * r.standard_normal((E, d, f))).astype(np.float32),
           "w2": (0.05 * r.standard_normal((E, f, d))).astype(np.float32)}
    return kw, moe, x


def _port_experts(tc, moe):
    experts = Experts(tc, torch.device("cpu"))
    with torch.no_grad():
        for k, v in moe.items():
            getattr(experts, k).copy_(torch.from_numpy(v))
    return experts


@pytest.mark.parametrize("case", ["plain", "overflow", "tied", "single"])
def test_moe_ffn_matches_jax(case):
    kw, moe, x = _ffn_case(case)
    jc = dataclasses.replace(JaxConfig.tiny(dtype=jnp.float32), **kw)
    tc = dataclasses.replace(MoEConfig.tiny(dtype=torch.float32), **kw)
    want, want_aux = jax_moe_ffn(jc, jax.tree.map(jnp.asarray, moe),
                                 jnp.asarray(x))
    experts = _port_experts(tc, moe)
    xt = torch.from_numpy(x)
    got, aux = _moe_ffn(tc, experts, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)

    G = x.shape[0] * x.shape[1]
    _, _, top_e, slot_oh = _route(tc, experts.router, xt.reshape(G, -1))
    kept = int(slot_oh.sum())
    if case == "overflow":  # claims past capacity were dropped
        assert kept < G * tc.top_k
        assert int(slot_oh.sum((0, 1, 3)).max()) == tc.capacity(G)
    else:
        assert kept == G * tc.top_k
    if case == "tied":  # lax.top_k's order: the lower expert first
        assert top_e[3].tolist() == [0, 1]
        assert top_e[16 + 7].tolist() == [0, 1]
    if case == "single":  # the anchor: the dense SwiGLU
        w1, w3, w2 = (torch.from_numpy(moe[k][0]) for k in ("w1", "w3",
                                                            "w2"))
        dense = (torch.nn.functional.silu(xt @ w1) * (xt @ w3)) @ w2
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_slot_claims_are_choice_major():
    """Every token's first choice claims a slot before any token's second:
    with capacity 4 and all eight tokens choosing experts (0, 1) first and
    second, the first four tokens keep expert 0 and the next four are
    dropped there; token-major claims would keep tokens 0, 0, 1, 1."""
    tc = MoEConfig(d_model=2, n_experts=4, top_k=2, capacity_factor=0.1)
    assert tc.capacity(8) == 4
    router = torch.zeros(2, 4)
    router[0, 0], router[0, 1] = 2.0, 1.0
    xf = torch.zeros(8, 2)
    xf[:, 0] = 1.0
    _, _, top_e, slot_oh = _route(tc, router, xf)
    assert top_e.tolist() == [[0, 1]] * 8
    kept = slot_oh.sum(-1)  # [G, k, E]
    assert kept[:, 0, 0].tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    assert kept[:, 1, 1].tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    # Slots in claim order: token t's first choice sits in slot t.
    assert slot_oh[:4, 0, 0].argmax(-1).tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("remat", [False, True])
def test_moe_apply_matches_jax(remat):
    jc, jp, tc, np_tree = _pair()
    tc = dataclasses.replace(tc, remat=remat)
    toks, _ = _batch(B=2)
    want, want_aux = jax_moe_apply(jc, jp, jnp.asarray(toks))
    tp = moe_params_from_jax(tc, np_tree, device="cpu", trainable=remat)
    logits, aux = moe_apply(tc, tp, torch.from_numpy(toks).long())
    assert logits.dtype == torch.float32 and logits.shape == (2, 32, 512)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux),
                               rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_match_jax(remat):
    jc, jp, tc, np_tree = _pair()
    tc = dataclasses.replace(tc, remat=remat)
    toks, tgt = _batch()
    want, jgrads = jax.value_and_grad(
        lambda p: jax_moe_loss(jc, p, jnp.asarray(toks),
                               jnp.asarray(tgt)))(jp)
    tp = moe_params_from_jax(tc, np_tree, device="cpu", trainable=True)
    loss = moe_loss(tc, tp, torch.from_numpy(toks).long(),
                    torch.from_numpy(tgt).long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    # Gradients reach ~1e-1; fp32 noise through two layers stays < 1e-6.
    _assert_tree(tp, jgrads, "grad", atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_moe_train_steps_match_jax(grad_accum):
    jc, jp, tc, np_tree = _pair()
    toks, tgt = _batch()
    jtx, ttx = jax_optimizer(lr=1e-3), default_optimizer(lr=1e-3)
    j_step = jax_make_train_step(
        lambda p, b: jax_moe_loss(jc, p, b["tokens"], b["targets"]), jtx,
        grad_accum=grad_accum)
    t_step = make_train_step(
        lambda p, b: moe_loss(tc, p, b["tokens"], b["targets"]), ttx,
        grad_accum=grad_accum)
    j_state = JaxTrainState.create(jp, jtx)
    t_state = TrainState.create(
        moe_params_from_jax(tc, np_tree, device="cpu", trainable=True), ttx)
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "targets": torch.from_numpy(tgt).long()}
    for i in range(3):
        j_state, jm = j_step(j_state, jbatch)
        t_state, tm = t_step(t_state, tbatch)
        assert tm["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    # Adam divides by sqrt(v) + 1e-8: an element whose gradient is near
    # that eps (an expert row few tokens reach, or a sum that cancels) is
    # moved by the fp32 noise of the two gradients, up to ~0.05 lr in
    # three steps here (one w2 element of 131,072), so the parameters
    # agree to 0.1 lr.
    _assert_tree(t_state.params, j_state.params, None, atol=1e-4, rtol=1e-4)


def test_moe_optimizer_moments_follow_param_dtypes():
    """In bf16 the router stays fp32: AdamW keeps each parameter's moments
    in its own dtype, as optax does, and a step updates both kinds."""
    jc = JaxConfig.tiny(dtype=jnp.bfloat16)
    jstate = jax_optimizer().init(jax_moe_init(jc, jax.random.PRNGKey(0)))
    adam = next(s for s in jax.tree.leaves(
        jstate, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    want = {jnp.dtype(a.dtype).name for a in jax.tree.leaves(adam.mu)}
    assert want == {"bfloat16", "float32"}

    tc = MoEConfig.tiny(dtype=torch.bfloat16)
    params = moe_init(tc, torch.Generator().manual_seed(0), device="cpu",
                      trainable=True)
    router = params.layers[0].moe.router
    assert router.dtype == torch.float32
    before = router.detach().clone()
    tx = default_optimizer(lr=1e-3)
    state = TrainState.create(params, tx)
    step = make_train_step(
        lambda p, b: moe_loss(tc, p, b["tokens"], b["targets"]), tx)
    toks, tgt = _batch(B=2, S=16)
    state, m = step(state, {"tokens": torch.from_numpy(toks).long(),
                            "targets": torch.from_numpy(tgt).long()})
    assert np.isfinite(float(m["loss"]))
    moments = state.opt_state.state
    for p in params.parameters():
        assert moments[p]["exp_avg"].dtype == p.dtype
        assert moments[p]["exp_avg_sq"].dtype == p.dtype
    assert {str(p.dtype).split(".")[1] for p in moments} == want
    assert not torch.equal(router.detach(), before)


def test_moe_params_from_jax_round_trip():
    jc = JaxConfig.tiny(dtype=jnp.bfloat16)
    np_tree = jax.tree.map(np.asarray, jax_moe_init(jc,
                                                    jax.random.PRNGKey(2)))
    tc = MoEConfig.tiny(dtype=torch.bfloat16)
    model = moe_params_from_jax(tc, np_tree, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    for name, p in model.named_parameters():
        want = _leaf(np_tree, name)
        assert p.dtype == (torch.float32 if name.endswith("router")
                           else torch.bfloat16), name
        got = p.detach()
        if p.dtype == torch.bfloat16:  # bit for bit, through the bits
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="layers"):
        moe_params_from_jax(dataclasses.replace(tc, n_layers=3), np_tree,
                            device="cpu")


def test_moe_config_matches_jax():
    for jc, tc in ((JaxConfig.mixtral_8x7b(), MoEConfig.mixtral_8x7b()),
                   (JaxConfig.tiny(), MoEConfig.tiny()),
                   (JaxConfig.mixtral_8x7b(n_layers=4),
                    MoEConfig.mixtral_8x7b(n_layers=4))):
        for f in dataclasses.fields(tc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.param_count() == jc.param_count()
        assert tc.capacity(2048) == jc.capacity(2048)
        jl, tl = jc.as_llama(), tc.as_llama()
        for name in ("d_model", "n_heads", "n_kv_heads", "rope_theta",
                     "max_seq", "norm_eps", "vocab_size"):
            assert getattr(tl, name) == getattr(jl, name), name
    assert MoEConfig.mixtral_8x7b().capacity(2048) == 640
    assert abs(MoEConfig.mixtral_8x7b().param_count() / 46.7e9 - 1) < 0.01


def test_moe_init_distributions_and_device(monkeypatch):
    tc = MoEConfig.tiny(dtype=torch.float32)
    model = moe_init(tc, torch.Generator().manual_seed(0), device="cpu",
                     trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    assert all(p.device.type == "cpu" for p in model.parameters())
    m = model.layers[1].moe
    assert m.w1.shape == (4, 128, 256) and m.w2.shape == (4, 256, 128)
    assert abs(m.w1.std().item() * 128 ** 0.5 - 1) < 0.05
    assert abs(m.w2.std().item() * 256 ** 0.5 - 1) < 0.05
    assert abs(m.router.std().item() * 128 ** 0.5 - 1) < 0.2
    assert abs(model.embed.std().item() - 1) < 0.05
    assert bool((model.layers[0].moe_norm == 1).all())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe_init(tc)
