"""CPU parity of the port's MNIST MLP with the JAX package: ``mlp_apply``,
``mlp_loss`` and its gradients, AdamW steps, convergence and
initialisation.  Both packages get the same numpy weights
(``mlp_params_from_jax``) and inputs, in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import MLPConfig as JaxConfig
from ray_tpu.models import TrainState as JaxTrainState
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models import mlp_apply as jax_mlp_apply
from ray_tpu.models import mlp_init as jax_mlp_init
from ray_tpu.models.mlp import mlp_loss as jax_mlp_loss
from ray_tpu.models.train_state import default_optimizer as jax_optimizer
from ray_tpu_torch.models import (MLPConfig, TrainState, default_optimizer,
                                  make_train_step, mlp_apply, mlp_init,
                                  mlp_loss, mlp_params_from_jax)

_SMALL = dict(in_dim=16, hidden=32, out_dim=4)


def _data(n=256, seed=1):
    """The JAX package's convergence task: four classes from two signs."""
    x = np.random.default_rng(seed).standard_normal((n, 16)).astype(
        np.float32)
    y = ((x.sum(1) > 0).astype(np.int32) + 2 * (x[:, 0] > 0)).astype(
        np.int32)
    return x, y


def _pair(seed=0, **kw):
    jc, tc = JaxConfig(**_SMALL, **kw), MLPConfig(**_SMALL, **kw)
    jp = jax_mlp_init(jc, jax.random.PRNGKey(seed))
    return jc, jp, tc, jax.tree.map(np.asarray, jp)


def _assert_tree(model, tree, attr, atol, rtol):
    for i, layer in enumerate(model.layers):
        for key in ("w", "b"):
            got = getattr(getattr(layer, key), attr) if attr else \
                getattr(layer, key)
            np.testing.assert_allclose(
                got.detach().numpy(), np.asarray(tree["layers"][i][key]),
                atol=atol, rtol=rtol, err_msg=f"layers.{i}.{key}")


@pytest.mark.parametrize("n_hidden", [0, 2])
def test_mlp_apply_loss_and_grads_match_jax(n_hidden):
    jc, jp, tc, np_tree = _pair(n_hidden=n_hidden)
    x, y = _data(n=64)
    want_logits = jax_mlp_apply(jc, jp, jnp.asarray(x))
    want, jgrads = jax.value_and_grad(
        lambda p: jax_mlp_loss(jc, p, jnp.asarray(x), jnp.asarray(y)))(jp)
    tp = mlp_params_from_jax(tc, np_tree, device="cpu", trainable=True)
    assert len(tp.layers) == n_hidden + 1
    with torch.no_grad():
        logits = mlp_apply(tc, tp, torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (64, 4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-5, rtol=1e-5)
    loss = mlp_loss(tc, tp, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _assert_tree(tp, jgrads, "grad", atol=1e-6, rtol=1e-4)


def test_mlp_train_steps_match_jax():
    jc, jp, tc, np_tree = _pair()
    x, y = _data()
    jtx, ttx = jax_optimizer(lr=1e-2), default_optimizer(lr=1e-2)
    j_step = jax_make_train_step(
        lambda p, b: jax_mlp_loss(jc, p, b["x"], b["y"]), jtx)
    t_step = make_train_step(
        lambda p, b: mlp_loss(tc, p, b["x"], b["y"]), ttx)
    j_state = JaxTrainState.create(jp, jtx)
    t_state = TrainState.create(
        mlp_params_from_jax(tc, np_tree, device="cpu", trainable=True), ttx)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    for _ in range(3):
        j_state, jm = j_step(j_state, jb)
        t_state, tm = t_step(t_state, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    # Adam: as in test_torch_train, parameters agree to a few lr-sized ulps.
    _assert_tree(t_state.params, j_state.params, None, atol=1e-4, rtol=1e-4)


def test_mlp_converges():
    """The JAX package's convergence test (tests/test_models.py), run on
    the port: 60 AdamW steps at lr 1e-2 bring the loss below 0.5."""
    tc = MLPConfig(**_SMALL)
    params = mlp_init(tc, torch.Generator().manual_seed(0), device="cpu",
                      trainable=True)
    x, y = _data()
    tx = default_optimizer(lr=1e-2)
    state = TrainState.create(params, tx)
    step = make_train_step(lambda p, b: mlp_loss(tc, p, b["x"], b["y"]), tx)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    for _ in range(60):
        state, m = step(state, batch)
    assert float(m["loss"]) < 0.5


def test_mlp_init_distributions_and_device(monkeypatch):
    tc = MLPConfig()
    model = mlp_init(tc, torch.Generator().manual_seed(0), device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    shapes = [tuple(layer.w.shape) for layer in model.layers]
    assert shapes == [(784, 256), (256, 256), (256, 10)]
    for layer in model.layers:
        fan_in = layer.w.shape[0]
        assert abs(layer.w.std().item() * (fan_in / 2) ** 0.5 - 1) < 0.1
        assert not layer.b.any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mlp_init(tc)
