"""CPU parity of the port's rllib (``ray_tpu_torch.rllib``) with the JAX
package's: envs, the replay ring, GAE, action sampling, the env runners,
the MLP and CNN models, the PPO, DQN, IMPALA, SAC and BC updates, the
multi-agent runner, offline JSONL and the IS/WIS estimators, and the
recompile sentinel.  Inputs are seeded numpy; JAX weights carry across
through the ``*_params_from_jax`` functions; the JAX runners are the actor
classes' bodies (``._cls``), run in process.

Tolerances, and why:
- envs, the replay ring, GAE, the runners' observations, actions and dones,
  and the JSONL files: exact (the same numpy code on the same draws);
- forwards and one update's losses: fp32 (rtol 1e-5, atol 1e-6): the two
  frameworks sum products in another order;
- parameters after several Adam steps: ``ADAM_ATOL + 1e-4 |p|``.  Adam
  divides by sqrt(v): on an element whose gradient is near zero the fp32
  noise of the two gradients moves the step by up to ~lr, more so with
  eps 1e-8 (DQN, SAC, BC) than 1e-5 (PPO, IMPALA), so parameters agree to
  a few lr-sized ulps, not to fp32 precision (as ``test_torch_train``'s
  ``test_train_steps_match_jax``: 2e-5 + 1e-4 |p| at lr 1e-3).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.rllib as jrl
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import env_runner as jer
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import multi_agent as jma
from ray_tpu.rllib import offline as joff
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib.learner import sample_categorical as jax_sample
from ray_tpu_torch.devtools import jitguard
from ray_tpu_torch.rllib import (BC, CNNModel, ContinuousEnvRunner,
                                 DQNLearner, EnvRunner, ImpalaEnvRunner,
                                 ImpalaLearner, JsonReader, JsonWriter,
                                 MLPModel, MultiAgentCartPole,
                                 MultiAgentEnvRunner, PendulumEnv,
                                 PPOLearner, ReplayBuffer, SACLearner,
                                 VectorEnv, cnn_params_from_jax,
                                 collect_offline_dataset, compute_gae,
                                 importance_sampling_estimate,
                                 policy_params_from_jax, q_params_from_jax,
                                 sac_params_from_jax, sample_categorical)
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib.learner import clip_by_global_norm_, to_device

CPU = "cpu"
ADAM_ATOL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _aux(got, want, keys=None, rtol=1e-5, atol=1e-6):
    keys = keys or want.keys()
    assert set(got) == set(want)
    for k in keys:
        _close(got[k], float(want[k]), rtol, atol, msg=k)


def _params(module, port_tree, atol=ADAM_ATOL, rtol=1e-4):
    """``module``'s parameters against the port-layout tree of the JAX
    learner's (``*_params_from_jax`` of it)."""
    want = port_tree.state_dict()
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k].numpy(), rtol, atol, msg=k)


# ------------------------------------------------------------------ envs


def _run_env(env, actions, reset_seed=None):
    out = [env.reset(seed=reset_seed)]
    for a in actions:
        o, r, term, trunc = env.step(a)
        out.append((o, r, term, trunc))
        if term or trunc:
            out.append(env.reset())
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
                assert type(u) is type(v) or isinstance(u, np.ndarray)
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["CartPole-v1", "Catch-v0", "Pendulum"])
def test_env_dynamics_step_for_step(name):
    rng = np.random.default_rng(3)
    if name == "Pendulum":
        make_j, make_t = jsac.PendulumEnv, PendulumEnv
        actions = rng.uniform(-3, 3, (450, 1)).astype(np.float32)
    else:
        make_j = lambda seed: jrl.make_env(name, seed=seed)  # noqa: E731
        make_t = lambda seed: __import__(  # noqa: E731
            "ray_tpu_torch.rllib.env", fromlist=["make_env"]).make_env(
                name, seed=seed)
        n_act = 2 if name == "CartPole-v1" else 3
        actions = rng.integers(0, n_act, 600)
    _same(_run_env(make_j(7), actions, reset_seed=11),
          _run_env(make_t(7), actions, reset_seed=11))


def test_vector_env_episode_semantics():
    """final_obs, terminated vs truncated, auto-reset and
    drain_completed, step for step (env 0 balances under a time limit cut
    to 12 steps, so it is truncated; the others fall)."""
    jv, tv = jrl.VectorEnv("CartPole-v1", 4, seed=2), \
        VectorEnv("CartPole-v1", 4, seed=2)
    jv.envs[0].max_episode_steps = tv.envs[0].max_episode_steps = 12
    np.testing.assert_array_equal(jv.reset(), tv.reset())
    truncated = 0
    for t in range(400):
        # env 0 pushes against the pole's lean, the rest at random
        acts = np.array([int(jv.envs[0].state[2] > 0)]
                        + [(t * 7 + i) % 2 for i in range(1, 4)])
        jo, jr, jte, jtr, jf = jv.step(acts)
        to, tr, tte, ttr, tf = tv.step(acts)
        for a, b in ((jo, to), (jr, tr), (jte, tte), (jtr, ttr)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert jf.keys() == tf.keys()
        for i in jf:
            np.testing.assert_array_equal(jf[i], tf[i])
        truncated += int(jtr.any())
        if t % 100 == 0:
            assert jv.drain_completed() == tv.drain_completed()
    assert truncated >= 1, "no episode reached the time limit"
    assert jv.drain_completed() == tv.drain_completed()


def test_multi_agent_cartpole_step_for_step():
    je, te = jma.MultiAgentCartPole(3, seed=5), MultiAgentCartPole(3, seed=5)
    jo, to = je.reset(seed=1), te.reset(seed=1)
    for t in range(300):
        assert jo.keys() == to.keys()
        for a in jo:
            np.testing.assert_array_equal(jo[a], to[a])
        if not jo:
            jo, to = je.reset(), te.reset()
            continue
        acts = {a: (1 if a == "agent_0" else (t + i) % 2)
                for i, a in enumerate(jo)}
        jo, jr, jt, jtr = je.step(acts)
        to, tr, tt, ttr = te.step(acts)
        assert (jr, jt, jtr) == (tr, tt, ttr)


def test_replay_ring_and_draws():
    jb, tb = jrl.ReplayBuffer(50, 3, seed=4), ReplayBuffer(50, 3, seed=4)
    rng = np.random.default_rng(0)
    for n in (20, 20, 25, 7, 60):
        batch = {"obs": rng.normal(size=(n, 3)).astype(np.float32),
                 "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
                 "actions": rng.integers(0, 2, n).astype(np.int32),
                 "rewards": rng.normal(size=n).astype(np.float32),
                 "dones": (rng.random(n) < 0.1).astype(np.float32)}
        jb.add_batch(batch)
        tb.add_batch(batch)
        assert len(jb) == len(tb) and jb._idx == tb._idx
        js, ts = jb.sample(16), tb.sample(16)
        for k in js:
            np.testing.assert_array_equal(js[k], ts[k])
    for k in ("obs", "next_obs", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(getattr(jb, k), getattr(tb, k))


def test_compute_gae_equal():
    rng = np.random.default_rng(1)
    T, N = 33, 5
    args = (rng.normal(size=(T, N)).astype(np.float32),
            rng.normal(size=(T, N)).astype(np.float32),
            rng.normal(size=(T, N)).astype(np.float32),
            rng.random((T, N)) < 0.1)
    for ja, ta in zip(jrl.compute_gae(*args, 0.99, 0.95),
                      compute_gae(*args, 0.99, 0.95)):
        np.testing.assert_array_equal(ja, ta)


def test_sample_categorical_same_draws():
    logits = np.random.default_rng(2).normal(size=(64, 5)).astype(
        np.float32) * 3
    ja, jl = jax_sample(logits, np.random.default_rng(9))
    ta, tl = sample_categorical(torch.from_numpy(logits),
                                np.random.default_rng(9))
    np.testing.assert_array_equal(ja, ta)
    assert tl.dtype == np.float32
    _close(tl, jl, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- models


@functools.lru_cache(maxsize=None)
def _jax_policy(obs_size=4, n_act=2, hidden=64, seed=0):
    return _np(jrl.init_policy(obs_size, n_act, hidden, seed))


def test_policy_forward_and_init():
    jp = _jax_policy()
    tp = policy_params_from_jax(jp, device=CPU)
    obs = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    jl, jv = jrl.policy_forward(jax.tree.map(jnp.asarray, jp), obs)
    with torch.no_grad():
        tl, tv = MLPModel((4,), 2).apply(tp, torch.from_numpy(obs))
    _close(tl, jl)
    _close(tv, jv)
    # The port's init: orthogonal with the JAX package's gains.
    mine = MLPModel((4,), 2).init(0, device=CPU)
    w = mine.pi[1].weight.detach()
    _close((w @ w.T).numpy(), 2.0 * np.eye(64), atol=1e-4)
    _close(float(mine.pi[2].weight.detach().norm(dim=1).max()), 0.01,
           rtol=1e-4)
    assert not any(b.any() for n, b in mine.named_parameters()
                   if n.endswith("bias"))
    again = MLPModel((4,), 2).init(0, device=CPU)
    assert all(torch.equal(a, b) for a, b in
               zip(mine.parameters(), again.parameters()))


NATURE = dict(channels=(32, 64, 64), kernels=(8, 4, 3), strides=(4, 2, 1),
              dense=512)


@pytest.mark.parametrize("shape,kw", [
    ((84, 84, 4), NATURE),                      # 7 x 7 map, dense 512
    ((10, 5, 1), {}),                           # Catch, the default stack
    ((12, 9), dict(channels=(8, 4), kernels=(3, 2), strides=(2, 1),
                   dense=6)),                   # 2-D obs, odd sizes
])
def test_cnn_forward_matches_jax(shape, kw):
    """NHWC/HWIO against NCHW/OIHW: a flatten in the wrong order scrambles
    the dense layer's features whenever the map is larger than 1 x 1."""
    jm = jrl.CNNModel(shape, 6, **kw)
    tm = CNNModel(shape, 6, **kw)
    h, w = tm._conv_out_hw()
    assert h * w > 1 and tm.dense > 1
    # Random weights of the JAX init's shapes (its own init compiles op by
    # op eagerly, seconds a shape), scaled as he_normal scales them.
    rng = np.random.default_rng(3)
    jp = {k: (rng.normal(size=v.shape) * np.sqrt(2 / np.prod(v.shape[:-1]))
              + (0.1 if k.endswith("_b") else 0.0)).astype(np.float32)
          for k, v in jax.eval_shape(jm.init, 3).items()}
    tp = cnn_params_from_jax(tm, jp, device=CPU)
    n = 3
    obs = np.random.default_rng(1).random((n, *shape)).astype(np.float32)
    jl, jv = jm.apply(jax.tree.map(jnp.asarray, jp), obs)
    with torch.no_grad():
        tl, tv = tm.apply(tp, torch.from_numpy(obs))
    _close(tl, jl, rtol=1e-4, atol=1e-5)
    _close(tv, jv, rtol=1e-4, atol=1e-5)
    # The port's own init builds the same shapes.
    mine = tm.init(0, device=CPU)
    assert {k: v.shape for k, v in mine.state_dict().items()} == \
        {k: v.shape for k, v in tp.state_dict().items()}


def test_nature_conv_sizes():
    """_conv_out_hw's ceil((h - k + 1) / s) is torch's VALID size
    floor((h - k) / s) + 1 layer by layer: 84 -> 20 -> 9 -> 7."""
    m = CNNModel((84, 84, 4), 6, **NATURE)
    params = m.init(0, device=CPU)
    x = torch.zeros(1, 4, 84, 84)
    sizes = []
    with torch.no_grad():
        for conv in params.conv:
            x = conv(x)
            sizes.append(x.shape[-1])
    assert sizes == [20, 9, 7] and m._conv_out_hw() == (7, 7)
    assert sum(p.numel() for p in params.parameters()) == 1_687_719


# ----------------------------------------------------------------- runners


def _jax_runner(cls, *args, **kw):
    return cls._cls(*args, **kw)


def test_env_runner_sample_matches_jax():
    jp = _jax_policy()
    jr = _jax_runner(jer.EnvRunner, "CartPole-v1", 8, seed=0)
    tr = EnvRunner("CartPole-v1", 8, seed=0, device=CPU)
    jr.set_weights(jp)
    tr.set_weights(jp)
    js, ts = jr.sample(64), tr.sample(64)
    for k in ("obs", "actions", "rewards", "dones", "episode_returns"):
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    assert js["dones"].any()
    for k in ("logp_old", "values", "bootstrap_values"):
        assert ts[k].dtype == js[k].dtype
        _close(ts[k], js[k], msg=k)
    # Terminal rows bootstrap exactly 0 in both.
    np.testing.assert_array_equal(js["bootstrap_values"] == 0,
                                  ts["bootstrap_values"] == 0)
    assert tr.env_info() == jr.env_info()
    # The port's own weights (a state dict) work too.
    learner = PPOLearner(4, 2, device=CPU)
    learner.set_weights(jp)
    tr2 = EnvRunner("CartPole-v1", 8, seed=0, device=CPU)
    tr2.set_weights(learner.get_weights())
    np.testing.assert_array_equal(tr2.sample(16)["actions"],
                                  js["actions"][:16])


def test_env_runner_cnn_sample_matches_jax():
    """A CNN policy on Catch's (10, 5, 1) images."""
    jm, tm = jrl.CNNModel((10, 5, 1), 3), CNNModel((10, 5, 1), 3)
    jp = _np(jm.init(1))
    jr = _jax_runner(jer.EnvRunner, "Catch-v0", 4, seed=2, model=jm)
    tr = EnvRunner("Catch-v0", 4, seed=2, model=tm, device=CPU)
    jr.set_weights(jp)
    tr.set_weights(jp)
    js, ts = jr.sample(24), tr.sample(24)
    for k in ("obs", "actions", "rewards", "dones"):
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    for k in ("logp_old", "values", "bootstrap_values"):
        _close(ts[k], js[k], rtol=1e-5, atol=1e-5, msg=k)


def test_sample_transitions_matches_jax():
    jq = _np(jdqn.init_q(4, 2, 64, seed=1))
    jr = _jax_runner(jer.EnvRunner, "CartPole-v1", 4, seed=3)
    tr = EnvRunner("CartPole-v1", 4, seed=3, device=CPU)
    jr.set_q_weights(list(jq))
    tr.set_q_weights(list(jq))
    for eps in (0.3, 0.0):
        js, ts = jr.sample_transitions(40, eps), tr.sample_transitions(40,
                                                                       eps)
        for k in js:
            np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    learner = DQNLearner(4, 2, lr=5e-4, gamma=0.99, grad_clip=10.0,
                         hidden=64, seed=0, device=CPU)
    tr.set_q_weights(learner.get_weights())
    assert tr.sample_transitions(4, 0.0)["actions"].shape == (16,)


def test_impala_runner_matches_jax():
    jp = _jax_policy()
    jr = _jax_runner(jimpala.ImpalaEnvRunner, "CartPole-v1", 4, seed=1)
    tr = ImpalaEnvRunner("CartPole-v1", 4, seed=1, device=CPU)
    jr.set_weights(list(jp), 3)
    tr.set_weights(list(jp), 3)
    js, ts = jr.sample(50), tr.sample(50)
    for k in js:
        if k == "logp_behavior":
            _close(ts[k], js[k], msg=k)
        else:
            np.testing.assert_array_equal(js[k], ts[k], err_msg=k)


def test_continuous_runner_matches_jax():
    jl = jsac.SACLearner(3, 1, action_low=-2.0, action_high=2.0, hidden=32,
                         seed=0)
    kw = dict(action_size=1, scale=2.0, bias=0.0, seed=4)
    jr = _jax_runner(jsac.ContinuousEnvRunner, jsac.PendulumEnv, 3, **kw)
    tr = ContinuousEnvRunner(PendulumEnv, 3, device=CPU, **kw)
    for rand in (True, False):
        if not rand:
            jr.set_actor_weights(jl.get_actor_weights())
            tr.set_actor_weights(jl.get_actor_weights())
        js, ts = jr.sample_transitions(30, random_actions=rand), \
            tr.sample_transitions(30, random_actions=rand)
        for k in js:
            # Actions pass through tanh on each side: fp32 close, and
            # the states they drive stay close.
            _close(ts[k], js[k], rtol=1e-5, atol=1e-5, msg=k)


def test_multi_agent_runner_rows_match_jax():
    mapping = {"agent_0": "p0", "agent_1": "p1", "agent_2": "p1"}
    jmodels = {p: jrl.MLPModel((4,), 2) for p in ("p0", "p1")}
    tmodels = {p: MLPModel((4,), 2) for p in ("p0", "p1")}
    weights = {"p0": _jax_policy(seed=0), "p1": _jax_policy(seed=1)}
    kw = dict(gamma=0.99, lambda_=0.95, seed=2,
              env_kwargs={"num_agents": 3})
    jr = _jax_runner(jma.MultiAgentEnvRunner, "MultiAgentCartPole", mapping,
                     jmodels, **kw)
    tr = MultiAgentEnvRunner("MultiAgentCartPole", mapping, tmodels,
                             device=CPU, **kw)
    jr.set_weights(weights)
    tr.set_weights(weights)
    assert jr.env_info() == tr.env_info()
    for _ in range(2):
        js, ts = jr.sample(120), tr.sample(120)
        assert js.keys() == ts.keys() == {"p0", "p1", "__metrics__"}
        np.testing.assert_array_equal(js["__metrics__"]["episode_returns"],
                                      ts["__metrics__"]["episode_returns"])
        for pid in ("p0", "p1"):
            for k in ("obs", "actions"):
                np.testing.assert_array_equal(js[pid][k], ts[pid][k])
            for k in ("logp_old", "advantages", "returns"):
                _close(ts[pid][k], js[pid][k], rtol=1e-5, atol=1e-5,
                       msg=f"{pid}.{k}")


# ---------------------------------------------------------------- learners


def _ppo_batch(n_envs=8, steps=32, seed=0):
    """A CartPole rollout's rows (JAX runner), with logp_old pushed off the
    policy's by +-0.4 so the ratio leaves [1 - clip, 1 + clip] (the clip
    branch) on every row."""
    jr = _jax_runner(jer.EnvRunner, "CartPole-v1", n_envs, seed=seed)
    jr.set_weights(_jax_policy())
    s = jr.sample(steps)
    adv, ret = jrl.compute_gae(s["rewards"], s["values"],
                               s["bootstrap_values"], s["dones"], 0.99, 0.95)
    n = steps * n_envs
    shift = np.where(np.random.default_rng(seed).random(n) < 0.5, 0.4, -0.4)
    return {"obs": s["obs"].reshape(n, 4),
            "actions": s["actions"].reshape(-1),
            "logp_old": (s["logp_old"].reshape(-1)
                         + shift).astype(np.float32),
            "advantages": adv.reshape(-1), "returns": ret.reshape(-1)}


def test_ppo_update_matches_jax():
    """Two epochs of four minibatches (8 steps, JAX's minibatch order, the
    ragged tail dropped); PPO's grad_clip 0.5 clips every step."""
    batch = _ppo_batch()
    jl = jrl.PPOLearner(4, 2, seed=0)
    tl = PPOLearner(4, 2, seed=5, device=CPU)
    tl.set_weights(_np(jl.params))
    kw = dict(num_epochs=2, minibatch_size=60, seed=3)
    jm = jl.update_from_batch(batch, **kw)
    tm = tl.update_from_batch(batch, **kw)
    _aux(tm, jm, rtol=1e-4, atol=1e-6)
    _params(tl.params, policy_params_from_jax(_np(jl.params), CPU))
    assert tl.last_copy["bytes"] == sum(v.nbytes for v in batch.values())


def test_ppo_cnn_update_matches_jax():
    """The conv policy's backward: PPO on Catch images, 3 steps."""
    rng = np.random.default_rng(4)
    n = 48
    batch = {"obs": (rng.random((n, 10, 5, 1)) < 0.2).astype(np.float32),
             "actions": rng.integers(0, 3, n).astype(np.int32),
             "logp_old": np.full(n, np.log(1 / 3), np.float32)
             + rng.normal(0, 0.3, n).astype(np.float32),
             "advantages": rng.normal(size=n).astype(np.float32),
             "returns": rng.normal(size=n).astype(np.float32)}
    jm, tm = jrl.CNNModel((10, 5, 1), 3), CNNModel((10, 5, 1), 3)
    jl = jrl.PPOLearner(50, 3, seed=0, model=jm)
    tl = PPOLearner(50, 3, seed=0, model=tm, device=CPU)
    tl.set_weights(_np(jl.params))
    kw = dict(num_epochs=1, minibatch_size=16, seed=1)
    _aux(tl.update_from_batch(batch, **kw), jl.update_from_batch(batch, **kw),
         rtol=1e-4, atol=1e-6)
    _params(tl.params, cnn_params_from_jax(tm, _np(jl.params), CPU))


def test_clip_by_global_norm_is_optax():
    import optax

    rng = np.random.default_rng(0)
    gs = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in gs)))
    for max_norm in (norm * 2, norm / 3):   # below, then above the norm
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in gs], None)
        got = [torch.from_numpy(g.copy()) for g in gs]
        n = clip_by_global_norm_(got, max_norm)
        _close(float(n), norm, rtol=1e-6)
        for a, b in zip(got, want):
            _close(a.numpy(), b, rtol=1e-6, atol=0)


def test_set_grads_matches_parameter_strides():
    """A channels-last gradient (cuDNN's for a channels-last input) goes to
    the optimizer in its parameter's strides, values unchanged; the fused
    Adam steps only tensors of one layout."""
    from ray_tpu_torch.rllib.learner import set_grads

    w = torch.nn.Parameter(torch.randn(8, 4, 3, 3))
    b = torch.nn.Parameter(torch.randn(8))
    g = torch.randn(8, 4, 3, 3).contiguous(memory_format=torch.channels_last)
    assert g.stride() != w.stride()
    set_grads([w, b], [g, None])
    assert w.grad.stride() == w.stride() and torch.equal(w.grad, g)
    assert b.grad is None
    torch.optim.Adam([w, b], fused=True).step()


def _dqn_batch(rng, n=64):
    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": rng.normal(size=n).astype(np.float32) * 3,
            "dones": (rng.random(n) < 0.2).astype(np.float32)}


def test_dqn_updates_match_jax():
    kw = dict(lr=5e-4, gamma=0.99, grad_clip=10.0, hidden=64, seed=0)
    jl = jdqn.DQNLearner(4, 2, **kw)
    tl = DQNLearner(4, 2, device=CPU, **kw)
    q0 = q_params_from_jax(_np(jl.params), CPU).state_dict()
    tl.params.load_state_dict(q0)
    tl.target_params.load_state_dict(q0)
    rng = np.random.default_rng(0)
    for i in range(4):
        b = _dqn_batch(rng)
        if i == 1:
            # A tied online argmax: the first maximum, both ways.
            b["next_obs"][:4] = 0.0
        _aux(tl.update_from_batch(b), jl.update_from_batch(b), rtol=1e-4,
             atol=1e-6)
        if i == 2:
            jl.sync_target()
            tl.sync_target()
    _params(tl.params, q_params_from_jax(_np(jl.params), CPU))
    _params(tl.target_params, q_params_from_jax(_np(jl.target_params), CPU))


def _impala_fragments(seed=0):
    frags = []
    for i in range(2):
        jr = _jax_runner(jimpala.ImpalaEnvRunner, "CartPole-v1", 4,
                         seed=seed + i)
        jr.set_weights(list(_jax_policy(seed=9)), 0)
        frags.append(jr.sample(40))
    return frags


def test_impala_updates_match_jax():
    """Off-policy (the behavior policy's weights differ from the
    learner's), so rho and c clip; three steps."""
    jl = jimpala.ImpalaLearner(4, 2, seed=0)
    tl = ImpalaLearner(4, 2, seed=0, device=CPU)
    tl.params.load_state_dict(
        policy_params_from_jax(_np(jl.params), CPU).state_dict())
    for step in range(3):
        frags = _impala_fragments(seed=10 * step)
        jm, tm = jl.update_from_fragments(frags), \
            tl.update_from_fragments(frags)
        _aux(tm, jm, rtol=1e-4, atol=1e-6)
        assert jm["mean_rho"] < 1.0
    _params(tl.params, policy_params_from_jax(_np(jl.params), CPU))


def test_vtrace_reduces_to_gae_lambda1_on_policy():
    """With pi == mu (all rhos 1) V-trace targets equal the lambda=1
    n-step returns — the on-policy sanity check from Espeholt et al. §4.1
    (the JAX package's test of the same name), through the port's
    reverse loop; and the loop equals the JAX package's reverse scan."""
    T, N = 5, 3
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    next_values = np.concatenate([values[1:], rng.normal(
        size=(1, N)).astype(np.float32)])
    gamma = 0.9
    deltas = rewards + gamma * next_values - values
    vs = values + timpala.vtrace(torch.from_numpy(deltas),
                                 torch.full((T, N), gamma)).numpy()
    expect = np.zeros((T, N), np.float32)
    acc = next_values[-1]
    for t in range(T - 1, -1, -1):
        acc = rewards[t] + gamma * acc
        expect[t] = acc
    np.testing.assert_allclose(vs, expect, rtol=1e-5)
    disc = rng.random((T, N)).astype(np.float32)

    def step(carry, x):
        carry = x[0] + x[1] * carry
        return carry, carry

    _, want = jax.lax.scan(step, jnp.zeros((N,)), (jnp.asarray(deltas),
                                                   jnp.asarray(disc)),
                           reverse=True)
    _close(timpala.vtrace(torch.from_numpy(deltas),
                          torch.from_numpy(disc)).numpy(), want)


def _sac_batch(rng, n=64):
    """Observations of scale 0.3 keep tanh(mu + std eps) off its
    saturation.  There the JAX package's log(1 - a^2 + 1e-6), from a =
    tanh(pre) rounded to fp32, keeps little but a's rounding (XLA's tanh
    against the port's accurate sech^2, ``sac._sech2``): unit-scale
    observations move the critic loss by 1.5 % between the packages, and
    by 0.35 % between JAX's own jitted and eager evaluations of the same
    update."""
    return {"obs": (0.3 * rng.normal(size=(n, 3))).astype(np.float32),
            "next_obs": (0.3 * rng.normal(size=(n, 3))).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32)}


def test_sech2_is_one_minus_tanh_squared():
    from ray_tpu_torch.rllib.sac import _sech2

    x = torch.linspace(-60, 60, 2401, dtype=torch.float64)
    want = 1 / torch.cosh(x) ** 2
    _close(_sech2(x).numpy(), want.numpy(), rtol=1e-12, atol=1e-300)
    x32 = torch.linspace(-3, 3, 601)
    _close(_sech2(x32).numpy(), (1 - torch.tanh(x32) ** 2).numpy(),
           rtol=1e-5, atol=1e-6)
    # Saturated: the correction is log(1e-6), as JAX's 1 - 1^2 gives.
    sat = torch.log(_sech2(torch.tensor([20.0, -50.0])) + 1e-6)
    assert torch.equal(sat, torch.log(torch.full((2,), 1e-6)))


def test_sac_updates_match_jax():
    """Three updates with JAX's noise (its key split as its update splits
    it) handed to the port's update; every net, the targets and alpha."""
    kw = dict(action_low=-2.0, action_high=2.0, hidden=32, seed=0)
    jl = jsac.SACLearner(3, 1, **kw)
    tl = SACLearner(3, 1, device=CPU, **kw)
    tl.params.load_state_dict(sac_params_from_jax(_np(jl.params),
                                                  CPU).state_dict())
    rng = np.random.default_rng(0)
    for _ in range(3):
        b = _sac_batch(rng)
        key = jl._rng_key
        jm = jl.update_from_batch(b)
        _, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        eps = [torch.from_numpy(np.array(jax.random.normal(k, (64, 1))))
               for k in (k1, k2)]
        tm = tl._update(to_device(b, tl.device), *eps)
        _aux({k: float(v) for k, v in tm.items()}, jm, rtol=1e-4, atol=1e-6)
    _params(tl.params, sac_params_from_jax(_np(jl.params), CPU))
    obs = rng.normal(size=(8, 3)).astype(np.float32)
    _close(tl.act(obs, deterministic=True),
           jl.act(obs, deterministic=True), rtol=1e-5, atol=1e-6)
    acts = tl.act(obs)
    assert acts.shape == (8, 1) and np.all(np.abs(acts) <= 2.0)
    m = tl.update_from_batch(_sac_batch(rng))
    assert np.isfinite(m["critic_loss"]) and m["alpha"] > 0


def test_bc_matches_jax_and_jsonl_crosses(tmp_path):
    """collect_offline_dataset writes the same bytes in both packages;
    each package reads the other's file; BC's updates on it agree."""
    def behavior(obs):
        return (1 if obs[2] > 0 else 0), 1.0

    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    kw = dict(num_episodes=12, policy=behavior, seed=3, epsilon=0.25)
    assert joff.collect_offline_dataset("CartPole-v1", jpath, **kw) == \
        collect_offline_dataset("CartPole-v1", tpath, **kw)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    jt, tt = joff.JsonReader(tpath).read_all(), JsonReader(jpath).read_all()
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(jt[k], tt[k])
    jr, tr = joff.JsonReader(jpath, seed=5), JsonReader(jpath, seed=5)
    for _ in range(4):
        jb, tb = jr.next(), tr.next()
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])

    jbc = joff.BC((4,), 2, lr=1e-2, seed=0)
    tbc = BC((4,), 2, lr=1e-2, seed=1, device=CPU)
    tbc.params.load_state_dict(
        policy_params_from_jax(_np(jbc.params), CPU).state_dict())
    jloss = jbc.train_on(joff.JsonReader(jpath), num_steps=4, batch_size=64)
    tloss = tbc.train_on(JsonReader(jpath), num_steps=4, batch_size=64)
    _close(tloss, jloss, rtol=1e-4)
    _params(tbc.params, policy_params_from_jax(_np(jbc.params), CPU),
            atol=4 * 1e-2)
    probe = np.array([0.0, 0.0, 0.1, 0.0], np.float32)
    assert tbc.compute_action(probe) == jbc.compute_action(probe)


def test_jsonl_writer_reader_roundtrip(tmp_path):
    path = str(tmp_path / "w.jsonl")
    batch = {"obs": np.arange(6, dtype=np.float32).reshape(3, 2),
             "actions": np.array([0, 1, 1]), "dones": np.array([0, 0, 1],
                                                              np.bool_)}
    w = JsonWriter(path)
    w.write(batch)
    w.close()
    jw = joff.JsonWriter(path)
    jw.write(batch)
    jw.close()
    lines = open(path).read().splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]
    assert json.loads(lines[0])["obs"] == [[0.0, 1.0], [2.0, 3.0],
                                           [4.0, 5.0]]
    assert len(list(JsonReader(path))) == 2


def test_importance_sampling_estimates_match_jax(tmp_path):
    path = str(tmp_path / "uniform.jsonl")
    collect_offline_dataset("CartPole-v1", path, num_episodes=15, seed=1)

    def target(obs, acts):
        return np.where(acts == (obs[:, 2] > 0), 0.9, 0.1)

    for weighted in (False, True):
        want = joff.importance_sampling_estimate(
            joff.JsonReader(path), target, gamma=0.97, weighted=weighted)
        got = importance_sampling_estimate(JsonReader(path), target,
                                           gamma=0.97, weighted=weighted)
        assert got == want


# ---------------------------------------------------- sentinel and device


def test_recompile_sentinel_raises_on_drifted_minibatch():
    jitguard.reset_sentinel_state()
    try:
        learner = PPOLearner(4, 2, device=CPU)
        batch = {k: v[:64] for k, v in _ppo_batch(steps=8).items()}
        learner.update_from_batch(batch, num_epochs=2, minibatch_size=32)
        assert jitguard.count("ppo_update") == 1  # one signature, 4 steps
        assert jitguard.arm(force=True)
        learner.update_from_batch(batch, num_epochs=1, minibatch_size=32)
        with pytest.raises(jitguard.RecompileError, match="ppo_update"):
            learner.update_from_batch(batch, num_epochs=1,
                                      minibatch_size=16)
        # A new learner is a legitimate compile phase (re-registered).
        dqn = DQNLearner(4, 2, lr=1e-3, gamma=0.9, grad_clip=1.0, hidden=8,
                         seed=0, device=CPU)
        assert jitguard.arm(force=True)
        with pytest.raises(jitguard.RecompileError, match="dqn_update"):
            dqn.update_from_batch(_dqn_batch(np.random.default_rng(0), 8))
    finally:
        jitguard.disarm()
        jitguard.reset_sentinel_state()


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: PPOLearner(4, 2),
                 lambda: DQNLearner(4, 2, lr=1e-3, gamma=0.9, grad_clip=1.0,
                                    hidden=8, seed=0),
                 lambda: ImpalaLearner(4, 2),
                 lambda: SACLearner(3, 1, action_low=-2.0,
                                    action_high=2.0),
                 lambda: BC((4,), 2),
                 lambda: EnvRunner("CartPole-v1", 2),
                 lambda: ImpalaEnvRunner("CartPole-v1", 2),
                 lambda: ContinuousEnvRunner(PendulumEnv, 2, action_size=1,
                                             scale=2.0, bias=0.0),
                 lambda: MultiAgentEnvRunner("MultiAgentCartPole",
                                             {"agent_0": "p",
                                              "agent_1": "p"},
                                             {"p": MLPModel((4,), 2)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_chip_smoke_rllib_phase_runs_on_cpu(monkeypatch):
    """``chip_smoke.phase_rllib`` drives every piece but its two-rank mesh
    check on the CPU (``dev="cpu"``), with the card's tools stubbed and the
    Atari batch cut from 1,024 to 256 frames: every card-vs-CPU gate holds
    (both sides on the CPU) and the csrc kernels launch none."""
    import time

    import chip_smoke as cs

    def profile(torch, fn, iters=10):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        wall = (time.perf_counter() - t0) * 1e3 / iters
        return {"kernel": wall / 2, "Memcpy HtoD": wall / 4}, wall

    monkeypatch.setattr(cs, "profile_window", profile)
    timed = lambda torch, fn, **kw: (fn(), 1.0)[1]  # noqa: E731
    monkeypatch.setattr(cs, "time_ms", timed)
    monkeypatch.setattr(cs, "device_ms", timed)
    monkeypatch.setattr(cs, "card_line", lambda: "cpu")
    monkeypatch.setattr(cs, "RL_ATARI", dict(cs.RL_ATARI, batch=256,
                                              minibatch=128))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    report = {}
    cs.phase_rllib(torch, report, 0, dev="cpu")
    rl = report["rllib"]
    assert not any(rl["launches"].values())
    for name in ("atari", "dqn", "impala", "sac", "bc"):
        assert rl[name]["gate"]["loss_ratio"] == 0.0, name
    assert rl["ppo_cartpole"]["gate"]["param_ratio"] == 0.0
    assert len(rl["ppo_cartpole"]["iterations"]) == cs.RL_ITERS + 1
    assert "mesh" not in rl
