"""The port's rllib algorithm drivers against the JAX package's: PPO, DQN,
IMPALA, SAC and MultiAgentPPO, each for two iterations with two runner
actors, on each package's cluster at once
(``_torch_train_scenarios.rllib_algos``).  The port's learners run on the
CPU (``device="cpu"``) from the JAX learners' initial weights (the JAX
process writes them as numpy, the port's config takes them as
``initial_weights``).

Equal: env steps, the episode returns' mean, iteration and update counts.
Within 1e-5 + 1e-4 |x| (fp32 summation order in the two frameworks, over
at most 40 Adam steps): the learners' losses.  SAC's learner draws its
noise from ``jax.random`` (``ray_tpu/rllib/sac.py:176, :274``) and the
port's from a torch generator, so for SAC only what those draws do not
touch is compared: env steps, the replay size, the iteration count and
the metric keys."""

import numpy as np
import pytest

import _torch_train_scenarios as sc
from ray_tpu_torch import rllib

ATOL, RTOL = 1e-5, 1e-4

_results = {}

#: Per driver: the keys compared exactly, and the losses compared within
#: the tolerance.
_EXACT = ("training_iteration", "num_env_steps_sampled",
          "num_env_steps_sampled_lifetime", "episode_return_mean")
_KEYS = {
    "ppo": (_EXACT, ("policy_loss", "vf_loss", "entropy", "total_loss")),
    "dqn": (_EXACT + ("num_gradient_updates_lifetime", "epsilon"),
            ("loss", "td_error_mean", "qf_mean")),
    "impala": (_EXACT + ("num_learner_updates_lifetime",
                         "mean_weight_staleness"),
               ("policy_loss", "vf_loss", "entropy", "total_loss",
                "mean_rho")),
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    if "algos" not in _results:
        try:
            ref, got = sc.run_pair(
                ["rllib_algos"],
                env={"RT_RL_WEIGHTS_DIR":
                     str(tmp_path_factory.mktemp("rl_weights"))},
                port_env={"RT_GPUS": "1"})
            _results["algos"] = (ref["rllib_algos"], got["rllib_algos"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["algos"] = e
    if isinstance(_results["algos"], Exception):
        raise _results["algos"]
    return _results["algos"]


@pytest.mark.parametrize("algo", ["ppo", "dqn", "impala"])
def test_driver_matches_jax(pair, algo):
    ref, got = pair
    exact, close = _KEYS[algo]
    assert len(got[algo]) == len(ref[algo]) == 2
    for i, (g, r) in enumerate(zip(got[algo], ref[algo])):
        assert g["training_iteration"] == i + 1
        assert {k: g[k] for k in exact} == {k: r[k] for k in exact}
        np.testing.assert_allclose([g[k] for k in close],
                                   [r[k] for k in close],
                                   atol=ATOL, rtol=RTOL, err_msg=algo)


def test_multi_agent_ppo_matches_jax(pair):
    ref, got = pair
    for g, r in zip(got["multi_agent"], ref["multi_agent"]):
        assert {k: g[k] for k in _EXACT} == {k: r[k] for k in _EXACT}
        assert sorted(g["policies"]) == sorted(r["policies"]) == ["p0", "p1"]
        for pid in ("p0", "p1"):
            keys = sorted(r["policies"][pid])
            assert sorted(g["policies"][pid]) == keys
            np.testing.assert_allclose(
                [g["policies"][pid][k] for k in keys],
                [r["policies"][pid][k] for k in keys],
                atol=ATOL, rtol=RTOL, err_msg=pid)


def test_sac_matches_jax_where_the_noise_does_not_reach(pair):
    """Env steps, the replay size, the iterations and the metric keys (the
    learner ran in the second iteration: its losses are among the keys)."""
    ref, got = pair
    assert got["sac"] == ref["sac"]
    assert got["sac"][1]["replay"] == 1024
    assert "critic_loss" in got["sac"][1]["keys"]


def test_runner_actors_hold_no_card(pair):
    """With one mocked card the runner actors are granted none: it stays
    free while they live (a runner granted no card sees an empty
    ``CUDA_VISIBLE_DEVICES``, so the drivers build it with
    ``device="cpu"``)."""
    _, got = pair
    assert got["gpus"] == 1.0
    assert got["ppo_card_free"] == 1.0


@pytest.mark.parametrize("name", ["PPO", "DQN"])
def test_as_trainable_is_refused_until_tune(name):
    """``tune`` is ported, so the refusal is gone: ``as_trainable`` gives
    a function trainable, as the JAX drivers' does, that reports each
    iteration through ``ray_tpu_torch.tune`` (one PPO trial runs under
    both packages in ``tests/test_torch_data_train.py``)."""
    from ray_tpu import rllib as jrllib

    cls = getattr(rllib, name)
    cfg = getattr(rllib, name + "Config")()
    fn = cls.as_trainable(cfg, stop_iters=2)
    jfn = getattr(jrllib, name).as_trainable(
        getattr(jrllib, name + "Config")(), stop_iters=2)
    assert callable(fn)
    assert fn.__qualname__ == jfn.__qualname__ == (
        f"{name}.as_trainable.<locals>.trainable")
    assert "ray_tpu_torch" in fn.__code__.co_names


def test_configs_take_a_device_and_initial_weights():
    """Every driver's config carries the learner's device and its starting
    weights (the port's way to load a learner before the runners first
    sample)."""
    for cfg in (rllib.PPOConfig(), rllib.DQNConfig(), rllib.ImpalaConfig(),
                rllib.SACConfig(), rllib.MultiAgentPPOConfig()):
        assert cfg.device is None and cfg.initial_weights is None
    cfg = rllib.PPOConfig().training(device="cpu", initial_weights={"a": 1})
    assert (cfg.device, cfg.initial_weights) == ("cpu", {"a": 1})
