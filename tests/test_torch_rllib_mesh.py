"""CPU parity of the rllib learners' ``mesh=`` path (PPO, DQN, IMPALA)
with the one-process update and with the JAX package's sharded update.

Two spawned gloo ranks (``_torch_ranks.rllib_mesh``, one spawn for every
case) each take their rows of every minibatch (PPO, DQN) or their env
columns (IMPALA) and average the gradients over dp x fsdp before the clip;
the JAX side shards the same batch over a dp 2 mesh of two virtual CPU
devices, where XLA inserts the gradient psum.  fp32; the metrics are means
of two halves' means, so they agree to fp32 rounding, and the parameters
after several Adam steps to ``ADAM_ATOL + 1e-4 |p|`` (see
``test_torch_rllib.py``).
"""

import jax
import numpy as np
import pytest

import _torch_ranks
import ray_tpu.rllib as jrl
from ray_tpu.parallel import MeshConfig as JaxMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import impala as jimpala
from ray_tpu_torch.rllib import (DQNLearner, ImpalaLearner, PPOLearner,
                                 policy_params_from_jax, q_params_from_jax)
from test_torch_rllib import (ADAM_ATOL, _aux, _close, _dqn_batch,
                              _impala_fragments, _np, _ppo_batch)

_PPO_KW = dict(num_epochs=2, minibatch_size=64, seed=3)
_DQN_KW = dict(lr=5e-4, gamma=0.99, grad_clip=10.0, hidden=64, seed=0)


def _cases():
    rng = np.random.default_rng(0)
    return {
        "ppo": {"weights": list(_np(jrl.init_policy(4, 2, 64, 0))),
                "batch": _ppo_batch(), "kw": _PPO_KW},
        "dqn": {"weights": list(_np(jdqn.init_q(4, 2, 64, 0))),
                "batches": [_dqn_batch(rng) for _ in range(3)],
                "kw": _DQN_KW},
        "impala": {"weights": list(_np(jrl.init_policy(4, 2, 64, 0))),
                   "fragments": [_impala_fragments(seed=10 * s)
                                 for s in range(3)]},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    out = _torch_ranks.run(_torch_ranks.rllib_mesh, 2, cases,
                           tmp=tmp_path_factory.mktemp("rllib_mesh"))
    return cases, out


def _jax_mesh():
    return jax_make_mesh(JaxMeshConfig(dp=2, fsdp=1),
                         devices=jax.devices()[:2])


def _jax_run(name, cases, mesh):
    c = cases[name]
    if name == "ppo":
        jl = jrl.PPOLearner(4, 2, seed=0, mesh=mesh)
        return jl.update_from_batch(c["batch"], **c["kw"]), jl
    if name == "dqn":
        jl = jdqn.DQNLearner(4, 2, mesh=mesh, **c["kw"])
        return [jl.update_from_batch(b) for b in c["batches"]][-1], jl
    jl = jimpala.ImpalaLearner(4, 2, seed=0, mesh=mesh)
    return [jl.update_from_fragments(f) for f in c["fragments"]][-1], jl


def _port_run(name, cases):
    """The port's one-process update on the same inputs."""
    c = cases[name]
    if name == "ppo":
        tl = PPOLearner(4, 2, device="cpu")
        tl.set_weights(c["weights"])
        return tl.update_from_batch(c["batch"], **c["kw"]), tl.params
    if name == "dqn":
        tl = DQNLearner(4, 2, device="cpu", **c["kw"])
        q0 = q_params_from_jax(c["weights"], "cpu").state_dict()
        tl.params.load_state_dict(q0)
        tl.target_params.load_state_dict(q0)
        return [tl.update_from_batch(b) for b in c["batches"]][-1], tl.params
    tl = ImpalaLearner(4, 2, device="cpu")
    tl.params.load_state_dict(
        policy_params_from_jax(c["weights"], "cpu").state_dict())
    return ([tl.update_from_fragments(f) for f in c["fragments"]][-1],
            tl.params)


def _from_jax(name, jl):
    tree = _np(jl.params)
    return (q_params_from_jax(tree, "cpu") if name == "dqn"
            else policy_params_from_jax(tree, "cpu")).state_dict()


def _same_params(got, want, atol=ADAM_ATOL, rtol=1e-4):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], np.asarray(want[k]), rtol, atol, msg=k)


@pytest.mark.parametrize("name", ["ppo", "dqn", "impala"])
def test_mesh_update_matches_one_process_and_jax(runs, name):
    cases, out = runs
    (m0, p0, *_), (m1, p1, *_) = out[0][name], out[1][name]
    # Replicated: both ranks hold the same parameters and metrics.
    assert m0 == m1
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k])
    one_m, one_p = _port_run(name, cases)
    _aux(m0, one_m, rtol=1e-4, atol=1e-6)
    _same_params(p0, {k: v.detach().numpy()
                      for k, v in one_p.state_dict().items()})
    jm, jl = _jax_run(name, cases, _jax_mesh())
    _aux(m0, jm, rtol=1e-4, atol=1e-6)
    _same_params(p0, {k: v.numpy() for k, v in _from_jax(name, jl).items()})


def test_mesh_uneven_minibatch_raises(runs):
    """15 rows do not divide over dp 2: ValueError on every rank, as
    placing the JAX batch on its sharding raises."""
    _, out = runs
    assert all(rank["ppo"][2] for rank in out)
    cases = _cases()
    jl = jrl.PPOLearner(4, 2, seed=0, mesh=_jax_mesh())
    with pytest.raises(ValueError):
        jl.update_from_batch(cases["ppo"]["batch"], num_epochs=1,
                             minibatch_size=15)
