"""CPU parity of the port's sharded MoE train steps with the JAX
package's, on four spawned gloo ranks (one spawn for every case; the JAX
side and the tolerances are in ``_jax_sharded.py``), under
``moe_sharding_rules`` (the expert dim over ep, megatron over fsdp/tp
within an expert):
- ep 2 x tp 2, against JAX's sharded step on that mesh;
- ep 2 x fsdp 2 (the batch split: capacity and claims over the global
  token order), against JAX's sharded step on that mesh (as
  ``tests/test_models.py`` does at ep 2 x fsdp 2 x tp 2);
- the sequence split over sp 2 and the batch over fsdp 2, against JAX's
  unsharded step.
"""

import pytest

import _jax_sharded as js

_CASES = {
    "moe_ep2_tp2": ("moe", dict(fsdp=1, tp=2, ep=2), False, True),
    "moe_fsdp2_ep2": ("moe", dict(fsdp=2, ep=2), False, True),
    "moe_seq_sp2": ("moe", dict(fsdp=2, sp=2), True, False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return js.run_port(_CASES, tmp_path_factory.mktemp("sharded_moe"))


@pytest.fixture(scope="module")
def sides():
    return {name: js.jax_side(case) for name, case in _CASES.items()}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_first_step_gradients_match_jax(runs, sides, name):
    js.check_first_step_grads(runs[name], sides[name], _CASES[name][1])


@pytest.mark.parametrize("name", sorted(_CASES))
def test_two_steps_match_jax(runs, sides, name):
    js.check_two_steps(runs[name], sides[name], _CASES[name][1])


@pytest.mark.parametrize("name", sorted(_CASES))
def test_sharded_params_hold_only_their_shard(runs, name):
    js.check_local_shards(runs[name], _CASES[name][1], "moe")
    assert runs[name][0]["params"]["layers.0.moe.w1"][1] == \
        ("ep", "fsdp", "tp")
