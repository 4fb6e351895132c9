"""CPU parity of the port's sharded Llama train steps
(``make_train_step(mesh=, rules=)``) with the JAX package's, on four
spawned gloo ranks (one spawn for both cases; the cases, the JAX side and
the tolerances are in ``_jax_sharded.py``):
- fsdp 2 x tp 2 under ``llama_sharding_rules``, against JAX's sharded
  step on the same mesh (as ``tests/test_models.py`` does at fsdp 4 x
  tp 2);
- the sequence split over sp 2 and the batch over fsdp 2
  (``sp_shard_seq``, ``sp_ring=True``: ring attention, RoPE at global
  positions, the loss summed over both), against JAX's unsharded step;
- LoRA adapters (``lora_sharding_rules``: replicated) trained over the
  base model placed at fsdp 2 x tp 2, against JAX's unsharded LoRA step:
  each tp rank's heads take their columns of the adapter, whose gradient
  sums the tp ranks' shares.
"""

import pytest

import _jax_sharded as js

_CASES = {
    "llama_fsdp2_tp2": ("llama", dict(fsdp=2, tp=2), False, True),
    "llama_seq_sp2": ("llama", dict(fsdp=2, sp=2), True, False),
    "lora_fsdp2_tp2": ("lora", dict(fsdp=2, tp=2), False, False),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return js.run_port(_CASES, tmp_path_factory.mktemp("sharded"))


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
    js.check_local_shards(runs[name], _CASES[name][1], _CASES[name][0])
    if name == "llama_fsdp2_tp2":  # a quarter of the global wq
        wq = runs[name][0]["params"]["layers.0.attn.wq"]
        assert wq[0].shape == (wq[2][0] // 2, wq[2][1] // 2)
