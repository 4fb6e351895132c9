"""Data to Train, and rllib to Tune, in the port against the JAX package.

``_torch_data_scenarios.data_train`` runs under each package (one process
a package, both at once): ``TorchTrainer(datasets=...)`` (JAX's
``JaxTrainer``) on two workers of one node reads a streamed dataset, two
epochs; the port's gang runs with ``use_gpu=False`` and its batches with
``device="cpu"``.  The shards must be disjoint, cover every row and be the
same each epoch, and each rank's data wait must reach the gang's round
records, as in ``tests/test_gang_obs.py``; the JAX package's own case
(``tests/test_data_train.py``) is slow and two-node.  Then one PPO trial
through ``PPO.as_trainable(config, stop_iters=1)`` on the CPU under each
package."""

import pytest

import _torch_data_scenarios as sc

_results = {}


def _pair():
    if "pair" not in _results:
        try:
            ref, got = sc.run_pair(["data_train"])
            _results["pair"] = (ref["data_train"], got["data_train"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["pair"] = e
    if isinstance(_results["pair"], Exception):
        raise _results["pair"]
    return _results["pair"]


@pytest.mark.parametrize("case", ["ingest", "data_wait", "ppo_trial"])
def test_data_train_matches_jax(case):
    ref, got = _pair()
    assert got[case] == ref[case]


def test_shards_disjoint_and_covering():
    _, got = _pair()
    assert got["ingest"] == {"error": None, "epochs_equal": [True, True],
                             "disjoint": True, "covering": True,
                             "rounds": 2}


def test_data_wait_reaches_the_round_records():
    _, got = _pair()
    (gang,) = got["data_wait"]
    assert gang["world"] == 2 and gang["rounds"] == [1, 2]
    assert gang["data_s_positive"] == {"0": True, "1": True}


def test_ppo_trial_through_as_trainable():
    _, got = _pair()
    assert got["ppo_trial"] == ["TERMINATED", None, 1,
                                ["episode_return_mean",
                                 "num_env_steps_sampled"]]


def test_chip_smoke_data_tune_phase_runs_on_cpu(monkeypatch):
    """``chip_smoke.phase_data_tune`` rehearsed on the CPU (``dev="cpu"``,
    the tiny model in place of Llama-3-8B): the prefetch check's batches
    equal their host rows, then ``Tuner`` runs two ``TorchTrainer`` trials
    fed by the streamed dataset, each first loss equal bit for bit to one
    step of the same model on the same tokens here."""
    import torch

    import chip_smoke as cs
    from ray_tpu_torch.models.llama import llama_init, llama_loss
    from ray_tpu_torch.models.train_state import (TrainState,
                                                  default_optimizer,
                                                  make_train_step)

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = cs._gang_cfg("cpu")
    gen = torch.Generator().manual_seed(0 + 2)  # the gang loop's draws
    params = llama_init(cfg, gen, "cpu", trainable=True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    tx = default_optimizer(lr=1e-4)
    step = make_train_step(
        lambda p, b: llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    _, m = step(TrainState.create(params, tx),
                {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)})
    report = {}
    cs.phase_data_tune(torch, report, 0, "cpu", tokens, float(m["loss"]),
                       dev="cpu")
    out = report["data_tune"]
    assert out["prefetch"]["rows"] == cs.PREFETCH_ROWS
    assert [t["lr"] for t in out["trials"]] == list(cs.TUNE_LRS)
    assert all(len(t["losses"]) == cs.TUNE_STEPS for t in out["trials"])
    assert all(t["visible"] == "" for t in out["trials"])  # no card
    assert not any(out["launches"].values())
