"""The port's training library against the JAX package's: the same train
loops through ``ray_tpu_torch.train.TorchTrainer`` and ``ray_tpu.train.
JaxTrainer`` (``_torch_train_scenarios.trainer``, one process a package,
both at once) must report the same results — the gang's host-plane
allreduce, the tiny Llama's losses (also against ``make_train_step`` in
this process), and a worker killed after its step-2 checkpoint restored to
the uninterrupted run's step 3.  Then the pure parts on the same inputs:
``CheckpointManager``'s retention, the async writer (in-place updates after
``save``, bf16 bit for bit, write errors), ``TrainTelemetry``'s MFU,
``ScalingConfig`` and the declared refusals.

Tolerance: the two packages' tiny-Llama losses agree to fp32
summation-order noise, held to 2e-5 + 1e-4 |loss| as in
``tests/test_torch_train.py``; a restored run is the same code on the same
state, so its step-3 loss is held bit for bit to its own package's
uninterrupted run."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import _torch_train_scenarios as sc
from ray_tpu import train as jtrain
from ray_tpu.train import telemetry as jtelemetry
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.parallel import MeshConfig
from ray_tpu_torch.train import telemetry as ttelemetry

ATOL, RTOL = 2e-5, 1e-4

_results = {}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX package's tiny ``llama_init`` tree as numpy, pickled."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig, llama_init

    jc = dataclasses.replace(LlamaConfig.tiny(remat=False, dtype=jnp.float32),
                             n_heads=4, n_kv_heads=2, loss_chunk=8)
    path = tmp_path_factory.mktemp("trainer") / "tree.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray,
                                 llama_init(jc, jax.random.PRNGKey(0))), f)
    return str(path)


def _trainer(tree):
    """Both packages' results, computed once; a failure is kept too, so
    every test reports the one run's error."""
    if "trainer" not in _results:
        try:
            ref, got = sc.run_pair(["trainer"],
                                   env={"RT_TRAIN_TREE": tree})
            _results["trainer"] = (ref["trainer"], got["trainer"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["trainer"] = e
    if isinstance(_results["trainer"], Exception):
        raise _results["trainer"]
    return _results["trainer"]


def _losses(history):
    return [m["loss"] for m in history]


def test_gang_allreduce_doubles_each_worker_total(tree):
    """``_spmd_loop``: each worker's sum(0..7) = 28, doubled by the gang's
    allreduce.  A JAX worker's mesh spans its four virtual devices; a port
    worker holds one position of a mesh over the gang (fsdp 2 = two
    workers)."""
    ref, got = _trainer(tree)
    assert got["spmd"]["error"] is None and ref["spmd"]["error"] is None
    assert got["spmd"]["metrics"]["total"] == \
        ref["spmd"]["metrics"]["total"] == 56.0
    assert ref["spmd"]["metrics"]["mesh"] == {
        "dp": 1, "fsdp": 2, "tp": 2, "sp": 1, "ep": 1, "pp": 1}
    assert got["spmd"]["metrics"]["mesh"] == {
        "dp": 1, "fsdp": 2, "tp": 1, "sp": 1, "ep": 1, "pp": 1}


def test_mesh_none_without_config(tree):
    ref, got = _trainer(tree)
    assert got["no_mesh"] is ref["no_mesh"] is True


def test_default_gang_refused_without_a_card(tree):
    """The default ``ScalingConfig`` asks each worker for a card; on a
    cluster with none, ``fit()`` raises rather than train on the CPU."""
    _, got = _trainer(tree)
    assert got["no_card"] is not None
    assert "use_gpu=False" in got["no_card"]


def test_llama_losses_match_driver_and_jax(tree):
    """Three steps through the trainer: the same losses as
    ``make_train_step`` run here on the same weights, and as the JAX
    package's trainer."""
    from ray_tpu_torch.models import (LlamaConfig, TrainState,
                                      default_optimizer, llama_loss,
                                      make_train_step, params_from_jax)

    ref, got = _trainer(tree)
    assert got["llama"]["error"] is None and ref["llama"]["error"] is None
    assert [m["step"] for m in got["llama"]["history"]] == [1, 2, 3]
    with open(tree, "rb") as f:
        np_tree = pickle.load(f)
    cfg = dataclasses.replace(LlamaConfig.tiny(dtype=torch.float32),
                              n_heads=4, n_kv_heads=2, loss_chunk=8)
    tx = default_optimizer(lr=sc.LLAMA_LR)
    state = TrainState.create(
        params_from_jax(cfg, np_tree, device="cpu", trainable=True), tx)
    step = make_train_step(
        lambda p, b: llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    toks, tgt = sc.llama_batch()
    batch = {"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(tgt).long()}
    here = []
    for _ in range(sc.LLAMA_STEPS):
        state, m = step(state, batch)
        here.append(float(m["loss"]))
    np.testing.assert_allclose(_losses(got["llama"]["history"]), here,
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_losses(got["llama"]["history"]),
                               _losses(ref["llama"]["history"]),
                               atol=ATOL, rtol=RTOL)
    assert got["metrics_step"] == ref["metrics_step"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_killed_worker_restores_the_step_2_checkpoint(tree, pkg):
    """``FailureConfig(max_failures=1)``: the worker SIGKILLs itself after
    reporting its step-2 checkpoint; the new gang restores it and reports
    the uninterrupted run's step-3 loss, bit for bit."""
    res = dict(zip(("jax", "port"), _trainer(tree)))[pkg]
    r = res["restore"]
    assert r["error"] is None and r["killed"]
    assert [m["step"] for m in r["history"]] == [1, 2, 3]
    assert r["checkpoint_step"] == 2
    assert _losses(r["history"]) == _losses(res["llama"]["history"])


def test_async_checkpoint_survives_in_place_updates(tree):
    """The port's loop overwrites its tensors right after ``save`` returns
    and again after ``report``: the checkpoint holds the values at
    ``save``, bf16 included."""
    _, got = _trainer(tree)
    m = got["mutate"]
    assert m["error"] is None
    assert m["w"] == np.arange(16, dtype=np.float32).reshape(4, 4).tolist()
    assert m["m"] == [0.5] * 8 and m["m_dtype"] == "torch.bfloat16"
    assert m["w_now"] == 200.0


@pytest.mark.parametrize("order", ["max", "min"])
def test_checkpoint_manager_keeps_n_as_jax(tmp_path, order):
    """Top-2 by score (and by recency without a score): the same
    checkpoints survive under both packages."""
    scores = [0.3, 0.9, 0.1, 0.5, 0.7]
    kept = {}
    for name, mod in (("jax", jtrain), ("port", ttrain)):
        src = tmp_path / f"src_{name}"
        src.mkdir()
        (src / "w.txt").write_text("x")
        for attr in ("score", None):
            mgr = mod.CheckpointManager(
                str(tmp_path / f"{name}_{attr}_{order}"), num_to_keep=2,
                score_attribute=attr, score_order=order)
            for s in scores:
                mgr.register(mod.Checkpoint(str(src)), {"score": s})
            kept[name, attr] = (
                sorted(os.listdir(mgr.storage_dir)),
                os.path.basename(mgr.latest().path),
                os.path.basename(mgr.best().path))
    for attr in ("score", None):
        assert kept["port", attr] == kept["jax", attr]
    assert len(kept["port", "score"][0]) == 2


def test_save_and_load_a_train_state_bit_for_bit(tmp_path):
    """``save_pytree`` of a ``TrainState`` (a module, its AdamW and the
    step) in bf16: the restored parameters and moments are the same bits,
    and a step from the restored state equals a step from the original."""
    from ray_tpu_torch.models import (LlamaConfig, TrainState,
                                      default_optimizer, llama_init,
                                      llama_loss, make_train_step)

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    tx = default_optimizer(lr=1e-3)

    def fresh():
        p = llama_init(cfg, torch.Generator().manual_seed(3), "cpu",
                       trainable=True)
        return TrainState.create(p, tx)

    step = make_train_step(
        lambda p, b: llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    toks, tgt = sc.llama_batch()
    batch = {"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(tgt).long()}
    state, _ = step(fresh(), batch)
    ttrain.save_pytree(state, str(tmp_path))
    saved = ttrain.load_pytree(str(tmp_path))
    assert saved["step"] == 1
    back = fresh()
    back.params.load_state_dict(saved["params"])
    back.opt_state.load_state_dict(saved["opt_state"])
    back.step = saved["step"]
    for (n, a), b in zip(state.params.state_dict().items(),
                         back.params.state_dict().values()):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n
    _, m1 = step(state, batch)
    _, m2 = step(back, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_async_writer_round_trip_and_errors(tmp_path):
    """``tests/test_train_spmd.py``'s async writer test on the port: saves
    land on ``wait``, the newest replaces the older, a failing write
    surfaces on ``wait``; and a bf16 tensor returns bit for bit."""
    w = ttrain.AsyncCheckpointWriter()
    dest = str(tmp_path / "step10")
    bf = torch.randn(64, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tree = {"p": torch.arange(1024.0), "opt": {"m": torch.ones((4, 4))},
            "bf": bf, "np": np.arange(3)}
    w.save(tree, dest)
    w.wait()
    back = ttrain.load_pytree(dest)
    assert float(back["p"][-1]) == 1023.0
    assert back["opt"]["m"].shape == (4, 4)
    assert torch.equal(back["bf"].view(torch.int16), bf.view(torch.int16))
    assert back["np"].tolist() == [0, 1, 2]
    for step in (11, 12):
        w.save({"p": torch.full((8,), float(step))}, dest)
    w.wait()
    assert float(ttrain.load_pytree(dest)["p"][0]) == 12.0
    w.save(tree, "/proc/definitely/not/writable/ckpt")
    with pytest.raises(OSError):
        w.wait()


def _gauge(g, rank: str):
    """A gauge's value for one rank tag (the instruments of both packages
    keep their values by tags in ``_values``; the registry is the
    process's, so other tests' ranks may be there too)."""
    return {k: v for k, v in g._values.items() if k == (("rank", rank),)}


def test_telemetry_mfu_from_set_flops_per_step_matches_jax():
    """``set_flops_per_step`` then a step: the same derived numbers and
    the same ``ray_tpu_train_mfu`` gauge under both packages."""
    out = {}
    for name, mod in (("jax", jtelemetry), ("port", ttelemetry)):
        tel = mod.TrainTelemetry(peak_flops=989e12, num_devices=1,
                                 tokens_per_step=2048, rank=7)
        assert tel.record_step(0.5) == {"step_time_s": 0.5,
                                        "tokens_per_sec": 4096.0}
        tel.set_flops_per_step(6 * 8.03e9 * 2048)
        got = tel.record_step(0.35)
        out[name] = (got, tel.last, _gauge(tel._g_mfu, "7"))
    assert out["port"] == out["jax"]
    assert out["port"][2] == {(("rank", "7"),): out["port"][0]["mfu"]}
    assert out["port"][0]["mfu"] == pytest.approx(
        6 * 8.03e9 * 2048 / 0.35 / 989e12)


def test_peak_flops_read_the_card_name(monkeypatch):
    """"NVIDIA H100 80GB HBM3" is the table's ``h100``; no card is the CPU
    nominal; the port has no cost model of a step (None, as the JAX
    function answers without one)."""
    assert ttelemetry.PEAK_FLOPS_TABLE == jtelemetry.PEAK_FLOPS_TABLE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttelemetry.device_peak_flops() == \
        ttelemetry.CPU_NOMINAL_PEAK_FLOPS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ttelemetry.device_peak_flops() == 989e12
    assert ttelemetry.TrainTelemetry().peak_flops_total() == 989e12
    assert ttelemetry.flops_per_step(lambda x: x, 1.0) is None
    assert ttelemetry.transformer_flops(10, 3) == \
        jtelemetry.transformer_flops(10, 3)


def test_scaling_config_asks_for_gpus():
    """``use_gpu`` is the JAX ``use_tpu``: a worker asks for one card (by
    default: the port's entry points run on the card unless told
    otherwise), and the gang joins a process group when it spans cards or
    a mesh."""
    sc_ = ttrain.ScalingConfig
    assert sc_().worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert sc_(use_gpu=True).worker_resources() == {"CPU": 1.0, "GPU": 1.0}
    assert jtrain.ScalingConfig(use_tpu=True).worker_resources() == {
        "CPU": 1.0, "TPU": 1.0}
    assert sc_(use_gpu=False).worker_resources() == {"CPU": 1.0}
    assert sc_(num_workers=2).wants_torch_distributed()
    assert not sc_(num_workers=1, use_gpu=True).wants_torch_distributed()
    assert not sc_(num_workers=2, use_gpu=False).wants_torch_distributed()
    assert sc_(num_workers=2, use_gpu=False,
               mesh=MeshConfig()).wants_torch_distributed()
    assert not sc_(num_workers=2, use_gpu=True,
                   torch_distributed=False).wants_torch_distributed()


def test_refusals():
    """``datasets=`` is taken now that data/ is ported: each worker gets
    its shard as the JAX trainer gives it (a list split round-robin, any
    other object replicated; a Dataset's ``streaming_split`` is driven in
    ``tests/test_torch_data_train.py``).  A mesh must cover the gang, one
    position a worker."""
    kw = dict(datasets={"train": list(range(7)), "cfg": {"a": 1}},
              scaling_config=None)
    for n in (None, 3):
        sc_t = ttrain.ScalingConfig(num_workers=2, use_gpu=False)
        sc_j = jtrain.ScalingConfig(num_workers=2)
        got = ttrain.TorchTrainer(lambda: None, **dict(
            kw, scaling_config=sc_t))._make_dataset_shards(n)
        want = jtrain.JaxTrainer(lambda: None, **dict(
            kw, scaling_config=sc_j))._make_dataset_shards(n)
        assert got == want and len(got) == (n or 2)
    assert ttrain.TorchTrainer(lambda: None)._make_dataset_shards() is None
    with pytest.raises(ValueError, match="cover"):
        ttrain.TorchTrainer(lambda: None, scaling_config=ttrain.ScalingConfig(
            num_workers=2, mesh=MeshConfig(fsdp=4)))
    ttrain.TorchTrainer(lambda: None, scaling_config=ttrain.ScalingConfig(
        num_workers=4, mesh=MeshConfig(fsdp=2, tp=2)))


def test_merge_checkpoints_matches_jax(tmp_path):
    """The port merges the ranks' staged checkpoint dirs by hard links
    where the JAX trainer copies: the merged tree reads the same (rank 0
    wins a collision), and the staged files are left as they were."""
    import pathlib

    dirs = []
    for r in range(2):
        d = tmp_path / f"rank{r}"
        (d / "sub").mkdir(parents=True)
        (d / "shared").write_text(f"rank {r}")
        (d / f"own{r}").write_text(str(r))
        (d / "sub" / "x").write_text(f"x{r}")
        dirs.append(str(d))

    def read(root):
        return {str(p.relative_to(root)): p.read_text()
                for p in pathlib.Path(root).rglob("*") if p.is_file()}

    got = ttrain.TorchTrainer._merge_checkpoints(dirs)
    want = jtrain.JaxTrainer._merge_checkpoints(dirs)
    assert read(got) == read(want)
    assert read(got)["shared"] == "rank 0" and read(got)["sub/x"] == "x0"
    assert read(dirs[1]) == {"shared": "rank 1", "own1": "1", "sub/x": "x1"}


def test_register_links_only_when_told(tmp_path):
    """``CheckpointManager.register`` copies a checkpoint (a caller may
    write its directory again), as the JAX manager does; with
    ``link=True`` (the trainer's private merged copy) it hard-links the
    files, and what it persists reads the same either way."""
    src = tmp_path / "merged"
    src.mkdir()
    (src / "state").write_bytes(b"\x00\x01" * 1000)
    mgr = ttrain.checkpoint.CheckpointManager(str(tmp_path / "store"))
    copied = mgr.register(ttrain.Checkpoint(str(src)), {"step": 1})
    linked = mgr.register(ttrain.Checkpoint(str(src)), {"step": 2},
                          link=True)
    ino = os.stat(src / "state").st_ino
    for ck in (copied, linked):
        with open(os.path.join(ck.path, "state"), "rb") as f:
            assert f.read() == b"\x00\x01" * 1000
    assert os.stat(os.path.join(copied.path, "state")).st_ino != ino
    assert os.stat(os.path.join(linked.path, "state")).st_ino == ino
