"""Training-library scenarios run under either package, one process each.

``python tests/_torch_train_scenarios.py --pkg ray_tpu_torch trainer``
imports the named package as ``rt``, runs the named scenarios in order
(each starts and stops its own cluster) and prints one JSON line,
``{scenario: result}``.  The tests (``tests/test_torch_trainer.py``,
``test_torch_collective.py``, ``test_torch_chaos.py``,
``test_torch_rllib_algos.py``) run a file's scenarios in one process per
package, both at once, and compare the two results, so every value a
scenario returns is one the packages must agree on (or one the test reads
under each package's own meaning, as the mesh a worker sees).

Weights cross as numpy: ``RT_TRAIN_TREE`` is a pickle of the JAX
package's tiny ``llama_init`` tree; for the rllib drivers the JAX process
writes each learner's initial weights under ``RT_RL_WEIGHTS_DIR`` right
after ``build()`` and the port's process waits for them and starts its
learner there (``config.initial_weights``).
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import pickle
import sys
import tempfile
import time

from _torch_runtime_scenarios import result

SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def _sub(rt, name: str):
    return importlib.import_module(f"{rt.__name__}.{name}")


# ----------------------------------------------------------------- trainer

#: The tiny Llama of ``tests/test_torch_train.py``'s ``_pair("tiny",
#: loss_chunk=8)`` at lr 1e-3, B=4, S=32, three steps.
LLAMA_STEPS = 3
LLAMA_LR = 1e-3


def llama_batch():
    """``tests/test_torch_train.py``'s ``_batch()``: tokens and rolled
    targets with three ignored positions, from ``default_rng(1)``."""
    import numpy as np

    r = np.random.default_rng(1)
    toks = r.integers(0, 512, (4, 32)).astype(np.int32)
    tgt = np.roll(toks, -1, axis=1)
    tgt[r.integers(0, 4, 3), r.integers(0, 32, 3)] = -100
    return toks, tgt


def _llama_port(config):
    """The port's train loop: the tiny Llama from the numpy tree, restored
    from the session's checkpoint when there is one; a checkpoint at the
    steps ``ckpt_at`` names, and a SIGKILL of its own process right after
    reporting step ``kill_at`` (once: a marker file remembers)."""
    import dataclasses
    import signal

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import (LlamaConfig, TrainState,
                                      default_optimizer, llama_loss,
                                      make_train_step, params_from_jax)

    with open(config["tree"], "rb") as f:
        tree = pickle.load(f)
    cfg = dataclasses.replace(LlamaConfig.tiny(dtype=torch.float32),
                              n_heads=4, n_kv_heads=2, loss_chunk=8)
    params = params_from_jax(cfg, tree, device="cpu", trainable=True)
    tx = default_optimizer(lr=LLAMA_LR)
    state = TrainState.create(params, tx)
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        saved = train.load_pytree(ckpt.path)
        params.load_state_dict(saved["params"])
        state.opt_state.load_state_dict(saved["opt_state"])
        state.step = saved["step"]
    step = make_train_step(
        lambda p, b: llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    toks, tgt = llama_batch()
    batch = {"tokens": torch.from_numpy(toks).long(),
             "targets": torch.from_numpy(tgt).long()}
    while state.step < LLAMA_STEPS:
        state, m = step(state, batch)
        ck = None
        if state.step in config.get("ckpt_at", ()):
            d = tempfile.mkdtemp(prefix="llama_ckpt_")
            train.save_pytree(state, d)
            ck = train.Checkpoint.from_directory(d)
        train.report({"step": int(m["step"]), "loss": float(m["loss"])},
                     checkpoint=ck)
        marker = config.get("marker")
        if config.get("kill_at") == state.step and not os.path.exists(marker):
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)


def _llama_jax(config):
    """The JAX package's twin of ``_llama_port``."""
    import dataclasses
    import signal

    import jax
    import jax.numpy as jnp

    from ray_tpu import train
    from ray_tpu.models import (LlamaConfig, TrainState, llama_loss,
                                make_train_step)
    from ray_tpu.models.train_state import default_optimizer

    with open(config["tree"], "rb") as f:
        tree = pickle.load(f)
    cfg = dataclasses.replace(LlamaConfig.tiny(remat=False,
                                               dtype=jnp.float32),
                              n_heads=4, n_kv_heads=2, loss_chunk=8)
    tx = default_optimizer(lr=LLAMA_LR)
    state = TrainState.create(jax.tree.map(jnp.asarray, tree), tx)
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state = jax.tree.map(jnp.asarray, train.load_pytree(ckpt.path))
    step = make_train_step(
        lambda p, b: llama_loss(cfg, p, b["tokens"], b["targets"]), tx)
    toks, tgt = llama_batch()
    batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    while int(state.step) < LLAMA_STEPS:
        state, m = step(state, batch)
        ck = None
        if int(state.step) in config.get("ckpt_at", ()):
            d = tempfile.mkdtemp(prefix="llama_ckpt_")
            train.save_pytree(state, d)
            ck = train.Checkpoint.from_directory(d)
        train.report({"step": int(m["step"]), "loss": float(m["loss"])},
                     checkpoint=ck)
        marker = config.get("marker")
        if config.get("kill_at") == int(state.step) \
                and not os.path.exists(marker):
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)


def _spmd_port(config=None):
    """``tests/test_train_spmd.py``'s ``_spmd_loop`` on the port: each
    worker's sum of 0..7, all-reduced over the gang's host-plane group
    (the input a CPU tensor), and the mesh the worker sees."""
    import torch

    from ray_tpu_torch import collective, train
    from ray_tpu_torch.train.session import get_session

    mesh = train.get_mesh()
    assert mesh is not None
    local = float(torch.arange(8.0).sum())
    sess = get_session()
    if sess.world_size > 1:
        local = float(collective.allreduce(
            torch.tensor([local]), group_name=sess.collective_group)[0])
    sizes = dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
    train.report({"total": local, "mesh": sizes})


def _spmd_jax(config=None):
    """``tests/test_train_spmd.py``'s ``_spmd_loop``: four virtual CPU
    devices a worker, the batch split over dp + fsdp."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ray_tpu import collective, train
    from ray_tpu.parallel import data_sharding
    from ray_tpu.train.session import get_session

    mesh = train.get_mesh()
    assert mesh is not None
    x = jax.device_put(jnp.arange(8.0).reshape(8, 1), data_sharding(mesh))
    local = float(jax.jit(lambda v: v.sum())(x))
    sess = get_session()
    if sess.world_size > 1:
        local = float(collective.allreduce(
            np.array([local], np.float32),
            group_name=sess.collective_group)[0])
    sizes = dict(zip(mesh.axis_names, (int(n) for n in mesh.devices.shape)))
    train.report({"total": local, "mesh": sizes})


def _no_mesh(config=None):
    import importlib as il

    train = il.import_module(config["pkg"] + ".train")
    train.report({"mesh_is_none": train.get_mesh() is None})


def _mutate_port(config=None):
    """The async writer and ``report`` against in-place updates: the tensors
    are overwritten as soon as ``save`` returns and again right after
    ``report`` returns; the checkpoint must hold the values at ``save``."""
    import torch

    from ray_tpu_torch import train

    w = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    m = torch.full((8,), 0.5, dtype=torch.bfloat16)
    writer = train.AsyncCheckpointWriter()
    d = os.path.join(tempfile.mkdtemp(prefix="mut_"), "ckpt")
    writer.save({"w": w, "m": m, "step": 1}, d)
    w.add_(100.0)  # the fused AdamW's kind of update, right after save
    m.mul_(3)
    writer.wait()
    train.report({"step": 1}, checkpoint=train.Checkpoint.from_directory(d))
    w.add_(100.0)
    m.mul_(3)
    train.report({"step": 2, "w_now": float(w[0, 0])})


def _saved_step(saved) -> int:
    """The step of a saved train state: the port's is a dict of the
    dataclass's fields, the JAX package's the ``TrainState`` itself."""
    return int(saved["step"] if isinstance(saved, dict) else saved.step)


def _cpu_gang(rt, **kw):
    """A ``ScalingConfig`` of CPU workers: the port's gang asks for a card
    unless told ``use_gpu=False``, the JAX package's for none unless told
    ``use_tpu=True``."""
    if _port(rt):
        kw["use_gpu"] = False
    return _sub(rt, "train").ScalingConfig(**kw)


def _fit(rt, loop, scaling, storage, config=None, max_failures=0):
    train = _sub(rt, "train")
    trainer_cls = train.TorchTrainer if _port(rt) else train.JaxTrainer
    res = trainer_cls(
        loop, train_loop_config=config, scaling_config=scaling,
        run_config=train.RunConfig(
            storage_path=storage,
            failure_config=train.FailureConfig(max_failures=max_failures)),
    ).fit()
    return res


@scenario
def trainer(rt):
    """The gang, its mesh and host-plane allreduce; a worker with no mesh;
    the tiny Llama's three steps through the trainer, uninterrupted and
    with its worker killed after the step-2 checkpoint; the port's async
    checkpoint against in-place updates."""
    train = _sub(rt, "train")
    parallel = _sub(rt, "parallel")
    rt.init(num_cpus=4)
    out = {}
    tmp = tempfile.mkdtemp(prefix="trainer_")
    if _port(rt):
        scaling = _cpu_gang(rt, num_workers=2, mesh=parallel.MeshConfig(fsdp=2))
        loop = _spmd_port
    else:
        scaling = train.ScalingConfig(
            num_workers=2, mesh=parallel.MeshConfig(dp=1, fsdp=2, tp=2, sp=1),
            runtime_env={"env_vars": {
                "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}})
        loop = _spmd_jax
    res = _fit(rt, loop, scaling, tmp)
    out["spmd"] = {"error": repr(res.error) if res.error else None,
                   "metrics": res.metrics}
    res = _fit(rt, _no_mesh, _cpu_gang(rt, num_workers=1), tmp,
               {"pkg": rt.__name__})
    out["no_mesh"] = res.metrics.get("mesh_is_none")

    llama = _llama_port if _port(rt) else _llama_jax
    tree = os.environ["RT_TRAIN_TREE"]
    res = _fit(rt, llama, _cpu_gang(rt, num_workers=1), tmp,
               {"tree": tree})
    out["llama"] = {"error": repr(res.error) if res.error else None,
                    "history": res.metrics_history}
    cfg = {"tree": tree, "ckpt_at": [2], "kill_at": 2,
           "marker": os.path.join(tmp, "killed")}
    res = _fit(rt, llama, _cpu_gang(rt, num_workers=1), tmp, cfg,
               max_failures=1)
    out["restore"] = {
        "error": repr(res.error) if res.error else None,
        "history": res.metrics_history,
        "killed": os.path.exists(cfg["marker"]),
        "checkpoint_step": (_saved_step(train.load_pytree(
            res.checkpoint.path)) if res.checkpoint else None)}
    if _port(rt):
        # The default gang asks for a card; this cluster has none.
        try:
            _fit(rt, _no_mesh, train.ScalingConfig(), tmp, {"pkg": rt.__name__})
            out["no_card"] = None
        except RuntimeError as e:
            out["no_card"] = str(e)
        res = _fit(rt, _mutate_port, _cpu_gang(rt, num_workers=1), tmp)
        out["mutate"] = {"error": repr(res.error) if res.error else None}
        if res.checkpoint is not None:
            saved = train.load_pytree(res.checkpoint.path)
            out["mutate"].update(
                w=saved["w"].tolist(), m=saved["m"].float().tolist(),
                m_dtype=str(saved["m"].dtype), w_now=res.metrics["w_now"])
    out["metrics_step"] = sorted(
        k for k in out["llama"]["history"][-1] if not k.startswith("_"))
    rt.shutdown()
    return out


# -------------------------------------------------------------- collective


def _rank_cls(rt):
    @rt.remote
    class Rank:
        """``tests/test_collective.py``'s ``Rank``, for either package."""

        def setup(self, pkg, world, rank, name):
            self.col = importlib.import_module(pkg + ".collective")
            self.ctx = importlib.import_module(pkg + ".core.context").ctx
            self.rank, self.world, self.name = rank, world, name
            self.col.init_collective_group(world, rank, group_name=name)
            return rank

        def run_ops(self, tensor_input: bool):
            import numpy as np

            puts = {"n": 0}
            orig = self.ctx.client.kv_put

            def counting_put(key, value, overwrite=True):
                puts["n"] += 1
                return orig(key, value, overwrite)

            x = np.array([self.rank + 1.0])
            if tensor_input:
                import torch

                x = torch.tensor([self.rank + 1.0], dtype=torch.float64)
            self.ctx.client.kv_put = counting_put
            try:
                before = self.col.collective.op_totals()
                summed = self.col.allreduce(x, group_name=self.name)
                gathered = self.col.allgather(
                    np.array([self.rank]), group_name=self.name)
                mean = self.col.allreduce(x, group_name=self.name, op="mean")
                mx = self.col.allreduce(x, group_name=self.name, op="max")
                bc = self.col.broadcast(
                    np.array([7.5 + self.rank]), group_name=self.name,
                    root=1)
                self.col.barrier(self.name)
                after = self.col.collective.op_totals()
                stats = self.col.collective.op_stats()
            finally:
                self.ctx.client.kv_put = orig
            return {
                "sum": summed.tolist(), "sum_type": type(summed).__name__,
                "gathered": [g.tolist() for g in gathered],
                "mean": mean.tolist(), "max": mx.tolist(),
                "broadcast": bc.tolist(), "puts": puts["n"],
                "ops": after["ops"] - before["ops"],
                "bytes": after["bytes"] - before["bytes"],
                "calls": {k: v["calls"] for k, v in sorted(stats.items())},
            }

        def scattered(self):
            import numpy as np

            part = self.col.reducescatter(
                np.arange(self.world, dtype=np.float64), group_name=self.name)
            return part.tolist()

    return Rank


@scenario
def collective(rt):
    """``tests/test_collective.py``'s tree collectives at worlds 3 and 4
    (its world-16 case is ``slow``), with ``op_totals``; under the port a
    second world-4 group takes CPU tensors as input."""
    rt.init(num_cpus=8)
    Rank = _rank_cls(rt)
    out = {}
    cases = [(3, False), (4, False)] + ([(4, True)] if _port(rt) else [])
    for world, tensors in cases:
        name = f"tree{world}{'t' if tensors else ''}"
        actors = [Rank.remote() for _ in range(world)]
        ranks = rt.get([a.setup.remote(rt.__name__, world, r, name)
                        for r, a in enumerate(actors)], timeout=120)
        res = rt.get([a.run_ops.remote(tensors) for a in actors],
                     timeout=120)
        parts = rt.get([a.scattered.remote() for a in actors], timeout=120)
        out[name] = {"ranks": ranks, "results": res, "scattered": parts}
        for a in actors:
            rt.kill(a)
    rt.shutdown()
    return out


# ------------------------------------------------------------------ chaos


@scenario
def chaos(rt):
    """``tests/test_chaos.py``'s retriable work under a ``WorkerKiller``:
    twelve retriable tasks finish while it shoots busy workers."""
    chaos_mod = _sub(rt, "util.chaos")
    rt.init(num_cpus=4)

    @rt.remote(max_retries=10)
    def slow(i):
        time.sleep(0.25)
        return i * 2

    with chaos_mod.WorkerKiller(interval_s=0.3, seed=1) as killer:
        results = rt.get([slow.remote(i) for i in range(12)], timeout=120)
    out = {"results": results, "fired": killer.kills >= 1}
    rt.shutdown()
    return out


# ------------------------------------------------------------ rllib drivers


def _plain(tree):
    """A JAX tree of numpy arrays with every NamedTuple made a dict, so the
    port's process can unpickle it without the JAX package."""
    import numpy as np

    if hasattr(tree, "_asdict"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return np.asarray(tree)


def _handoff(rt, name: str, weights=None, timeout: float = 180.0):
    """The JAX process writes ``name``'s initial learner weights; the
    port's waits for them."""
    path = os.path.join(os.environ["RT_RL_WEIGHTS_DIR"], f"{name}.pkl")
    if not _port(rt):
        with open(path + ".tmp", "wb") as f:
            pickle.dump(_plain(weights), f)
        os.replace(path + ".tmp", path)
        return None
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no JAX weights for {name}")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def paired_cartpole(pkg: str, barrier: str, every: int, seed=None):
    """CartPole whose runners finish each fragment together: the first env
    of each runner (env seeds are ``runner_seed * 10000 + i``) waits, after
    every ``every`` steps, until the other runner's first env has stepped
    as far (files under ``barrier``).  So IMPALA's two runners deliver
    their k-th fragments before either delivers its (k+1)-th, each update
    takes one fragment of each, and the async driver's order (otherwise a
    race) is the same in both packages.  Pass it bound with
    ``functools.partial``: the runners build it by calling the spec."""
    env_cls = importlib.import_module(pkg + ".rllib.env").CartPoleEnv
    runner, index = divmod(seed or 0, 10_000)

    class PairedCartPole(env_cls):
        paired_steps = 0  # the env's own ``steps`` restarts each episode

        def step(self, action):
            out = super().step(action)
            self.paired_steps += 1
            if index == 0 and self.paired_steps % every == 0:
                k = self.paired_steps // every
                open(os.path.join(barrier, f"{runner}_{k}"), "w").close()
                other = os.path.join(barrier, f"{1 - runner}_{k}")
                deadline = time.time() + 120
                while not os.path.exists(other) and time.time() < deadline:
                    time.sleep(0.002)
            return out

    return PairedCartPole(seed=seed)


def _iters(algo, n: int, keys):
    out = []
    for _ in range(n):
        m = algo.train()
        out.append({k: m.get(k) for k in keys})
    return out


@scenario
def rllib_algos(rt):
    """Each driver for two iterations with two runner actors, the learner
    on the CPU, the port's starting from the JAX learner's initial weights:
    what each iteration reports.  Under the port, with one mocked card
    (``RT_GPUS=1``), the card stays free while the runner actors live."""
    rllib = _sub(rt, "rllib")
    rt.init(num_cpus=6)
    port = _port(rt)
    dev = {"device": "cpu"} if port else {}
    out = {"gpus": rt.cluster_resources().get("GPU")}

    def build(name, cfg, get_weights):
        if port:
            cfg.initial_weights = _handoff(rt, name)
            for k, v in dev.items():
                setattr(cfg, k, v)
            return cfg.build()
        algo = cfg.build()
        _handoff(rt, name, get_weights(algo))
        return algo

    losses = ("policy_loss", "vf_loss", "entropy", "total_loss")
    common = ("training_iteration", "num_env_steps_sampled",
              "num_env_steps_sampled_lifetime", "episode_return_mean")

    cfg = (rllib.PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=32)
           .training(num_epochs=2, minibatch_size=64))
    algo = build("ppo", cfg, lambda a: a.learner.get_weights())
    if port:
        out["ppo_card_free"] = rt.available_resources().get("GPU")
    out["ppo"] = _iters(algo, 2, common + losses)
    algo.stop()

    cfg = (rllib.DQNConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=32)
           .training(learning_starts=256, num_updates_per_iteration=8,
                     train_batch_size=32, target_update_freq=4))
    algo = build("dqn", cfg, lambda a: a.learner.params)
    out["dqn"] = _iters(algo, 2, common + (
        "num_gradient_updates_lifetime", "epsilon", "loss",
        "td_error_mean", "qf_mean"))
    algo.stop()

    cfg = (rllib.ImpalaConfig()
           .environment(functools.partial(
               paired_cartpole, rt.__name__,
               tempfile.mkdtemp(prefix="impala_pairs_"), 32))
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=32,
                        num_inflight_per_runner=1)
           .training(fragments_per_update=2, updates_per_iteration=2))
    algo = build("impala", cfg, lambda a: a.learner.get_weights())
    out["impala"] = _iters(algo, 2, common + (
        "num_learner_updates_lifetime", "mean_weight_staleness",
        "mean_rho") + losses)
    algo.stop()

    cfg = rllib.SACConfig().training(
        hidden=32, batch_size=64, updates_per_round=2, warmup_steps=256,
        num_env_runners=2)
    algo = build("sac", cfg, lambda a: a.learner.params)
    sac = []
    for _ in range(2):
        m = algo.train()
        sac.append({"training_iteration": m["training_iteration"],
                    "num_env_steps_sampled_lifetime":
                        m["num_env_steps_sampled_lifetime"],
                    "replay": int(algo._buf_n), "keys": sorted(m)})
    out["sac"] = sac
    algo.stop()

    cfg = (rllib.MultiAgentPPOConfig()
           .environment("MultiAgentCartPole", num_agents=2)
           .multi_agent(policies=["p0", "p1"],
                        policy_mapping_fn=lambda a: "p" + a[-1])
           .env_runners(num_env_runners=2, rollout_fragment_length=64)
           .training(num_epochs=2, minibatch_size=32))
    algo = build("multi_agent", cfg, lambda a: {
        pid: ln.get_weights() for pid, ln in a.learners.items()})
    ma = []
    for _ in range(2):
        m = algo.train()
        ma.append({**{k: m.get(k) for k in common},
                   "policies": {pid: {k: v for k, v in pm.items()
                                      if k in losses}
                                for pid, pm in m["policies"].items()}})
    out["multi_agent"] = ma
    algo.stop()
    rt.shutdown()
    return out


# ------------------------------------------------------------------ driver


def run(names, pkg: str, env=None):
    """Start the scenarios ``names`` under ``pkg`` in one subprocess;
    returns the ``Popen`` (read it with ``result``).  ``env`` adds
    variables to this process's environment; a value of None removes
    one."""
    import subprocess

    full = dict(os.environ)
    # A scenario starts its own cluster: an address this process holds
    # (its own cluster, while one is up) must not send it to that one.
    for k in ("RT_ADDRESS", "RT_TORCH_ADDRESS"):
        full.pop(k, None)
    for k, v in (env or {}).items():
        if v is None:
            full.pop(k, None)
        else:
            full[k] = v
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    full["PYTHONPATH"] = os.pathsep.join(
        [root, here, full.get("PYTHONPATH", "")])
    # One intra-op thread in the cluster's processes: the models are tiny,
    # and the suite runs several such clusters beside other tests.
    full.setdefault("OMP_NUM_THREADS", "1")
    full.setdefault("MKL_NUM_THREADS", "1")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pkg", pkg, *names],
        cwd=root, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def run_pair(names, env=None, jax_env=None, port_env=None,
             timeout: float = 300.0):
    """The scenarios under both packages at once (two clusters on one
    host), one process each: ``(ray_tpu results, ray_tpu_torch
    results)``, each ``{scenario: result}``."""
    jp = run(names, "ray_tpu", dict(env or {}, **(jax_env or {})))
    tp = run(names, "ray_tpu_torch", dict(env or {}, **(port_env or {})))
    return result(jp, timeout), result(tp, timeout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", required=True, choices=("ray_tpu",
                                                     "ray_tpu_torch"))
    ap.add_argument("names", nargs="+", choices=sorted(SCENARIOS))
    args = ap.parse_args(argv)
    rt = importlib.import_module(args.pkg)
    out = {name: SCENARIOS[name](rt) for name in args.names}
    print("SCENARIO_RESULT " + json.dumps(out, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()
