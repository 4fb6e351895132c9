"""The rank side of the port's multi-rank CPU tests.

The test files spawn gloo ranks on the CPU (``spawn_ranks``, a FileStore
under the test's tmp path); each rank runs one function of this module,
which imports torch, numpy and the port only, never JAX or the JAX
package.  Inputs arrive as numpy arrays; results go back as numpy arrays,
with the names of any forbidden module a rank imported.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

_FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


def _imported():
    return sorted(m for m in sys.modules if m.split(".")[0] in _FORBIDDEN)


def run(fn, world: int, *args, tmp, timeout_s: float = 180.0):
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks; checks that no
    rank imported JAX or the JAX package, and returns their results.  The
    spawn and a file's cases take 5-30 s alone; the limit leaves room for
    a loaded test run, and a hung rank fails its test, not the run."""
    from ray_tpu_torch.parallel import spawn_ranks

    out = spawn_ranks(_checked, world, fn, *args,
                      store=os.path.join(str(tmp), "store"),
                      timeout_s=timeout_s)
    bad = [imp for _, imp in out if imp]
    assert not bad, f"a rank imported {bad}"
    return [res for res, _ in out]


def _checked(rank, fn, *args):
    # One thread a rank: the tests' models are tiny, and the ranks share
    # the machine with the rest of a parallel test run.
    torch.set_num_threads(1)
    torch.manual_seed(0)
    res = fn(rank, *args)
    return res, _imported()


def _np(t: torch.Tensor) -> np.ndarray:
    from ray_tpu_torch.parallel.sharding import local

    return local(t).detach().numpy().copy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ collectives


def collectives(rank: int, x: np.ndarray, c: np.ndarray, shared: np.ndarray,
                placed: np.ndarray):
    """Every named-axis collective over ``sp`` of a 1 x 4 mesh (rank r's
    input ``x[r]``, cotangent ``c[r]``), two over the (fsdp, tp) axes of a
    2 x 2 mesh, and ``placed`` put on the 2 x 2 mesh by three specs."""
    from ray_tpu_torch.collective import mesh_ops as ops
    from ray_tpu_torch.parallel import (MeshConfig, P, make_mesh,
                                        process_group_barrier, set_mesh,
                                        shard_pytree, spec_of)

    out = {}

    def grad_of(name, fn, inp, cot):
        a = _t(inp).requires_grad_()
        y = fn(a)
        y.backward(_t(cot))
        out[name] = (_np(y), _np(a.grad))

    ring = make_mesh(MeshConfig(fsdp=1, sp=4), device="cpu")
    with set_mesh(ring):
        out["axis"] = (ops.axis_index("sp"), ops.axis_size("sp"),
                       ops.axis_size(("sp", "tp")))
        try:
            ops.axis_size("nope")
            out["unbound"] = None
        except NameError as e:
            out["unbound"] = str(e)
        xr, cr = x[rank], c[rank]
        # The sum's output is one value on every rank: cotangent c[0].
        grad_of("allreduce", lambda a: ops.allreduce(a, "sp"), xr, c[0])
        for op in ("mean", "max", "min"):
            out[op] = _np(ops.allreduce(_t(xr), "sp", op))
        grad_of("pvary", lambda a: ops.pvary(a, "sp") * (rank + 1), shared,
                cr)
        g = np.concatenate([cr] * 4, axis=1)
        grad_of("allgather", lambda a: ops.allgather(a, "sp", gather_axis=1),
                xr, g + rank)
        grad_of("allgather_stacked",
                lambda a: ops.allgather(a, "sp", tiled=False), xr,
                np.stack([cr] * 4) * (rank + 1))
        grad_of("reducescatter", lambda a: ops.reducescatter(a, "sp"), xr,
                cr[:1])
        grad_of("ppermute", lambda a: ops.ppermute(
            a, "sp", [(0, 1), (1, 2), (2, 3)]), xr, cr)
        grad_of("shift", lambda a: ops.shift(a, "sp", -1), xr, cr)
        grad_of("all_to_all", lambda a: ops.all_to_all(a, "sp", 0, 1), xr,
                np.concatenate([cr[:1]] * 4, axis=1))
        out["broadcast"] = _np(ops.broadcast(_t(xr), "sp", root=2))
        process_group_barrier()
    square = make_mesh(MeshConfig(fsdp=2, tp=2), device="cpu")
    with set_mesh(square):
        out["allreduce_2d"] = _np(ops.allreduce(_t(x[rank]), ("fsdp", "tp")))
        out["allgather_2d"] = _np(ops.allgather(_t(x[rank]), ("fsdp", "tp")))
        out["index_2d"] = ops.axis_index(("fsdp", "tp"))
    specs = {"a": P("fsdp", "tp"), "b": P(("fsdp", "tp")),
             "c": P(None, "tp")}
    placed_t = shard_pytree({k: _t(placed) for k in specs}, square, specs)
    out["placed"] = {k: (_np(v), tuple(spec_of(v)))
                     for k, v in placed_t.items()}
    return out


def fail_on(rank: int, bad: int):
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def hang(rank: int):
    import time

    time.sleep(600)


# ------------------------------------------------------------------ ring


def ring(rank: int, cases):
    """``ring_attention`` over sp = 4: each case's (out, dq, dk, dv) on this
    rank's chunk of the sequence, for the loss sum(out * do)."""
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.parallel import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(fsdp=1, sp=4), device="cpu")
    res = []
    for q, k, v, do, causal in cases:
        n = q.shape[2] // 4
        rows = slice(rank * n, (rank + 1) * n)
        q, k, v = (_t(t[:, :, rows]).requires_grad_() for t in (q, k, v))
        out = ring_attention(q, k, v, axis_name="sp", causal=causal,
                             mesh=mesh)
        out.backward(_t(do[:, :, rows]))
        res.append(tuple(_np(t) for t in (out, q.grad, k.grad, v.grad)))
    return res


# -------------------------------------------------------------- pipeline


def pipeline(rank: int, cfg_kw, tree, tokens, targets, n_micro, pps):
    """``make_pp_loss`` for each pp in ``pps`` (fsdp the rest of the 4
    ranks): the loss and the gradient of every stacked tensor this rank
    holds (its stage's layers, by global layer index)."""
    from ray_tpu_torch.models import LlamaConfig, params_from_jax
    from ray_tpu_torch.parallel import (MeshConfig, make_mesh, make_pp_loss,
                                        pp_sharding_spec, shard_pytree,
                                        stack_layers)

    cfg = LlamaConfig(**cfg_kw)
    res = {}
    for pp in pps:
        mesh = make_mesh(MeshConfig(fsdp=4 // pp, pp=pp), device="cpu")
        model = params_from_jax(cfg, tree, device="cpu", trainable=True)
        stacked = stack_layers(model)
        stacked = shard_pytree(stacked, mesh, pp_sharding_spec(stacked))
        loss = make_pp_loss(cfg, mesh, n_micro=n_micro)(
            stacked, _t(tokens).long(), _t(targets).long())
        loss.backward()
        per = cfg.n_layers // pp
        first = mesh.get_local_rank("pp") * per
        grads = {}

        def walk(node, path):
            if isinstance(node, dict):
                for key, val in node.items():
                    walk(val, path + [key])
                return
            g = _np(node.grad)
            if path[0] == "layers":
                for i in range(per):
                    grads[".".join(["layers", str(first + i)] + path[1:])] \
                        = g[i]
            else:
                grads[".".join(path)] = g

        walk(stacked, [])
        res[pp] = (float(loss.detach()), grads)
    return res


# --------------------------------------------------------- sharded steps


def sharded(rank: int, cases):
    """Sharded ``make_train_step`` runs: for each case (model, mesh,
    sp_shard_seq, steps), the first step's gradient of every parameter and
    every parameter after the last step (local shards with their specs),
    each step's loss and grad norm, on a fresh state.  A "lora" case
    trains the adapters of ``tree = (base, adapters)`` over the base model
    placed by the Llama rules."""
    from ray_tpu_torch.models import (LlamaConfig, MoEConfig, TrainState,
                                      default_optimizer, llama_loss,
                                      llama_sharding_rules, lora_from_jax,
                                      lora_sharding_rules, make_train_step,
                                      moe_loss, moe_params_from_jax,
                                      moe_sharding_rules, params_from_jax,
                                      shard_train_state)
    from ray_tpu_torch.parallel import (MeshConfig, batch_spec, make_mesh,
                                        shard_module, shard_pytree, spec_of)

    res = []
    for kind, cfg_kw, tree, mesh_kw, sp_shard_seq, batch, lr, steps in cases:
        mesh = make_mesh(MeshConfig(**mesh_kw), device="cpu")
        batch = {k: _t(v).long() for k, v in batch.items()}
        if kind == "moe":
            cfg = MoEConfig(**cfg_kw)
            params = moe_params_from_jax(cfg, tree, device="cpu",
                                         trainable=True)
            rules = moe_sharding_rules()

            def loss_fn(p, b, cfg=cfg):
                return moe_loss(cfg, p, b["tokens"], b["targets"])
        elif kind == "lora":
            cfg = LlamaConfig(**cfg_kw)
            base = shard_module(params_from_jax(cfg, tree[0], device="cpu"),
                                mesh, llama_sharding_rules())
            params = lora_from_jax(cfg, tree[1], device="cpu")
            rules = lora_sharding_rules()

            def loss_fn(p, b, cfg=cfg, base=base):
                return llama_loss(cfg, base, b["tokens"], b["targets"], p)
        else:
            cfg = LlamaConfig(**cfg_kw)
            params = params_from_jax(cfg, tree, device="cpu", trainable=True)
            rules = llama_sharding_rules()

            def loss_fn(p, b, cfg=cfg):
                return llama_loss(cfg, p, b["tokens"], b["targets"])
        tx = default_optimizer(lr=lr)
        state = shard_train_state(TrainState.create(params, tx), mesh, rules)
        spec = batch_spec(sp_shard_seq)
        loss_fn(state.params, shard_pytree(
            batch, mesh, {k: spec for k in batch})).backward()
        grads = {n: _np(p.grad) for n, p in state.params.named_parameters()}
        state.opt_state.zero_grad(set_to_none=True)
        step = make_train_step(loss_fn, tx, mesh, rules,
                               sp_shard_seq=sp_shard_seq)
        metrics = []
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        params = {n: (_np(p), tuple(spec_of(p)), tuple(p.shape))
                  for n, p in state.params.named_parameters()}
        res.append({"grads": grads, "params": params, "metrics": metrics})
    return res


# --------------------------------------------------------- rllib learners


def rllib_mesh(rank: int, cases):
    """The rllib learners' ``mesh=`` updates at dp 2: PPO's
    ``update_from_batch``, DQN's and IMPALA's updates, each from the JAX
    learner's weights (field lists of numpy arrays); returns each one's
    last metrics and parameters, and whether a minibatch that does not
    divide over the ranks raised ``ValueError``."""
    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.rllib import (DQNLearner, ImpalaLearner, PPOLearner,
                                     policy_params_from_jax,
                                     q_params_from_jax)

    mesh = make_mesh(MeshConfig(dp=2, fsdp=1), device="cpu")
    out = {}

    def state(params):
        return {k: v.detach().numpy().copy()
                for k, v in params.state_dict().items()}

    c = cases["ppo"]
    ppo = PPOLearner(4, 2, mesh=mesh, device="cpu")
    ppo.set_weights(c["weights"])
    m = ppo.update_from_batch(c["batch"], **c["kw"])
    try:
        ppo.update_from_batch(c["batch"], num_epochs=1, minibatch_size=15)
        uneven = False
    except ValueError:
        uneven = True
    out["ppo"] = (m, state(ppo.params), uneven)

    c = cases["dqn"]
    dqn = DQNLearner(4, 2, mesh=mesh, device="cpu", **c["kw"])
    q0 = q_params_from_jax(c["weights"], "cpu").state_dict()
    dqn.params.load_state_dict(q0)
    dqn.target_params.load_state_dict(q0)
    ms = [dqn.update_from_batch(b) for b in c["batches"]]
    out["dqn"] = (ms[-1], state(dqn.params))

    c = cases["impala"]
    imp = ImpalaLearner(4, 2, mesh=mesh, device="cpu")
    imp.params.load_state_dict(
        policy_params_from_jax(c["weights"], "cpu").state_dict())
    ms = [imp.update_from_fragments(f) for f in c["fragments"]]
    out["impala"] = (ms[-1], state(imp.params))
    return out


__all__ = ["run", "collectives", "ring", "pipeline", "sharded",
           "rllib_mesh"]
