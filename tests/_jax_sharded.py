"""The JAX side and the checks shared by the sharded-step parity tests
(``test_torch_sharded.py``, ``test_torch_sharded_moe.py``).

A case is (model, mesh sizes, sp_shard_seq, JAX side sharded): the port's
sharded step runs on four spawned gloo ranks (``_torch_ranks.sharded``,
one spawn for every case of a file); the JAX side is the JAX package's
sharded step on the same mesh over four virtual devices, or its unsharded
step.  Both start from the JAX package's init weights in fp32.

Tolerances: gradients atol 2e-6 / rtol 1e-4 (fp32 summation order, values
up to ~1e-1); loss and grad norm rtol 1e-5; parameters after two AdamW
steps at lr 1e-3 atol 1e-4 / rtol 1e-4 (the unsharded MoE test's bound,
``test_torch_moe.py``), except on elements whose first-step gradient is
nonzero and below 1e-6 in magnitude (under 1 % of them, checked; an
embedding row no token reads has an exact 0 on both sides): Adam moves
such an element by lr g / (|g| + 1e-8), which fp32 summation noise of
order 1e-9 in g can set anywhere in [-lr, lr], so there the bound is
Adam's own, 2 lr a step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_ranks
from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import MoEConfig as JaxMoEConfig
from ray_tpu.models import TrainState as JaxTrainState
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.models import llama_loss as jax_llama_loss
from ray_tpu.models import llama_sharding_rules as jax_llama_rules
from ray_tpu.models import lora_init as jax_lora_init
from ray_tpu.models import lora_sharding_rules as jax_lora_rules
from ray_tpu.models import make_train_step as jax_make_train_step
from ray_tpu.models import moe_init as jax_moe_init
from ray_tpu.models import moe_loss as jax_moe_loss
from ray_tpu.models import moe_sharding_rules as jax_moe_rules
from ray_tpu.models.train_state import default_optimizer as jax_optimizer
from ray_tpu.models.train_state import shard_train_state as jax_shard_state
from ray_tpu.parallel import MeshConfig as JaxMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel import set_mesh as jax_set_mesh

MESH_AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")
LR, STEPS = 1e-3, 2


def model(kind):
    """(JAX config, the trained weights, ``loss(config, weights, tokens,
    targets)``) of the tiny model; for "lora", the weights are adapters
    (B drawn at random, so every adapter has a gradient) over a frozen
    base model."""
    if kind == "moe":
        jc = JaxMoEConfig.tiny(dtype=jnp.float32)
        return jc, jax_moe_init(jc, jax.random.PRNGKey(0)), jax_moe_loss
    jc = dataclasses.replace(JaxConfig.tiny(dtype=jnp.float32), loss_chunk=8,
                             sp_ring=True)
    params = jax_llama_init(jc, jax.random.PRNGKey(0))
    if kind == "llama":
        return jc, params, jax_llama_loss
    lora = jax_lora_init(jc, jax.random.PRNGKey(1), rank=4)
    keys = iter(jax.random.split(jax.random.PRNGKey(2), 2 * jc.n_layers))
    for layer in lora["layers"]:
        for name in ("wq_lora_b", "wv_lora_b"):
            layer[name] = 0.05 * jax.random.normal(next(keys),
                                                   layer[name].shape)

    def loss(config, p, tokens, targets):
        return jax_llama_loss(config, params, tokens, targets, p)

    return jc, (params, lora), loss


def batch(seed=1):
    r = np.random.default_rng(seed)
    toks = r.integers(0, 512, (4, 32)).astype(np.int32)
    tgt = np.roll(toks, -1, axis=1)
    tgt[r.integers(0, 4, 3), r.integers(0, 32, 3)] = -100
    return {"tokens": toks, "targets": tgt}


def run_port(cases, tmp):
    """{name: [each rank's result]} of the port's sharded steps."""
    args = []
    for name in sorted(cases):
        kind, mesh, seq, _ = cases[name]
        jc, params, _ = model(kind)
        kw = {**{f.name: getattr(jc, f.name)
                 for f in dataclasses.fields(jc)}, "dtype": torch.float32}
        args.append((kind, kw, jax.tree.map(np.asarray, params), mesh, seq,
                     batch(), LR, STEPS))
    out = _torch_ranks.run(_torch_ranks.sharded, 4, args, tmp=tmp)
    return {n: [rank[i] for rank in out] for i, n in enumerate(sorted(cases))}


def jax_side(case):
    """(first-step grads, per-step (loss, grad norm), params after the
    last step) of the JAX package."""
    kind, mesh_kw, _, sharded = case
    jc, params, loss = model(kind)
    if kind == "lora":
        params = params[1]
    b = {k: jnp.asarray(v) for k, v in batch().items()}

    def loss_fn(p, b):
        return loss(jc, p, b["tokens"], b["targets"])

    grads = jax.grad(loss_fn)(params, b)
    tx = jax_optimizer(lr=LR)
    state = JaxTrainState.create(jax.tree.map(jnp.copy, params), tx)
    metrics = []
    if sharded:
        mesh = jax_make_mesh(JaxMeshConfig(**mesh_kw),
                             devices=jax.devices()[:4])
        rules = jax_llama_rules() if kind == "llama" else jax_moe_rules()
        state = jax_shard_state(state, mesh, rules)
        step = jax_make_train_step(loss_fn, tx, mesh, rules)
        with jax_set_mesh(mesh):
            for _ in range(STEPS):
                state, m = step(state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
    else:
        step = jax_make_train_step(loss_fn, tx)
        for _ in range(STEPS):
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return grads, metrics, state.params


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[int(key)] if key.isdigit() else tree[key]
    return np.asarray(tree)


def _axes(entry):
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _block(full, spec, mesh_kw, rank):
    """Rank ``rank``'s block of ``full`` under ``spec`` on the mesh: each
    dim split evenly over its axes, the first outermost (NamedSharding's
    layout), ranks in row-major mesh order."""
    sizes = [mesh_kw.get(a, 1) for a in MESH_AXES]
    coord = dict(zip(MESH_AXES, np.unravel_index(rank, sizes)))
    index = []
    for dim in range(full.ndim):
        i, n = 0, 1
        for a in _axes(spec[dim] if dim < len(spec) else None):
            i, n = i * mesh_kw.get(a, 1) + coord[a], n * mesh_kw.get(a, 1)
        step = full.shape[dim] // n
        index.append(slice(i * step, (i + 1) * step))
    return full[tuple(index)]


def check_first_step_grads(runs, side, mesh_kw):
    """Every parameter's gradient, summed over the data axes, on each
    rank's shard."""
    grads = side[0]
    for rank, res in enumerate(runs):
        assert len(res["grads"]) == len(jax.tree.leaves(grads))
        for pname, g in res["grads"].items():
            spec = res["params"][pname][1]
            want = _block(_leaf(grads, pname), spec, mesh_kw, rank)
            np.testing.assert_allclose(g, want, atol=2e-6, rtol=1e-4,
                                       err_msg=f"{pname} rank {rank}")


def check_two_steps(runs, side, mesh_kw):
    """Each step's loss and global grad norm, then every parameter."""
    grads, metrics, params = side
    near_eps = total = 0
    for rank, res in enumerate(runs):
        np.testing.assert_allclose(res["metrics"], metrics, rtol=1e-5)
        for pname, (p, spec, _) in res["params"].items():
            want = _block(_leaf(params, pname), spec, mesh_kw, rank)
            g = np.abs(_block(_leaf(grads, pname), spec, mesh_kw, rank))
            tiny = (g > 0) & (g < 1e-6)  # an exact 0 stays 0 on both
            atol = np.where(tiny, 2 * STEPS * LR, 1e-4)
            bad = np.abs(p - want) > atol + 1e-4 * np.abs(want)
            assert not bad.any(), (
                f"{pname} rank {rank}: {int(bad.sum())} elements, "
                f"worst {np.abs(p - want)[bad].max()}")
            near_eps, total = near_eps + int(tiny.sum()), total + tiny.size
    assert near_eps < 0.01 * total


def check_local_shards(runs, mesh_kw, kind):
    """The rules' placements: every parameter carries the JAX rule's spec,
    and a sharded one's local shape is its global shape divided over its
    axes; nothing is all-gathered onto every rank."""
    rules = {"moe": jax_moe_rules, "llama": jax_llama_rules,
             "lora": jax_lora_rules}[kind]()
    for res in runs:
        split = 0
        for pname, (p, spec, shape) in res["params"].items():
            path = pname.replace(".", "/")
            assert spec == tuple(rules.spec_for(path, len(shape))), pname
            n = np.prod([mesh_kw.get(a, 1) for e in spec for a in _axes(e)])
            assert p.size * n == np.prod(shape), pname
            split += n > 1
        assert split > 0 or kind == "lora"  # adapters are replicated
