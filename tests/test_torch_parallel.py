"""CPU parity of the port's parallel layer with the JAX package: mesh
shapes, sharding rules and placements, the named-axis collectives and
their gradients, and the process-group bootstrap.

The collectives run on four spawned gloo ranks (``_torch_ranks``, one
spawn for every case); the JAX side runs the same ops under ``shard_map``
over four of the eight virtual CPU devices.  Inputs are seeded numpy,
fp32; sums over four ranks agree to fp32 rounding (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_ranks
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.models import llama_sharding_rules as jax_llama_rules
from ray_tpu.models import lora_init as jax_lora_init
from ray_tpu.models import lora_sharding_rules as jax_lora_rules
from ray_tpu.models import moe_init as jax_moe_init
from ray_tpu.models import moe_sharding_rules as jax_moe_rules
from ray_tpu.models.llama import LlamaConfig as JaxConfig
from ray_tpu.models.moe import MoEConfig as JaxMoEConfig
from ray_tpu.parallel import MeshConfig as JaxMeshConfig
from ray_tpu.parallel.pipeline import shard_map
from ray_tpu.parallel.sharding import _path_str
from ray_tpu_torch.models import (LlamaConfig, MoEConfig,
                                  llama_sharding_rules, lora_from_jax,
                                  lora_sharding_rules, moe_params_from_jax,
                                  moe_sharding_rules, params_from_jax)
from ray_tpu_torch.parallel import (MeshConfig, P, initialize_process_group,
                                    make_mesh, spawn_ranks)

_TOL = dict(atol=1e-5, rtol=1e-6)

# ------------------------------------------------------------- mesh shapes

_RESOLVE = [
    (dict(), 8),
    (dict(fsdp=2, tp=2), 4),
    (dict(dp=2, fsdp=1, sp=-1), 8),
    (dict(fsdp=1, pp=4, dp=-1), 4),
    (dict(fsdp=-1, tp=-1), 8),       # two wildcards
    (dict(tp=3), 8),                 # 8 not divisible by 3
    (dict(fsdp=2, tp=2), 8),         # covers 4 of 8
]


@pytest.mark.parametrize("kw,n", _RESOLVE)
def test_mesh_config_resolve_matches_jax(kw, n):
    """Same sizes, or the same error word for word."""
    def outcome(cls):
        try:
            return cls(**kw).resolve(n)
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(MeshConfig) == outcome(JaxMeshConfig)


# ---------------------------------------------------------- sharding rules


def _jax_paths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(path): np.ndim(x) for path, x in leaves}


def _trees():
    jc = JaxConfig.tiny(dtype=jnp.float32)
    mc = JaxMoEConfig.tiny(dtype=jnp.float32)
    llama = jax_llama_init(jc, jax.random.PRNGKey(0))
    lora = jax_lora_init(jc, jax.random.PRNGKey(1), rank=4)
    moe = jax_moe_init(mc, jax.random.PRNGKey(2))
    tc = LlamaConfig.tiny(dtype=torch.float32)
    mtc = MoEConfig.tiny(dtype=torch.float32)

    def np_(t):
        return jax.tree.map(np.asarray, t)

    return {
        "llama": (llama, jax_llama_rules(), llama_sharding_rules(),
                  params_from_jax(tc, np_(llama), device="cpu")),
        "lora": (lora, jax_lora_rules(), lora_sharding_rules(),
                 lora_from_jax(tc, np_(lora), device="cpu")),
        "moe": (moe, jax_moe_rules(), moe_sharding_rules(),
                moe_params_from_jax(mtc, np_(moe), device="cpu")),
    }


@pytest.mark.parametrize("name", ["llama", "lora", "moe"])
def test_spec_for_matches_jax_on_every_path(name):
    """The port's rules give the JAX rules' spec on every path of the JAX
    tree, and the port's parameter names are exactly those paths."""
    tree, jax_rules, rules, module = _trees()[name]
    paths = _jax_paths(tree)
    ours = {n.replace(".", "/"): p.ndim for n, p in module.named_parameters()}
    assert ours == paths
    for path, ndim in paths.items():
        want = tuple(jax_rules.spec_for(path, ndim))
        assert tuple(rules.spec_for(path, ndim)) == want, path


def test_p_clips_and_reads_like_a_partition_spec():
    rules = llama_sharding_rules()
    assert rules.spec_for("layers/0/attn_norm", 1) == P()
    assert rules.spec_for("embed", 1) == P("tp")       # clipped to ndim
    assert P(("dp", "fsdp"), None)[0] == ("dp", "fsdp")
    assert tuple(P("fsdp", "tp")) == tuple(JP("fsdp", "tp"))


# ------------------------------------------------------------ collectives


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    r = np.random.default_rng(0)
    x = r.standard_normal((4, 4, 3)).astype(np.float32)
    c = r.standard_normal((4, 4, 3)).astype(np.float32)
    shared = r.standard_normal((4, 3)).astype(np.float32)
    placed = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    out = _torch_ranks.run(_torch_ranks.collectives, 4, x, c, shared, placed,
                           tmp=tmp_path_factory.mktemp("collectives"))
    return x, c, shared, placed, out


def _mesh1d():
    return Mesh(np.array(jax.devices()[:4]), ("sp",))


def _per_rank(fn, x, out_specs=JP("sp"), in_specs=JP("sp")):
    """``fn`` under shard_map over the 4 devices; each rank's block."""
    f = shard_map(fn, mesh=_mesh1d(), in_specs=in_specs, out_specs=out_specs,
                  check_vma=False)
    return f


def _vjp_blocks(fn, x, cot, out_specs=JP("sp"), in_specs=JP("sp")):
    """(output blocks, input-gradient blocks) of shard_map(fn) for per-rank
    inputs x[r] and cotangents cot[r]."""
    f = _per_rank(fn, x, out_specs, in_specs)
    xs = jnp.concatenate(list(x)) if in_specs == JP("sp") else x
    y, vjp = jax.vjp(f, xs)
    (g,) = vjp(jnp.concatenate(list(cot)) if out_specs == JP("sp")
               else cot)
    if out_specs == JP("sp"):
        y = np.split(np.asarray(y), 4)
    if in_specs == JP("sp"):
        g = np.split(np.asarray(g), 4)
    return y, g


def test_axis_index_size_and_unbound_axis(collective_runs):
    *_, out = collective_runs
    for rank, res in enumerate(out):
        assert res["axis"] == (rank, 4, 4)
        assert "nope" in res["unbound"]
        assert res["index_2d"] == rank
    # Outside a mesh the JAX axis is unbound too.
    with pytest.raises(NameError):
        from ray_tpu_torch.collective import mesh_ops
        mesh_ops.axis_size("sp")


def test_allreduce_sum_and_its_gradient(collective_runs):
    """psum with a replicated output: every rank's gradient is the one
    cotangent as it is (JAX's transpose)."""
    x, c, *_, out = collective_runs
    y, g = _vjp_blocks(lambda a: jax.lax.psum(a, "sp"), x, c[0],
                       out_specs=JP())
    for rank, res in enumerate(out):
        np.testing.assert_allclose(res["allreduce"][0], np.asarray(y), **_TOL)
        np.testing.assert_allclose(res["allreduce"][1], g[rank], **_TOL)


@pytest.mark.parametrize("op", ["mean", "max", "min"])
def test_allreduce_other_ops(collective_runs, op):
    x, *_, out = collective_runs
    want = {"mean": x.mean(0), "max": x.max(0), "min": x.min(0)}[op]
    for res in out:
        np.testing.assert_allclose(res[op], want, **_TOL)


def test_pvary_sums_the_gradient(collective_runs):
    """JAX's pvary: identity forward, gradient summed over the axis."""
    x, c, shared, *_, out = collective_runs
    f = shard_map(lambda a: jax.lax.pcast(a, "sp", to="varying")
                  * (jax.lax.axis_index("sp") + 1),
                  mesh=_mesh1d(), in_specs=JP(), out_specs=JP("sp"),
                  check_vma=True)
    y, vjp = jax.vjp(f, jnp.asarray(shared))
    (g,) = vjp(jnp.concatenate(list(c)))
    for rank, res in enumerate(out):
        np.testing.assert_allclose(res["pvary"][0],
                                   np.split(np.asarray(y), 4)[rank], **_TOL)
        np.testing.assert_allclose(res["pvary"][1], np.asarray(g), **_TOL)


_LINEAR = {
    "allgather": (lambda a: jax.lax.all_gather(a, "sp", axis=1, tiled=True),
                  lambda c, r: np.concatenate([c[r]] * 4, axis=1) + r),
    "allgather_stacked": (lambda a: jax.lax.all_gather(a, "sp")[None],
                          lambda c, r: np.stack([c[r]] * 4)[None] * (r + 1)),
    "reducescatter": (lambda a: jax.lax.psum_scatter(a, "sp", tiled=True),
                      lambda c, r: c[r][:1]),
    "ppermute": (lambda a: jax.lax.ppermute(a, "sp",
                                            [(0, 1), (1, 2), (2, 3)]),
                 lambda c, r: c[r]),
    "shift": (lambda a: jax.lax.ppermute(a, "sp",
                                         [(i, (i - 1) % 4) for i in range(4)]),
              lambda c, r: c[r]),
    "all_to_all": (lambda a: jax.lax.all_to_all(a, "sp", 0, 1, tiled=True),
                   lambda c, r: np.concatenate([c[r][:1]] * 4, axis=1)),
}


@pytest.mark.parametrize("name", sorted(_LINEAR))
def test_linear_collective_and_its_transpose(collective_runs, name):
    """Forward blocks and input gradients against jax.vjp of the same op
    under shard_map (the transposes: reduce-scatter, all-gather, the
    reverse permutation, the swapped all-to-all)."""
    x, c, *_, out = collective_runs
    fn, cot = _LINEAR[name]
    cots = np.stack([cot(c, r) for r in range(4)]).astype(np.float32)
    y, g = _vjp_blocks(fn, x, cots)
    for rank, res in enumerate(out):
        got_y, got_g = res[name]
        np.testing.assert_allclose(got_y, y[rank].reshape(got_y.shape),
                                   **_TOL)
        np.testing.assert_allclose(got_g, g[rank], **_TOL)


def test_broadcast_and_two_axis_collectives(collective_runs):
    x, *_, out = collective_runs
    mesh2 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("fsdp", "tp"))
    ag = shard_map(lambda a: jax.lax.all_gather(a, ("fsdp", "tp"), tiled=True),
                   mesh=mesh2, in_specs=JP(("fsdp", "tp")),
                   out_specs=JP(("fsdp", "tp")), check_vma=False)
    gathered = np.split(np.asarray(ag(jnp.concatenate(list(x)))), 4)
    for rank, res in enumerate(out):
        np.testing.assert_allclose(res["broadcast"], x[2], **_TOL)
        np.testing.assert_allclose(res["allreduce_2d"], x.sum(0), **_TOL)
        np.testing.assert_allclose(res["allgather_2d"], gathered[rank],
                                   **_TOL)


@pytest.mark.parametrize("key,spec", [("a", ("fsdp", "tp")),
                                      ("b", (("fsdp", "tp"),)),
                                      ("c", (None, "tp"))])
def test_placements_hold_jax_shards(collective_runs, key, spec):
    """A tensor placed by a spec holds on rank r the block JAX's
    NamedSharding puts on device r of the same mesh."""
    *_, placed, out = collective_runs
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("fsdp", "tp"))
    arr = jax.device_put(jnp.asarray(placed), NamedSharding(mesh, JP(*spec)))
    by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    for rank, res in enumerate(out):
        got, got_spec = res["placed"][key]
        np.testing.assert_array_equal(got, by_device[jax.devices()[rank]])
        assert got_spec == spec


# ------------------------------------------------------------ distributed


def test_initialize_process_group_world_one_and_no_address():
    import torch.distributed as dist

    initialize_process_group(1, 0)   # a no-op
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a cluster connection"):
        initialize_process_group(2, 0)


def test_spawn_ranks_fails_with_the_rank_and_kills_on_time(tmp_path):
    """A rank that raises fails the call with its traceback; ranks past the
    time limit are killed and the call raises."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*on purpose"):
        spawn_ranks(_torch_ranks.fail_on, 2, 1, store=str(tmp_path / "a"),
                    timeout_s=120)
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn_ranks(_torch_ranks.hang, 2, store=str(tmp_path / "b"),
                    timeout_s=15)


def test_make_mesh_must_cover_the_world():
    """One process and no group: a mesh of more than one position is
    refused before any group is made."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="does not cover 1 devices"):
        make_mesh(MeshConfig(fsdp=1, tp=2), device="cpu")
    assert not dist.is_initialized()
