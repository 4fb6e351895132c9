"""CPU parity of the port's ``ring_attention`` with the JAX package's.

Four spawned gloo ranks run the port's ring over sp = 4 (one spawn for
every case, ``_torch_ranks.ring``), each on its chunk of the sequence, on
the plain versions of kernels K1-K3.  The JAX side runs its own
``ring_attention`` inside ``shard_map`` over four virtual CPU devices, as
``tests/test_ops.py`` does: at S_local 64 its blockwise path, at S_local
256 (``force_kernel=True, interpret=True``) its fused Pallas path.  The
gradients (loss sum(out * dO)) are held to ``jax.grad`` of the JAX
package's full attention, ``mha_reference`` (the JAX ring's own gradient
tests are slow and stay out of tier-1).  fp32 throughout; the ring merges
four chunks' (out, lse) and sums four chunks' gradients, so it agrees to
fp32 rounding: atol 2e-5 on values of order 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import _torch_ranks
from ray_tpu.ops.attention import mha_reference
from ray_tpu.ops.ring_attention import ring_attention as jax_ring
from ray_tpu.parallel.pipeline import shard_map

# name -> (S global, causal, H, Hkv, D, JAX's fused Pallas path)
_CASES = {
    "causal_gqa": (256, True, 4, 2, 32, False),
    "causal_mha": (256, True, 4, 4, 32, False),
    "noncausal_gqa": (256, False, 4, 2, 32, False),
    "causal_gqa_fused": (1024, True, 2, 1, 32, True),
}
_TOL = dict(atol=2e-5, rtol=1e-5)


def _inputs(name):
    S, causal, H, Hkv, D, _ = _CASES[name]
    r = np.random.default_rng(sorted(_CASES).index(name))
    q = r.standard_normal((1, H, S, D)).astype(np.float32)
    k = r.standard_normal((1, Hkv, S, D)).astype(np.float32)
    v = r.standard_normal((1, Hkv, S, D)).astype(np.float32)
    do = r.standard_normal((1, H, S, D)).astype(np.float32)
    return q, k, v, do, causal


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    names = sorted(_CASES)
    out = _torch_ranks.run(_torch_ranks.ring, 4,
                           [_inputs(n) for n in names],
                           tmp=tmp_path_factory.mktemp("ring"))
    return {n: [rank[i] for rank in out] for i, n in enumerate(names)}


def _chunks(a):
    return np.split(np.asarray(a), 4, axis=2)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_ring_forward_matches_jax_ring(ring_runs, name):
    q, k, v, _, causal = _inputs(name)
    fused = _CASES[name][5]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 1, 1, 4),
                ("dp", "fsdp", "tp", "sp"))
    ring = shard_map(
        functools.partial(jax_ring, axis_name="sp", causal=causal,
                          force_kernel=fused, interpret=fused),
        mesh=mesh, in_specs=(JP(None, None, "sp", None),) * 3,
        out_specs=JP(None, None, "sp", None), check_vma=False)
    want = _chunks(ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    for rank, got in enumerate(ring_runs[name]):
        np.testing.assert_allclose(got[0], want[rank], **_TOL)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_ring_gradients_match_full_attention(ring_runs, name):
    """dQ, dK and dV of each rank's chunk equal the chunk of the full
    attention's gradients: K/V accumulators came home."""
    q, k, v, do, causal = _inputs(name)

    def loss(q, k, v):
        return jnp.sum(mha_reference(q, k, v, causal=causal) * do)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [_chunks(g) for g in grads]
    for rank, got in enumerate(ring_runs[name]):
        for i, tag in enumerate(("dq", "dk", "dv")):
            np.testing.assert_allclose(got[1 + i], want[i][rank],
                                       err_msg=tag, **_TOL)
