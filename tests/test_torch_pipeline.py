"""CPU parity of the port's GPipe pipeline (``make_pp_loss``) with the JAX
package's.

Four spawned gloo ranks (``_torch_ranks.pipeline``, one spawn for both
meshes) run the port's schedule at pp 2 (fsdp 2) and pp 4 on the tiny
Llama in fp32 with 4 layers, from the JAX package's ``llama_init``
weights.  The loss is held to the JAX ``make_pp_loss`` on the same mesh
over four virtual devices; every gradient to ``jax.grad`` of the JAX
``llama_loss``, the true gradient: each stage's layers, and ``embed``,
``final_norm`` and ``lm_head``, which every stage holds and whose
gradient must be summed over pp exactly once.  fp32 summation order only:
rtol 1e-5 on the loss, atol 2e-6 / rtol 1e-4 on gradients up to ~1e-1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.models import llama_loss as jax_llama_loss
from ray_tpu.parallel import MeshConfig as JaxMeshConfig
from ray_tpu.parallel import make_mesh as jax_make_mesh
from ray_tpu.parallel import make_pp_loss as jax_make_pp_loss
from ray_tpu.parallel import set_mesh as jax_set_mesh
from ray_tpu.parallel import stack_layers as jax_stack_layers

_PPS = (2, 4)


def _setup():
    jc = dataclasses.replace(JaxConfig.tiny(dtype=jnp.float32, remat=False),
                             n_layers=4)
    params = jax_llama_init(jc, jax.random.PRNGKey(0))
    r = np.random.default_rng(3)
    toks = r.integers(0, jc.vocab_size, (8, 32)).astype(np.int32)
    tgt = np.roll(toks, -1, axis=1)
    tgt[r.integers(0, 8, 3), r.integers(0, 32, 3)] = -100
    return jc, params, toks, tgt


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    jc, params, toks, tgt = _setup()
    cfg_kw = {f.name: getattr(jc, f.name)
              for f in dataclasses.fields(jc) if f.name != "dtype"}
    cfg_kw["dtype"] = torch.float32
    out = _torch_ranks.run(_torch_ranks.pipeline, 4, cfg_kw,
                           jax.tree.map(np.asarray, params), toks, tgt, 4,
                           _PPS, tmp=tmp_path_factory.mktemp("pipeline"))
    return out


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[int(key)] if key.isdigit() else tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("pp", _PPS)
def test_pp_loss_matches_jax_pipeline(pp_runs, pp):
    jc, params, toks, tgt = _setup()
    mesh = jax_make_mesh(JaxMeshConfig(fsdp=4 // pp, pp=pp),
                         devices=jax.devices()[:4])
    loss_fn = jax_make_pp_loss(jc, mesh, n_micro=4)
    with jax_set_mesh(mesh):
        want = float(jax.jit(loss_fn)(jax_stack_layers(params),
                                      jnp.asarray(toks), jnp.asarray(tgt)))
    ref = float(jax_llama_loss(jc, params, jnp.asarray(toks),
                               jnp.asarray(tgt)))
    for loss, _ in (rank[pp] for rank in pp_runs):
        np.testing.assert_allclose(loss, want, rtol=1e-5)
        np.testing.assert_allclose(loss, ref, rtol=1e-5)


@pytest.mark.parametrize("pp", _PPS)
def test_pp_gradients_are_the_true_gradients(pp_runs, pp):
    """Every rank's gradients equal jax.grad of the unpipelined loss: its
    stage's layers, and the tensors every stage holds (summed over pp once,
    not pp times and not left on one stage)."""
    jc, params, toks, tgt = _setup()
    grads = jax.grad(lambda p: jax_llama_loss(
        jc, p, jnp.asarray(toks), jnp.asarray(tgt)))(params)
    n_leaves = len(jax.tree.leaves(grads))
    seen = set()
    for rank, res in enumerate(pp_runs):
        _, got = res[pp]
        for name, g in got.items():
            np.testing.assert_allclose(g, _leaf(grads, name), atol=2e-6,
                                       rtol=1e-4, err_msg=f"{name} rank "
                                                          f"{rank}")
            seen.add(name)
    assert len(seen) == n_leaves
