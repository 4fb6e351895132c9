"""LLM serving through the port's front against the JAX package's.  Both
packages build the tiny model (fp32, on the CPU) from one numpy weight
tree, the JAX package's ``llama_init`` as numpy, carried into the port by
``params_from_jax`` inside each replica; a LoRA adapter likewise.  Greedy
tokens must be equal, exactly: ``generate`` streamed by a deployment
(test_serve.py's last test), and an ``InferenceEngine`` deployment through
the handle (base, ``adapter=``, ``multiplexed_model_id``) and as SSE,
byte for byte.  A mid-stream cancel through the handle and an SSE client
that hangs up each free the replica's pages; an adapter read from the
object store streams the tokens of the same adapter registered directly;
the engine's stats agree.  ``llm_app(model="tiny")`` (the port's with
``device="cpu"``) through the handle and SSE equals an engine of its own
package built in process from the same seed."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_serve_scenarios as sc
from ray_tpu.models import LlamaConfig as JaxConfig
from ray_tpu.models import llama_init as jax_llama_init
from ray_tpu.serve.engine import random_lora as jax_random_lora

_results = {}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_trees")
    cfg = JaxConfig.tiny(remat=False, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jax_llama_init(cfg,
                                                   jax.random.PRNGKey(3)))
    lora = jax.tree.map(np.asarray, jax_random_lora(cfg, 5, rank=8))
    paths = {"RT_SERVE_TREE": tmp / "tree.pkl",
             "RT_SERVE_LORA": tmp / "lora.pkl"}
    for obj, key in ((tree, "RT_SERVE_TREE"), (lora, "RT_SERVE_LORA")):
        with open(paths[key], "wb") as f:
            pickle.dump(obj, f)
    return {k: str(v) for k, v in paths.items()}


_LLM = ["llm_stream", "llm_engine", "llm_app"]


def _pair(name, trees):
    """One process a package runs the three LLM scenarios in turn; their
    results (or the run's error) are kept for every test."""
    if "llm" not in _results:
        try:
            _results["llm"] = sc.run_pair(_LLM, env=trees, timeout=600)
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["llm"] = e
    if isinstance(_results["llm"], Exception):
        raise _results["llm"]
    ref, got = _results["llm"]
    return ref[name], got[name]


@pytest.mark.parametrize("key", ["handle", "again", "sse"])
def test_generate_stream_matches_jax(trees, key):
    ref, got = _pair("llm_stream", trees)
    assert got[key] == ref[key]
    assert len(got["handle"]) == 5 and got["again"] == got["handle"]


@pytest.mark.parametrize("key", [
    "base", "adapter", "mux", "stored", "cancel_head", "cancel_freed",
    "cancelled", "sse", "sse_adapter", "hangup_first", "hangup_freed",
    "stats"])
def test_engine_deployment_matches_jax(trees, key):
    ref, got = _pair("llm_engine", trees)
    assert got[key] == ref[key]


def test_engine_deployment_values(trees):
    _, got = _pair("llm_engine", trees)
    assert all(len(t) == 8 for t in got["base"] + got["adapter"])
    assert got["adapter"] != got["base"]
    assert got["mux"] == got["adapter"][1]
    assert got["stored"] == got["adapter"]
    assert got["cancel_freed"] and got["hangup_freed"]
    st = got["stats"]
    assert st["free_pages"] == st["total_pages"]
    assert st["cancelled"] == 2 and st["active_seqs"] == 0
    frames = [int(ln[6:]) for ln in got["sse"]["raw"].split("\n")
              if ln.startswith("data: ") and ln != "data: null"]
    assert frames == got["base"][0][:6]
    assert got["sse"]["type"] == "text/event-stream"


@pytest.mark.parametrize("key", ["handle_equal", "adapter_equal",
                                 "adapter_differs", "sse_equal", "sse_type",
                                 "lens", "stats_keys"])
def test_llm_app_matches_jax(trees, key):
    ref, got = _pair("llm_app", trees)
    assert got[key] == ref[key]
    assert got["handle_equal"] and got["adapter_equal"] and got["sse_equal"]
