"""The port's serving front against the JAX package's: the same
deployments under ``ray_tpu.serve`` and ``ray_tpu_torch.serve`` (one
cluster each, run at once by ``_torch_serve_scenarios.front``) must give
the same results: routing over two replicas, a rolling update,
``@serve.batch``, HTTP bodies and status codes, model composition,
multiplexing and its LRU, streamed items through the handle and SSE
frames byte for byte, ``deploy_config`` and the status dicts.  Then the
pure parts of the two packages on the same inputs: the autoscaler's
decision, rendezvous routing of model ids, the multiplexed LRU and the
batcher."""

import asyncio
import itertools

import pytest

import _torch_serve_scenarios as sc
from ray_tpu.serve import batching as jbatching
from ray_tpu.serve import controller as jcontroller
from ray_tpu.serve import multiplex as jmultiplex
from ray_tpu_torch.serve import batching as tbatching
from ray_tpu_torch.serve import controller as tcontroller
from ray_tpu_torch.serve import multiplex as tmultiplex

_results = {}


def _front():
    if "front" not in _results:
        _results["front"] = sc.run_pair("front")
    return _results["front"]


@pytest.mark.parametrize("key", [
    "routing", "rolling_update", "batching", "http", "http_error",
    "composition", "multiplexing", "multiplex_lru", "stream_handle",
    "stream_sse", "deploy_config", "config_typo", "status"])
def test_front_matches_jax(key):
    ref, got = _front()
    assert got[key] == ref[key]


def test_front_values():
    """What test_serve.py asserts of the JAX package, of the port."""
    _, got = _front()
    assert got["routing"]["outs"] == [f"hi:{i}" for i in range(20)]
    assert got["routing"]["replicas"] == 2
    assert got["rolling_update"] == ["v1:1", "v2:2", 2]
    assert got["batching"] == [[2 * i for i in range(8)], 8, True]
    assert got["http"] == [200, "application/json", '{"sum": 42}']
    assert got["composition"] == [21, ["Doubler", "Pipeline"]]
    assert got["multiplexing"] == ["model:a", 1, "model:b"]
    assert got["multiplex_lru"] == ["a", "b", "c", "a"]
    assert got["stream_handle"] == ["h0", "h1", "h2", "h3"]
    assert got["stream_sse"]["raw"] == (
        'data: "t0"\n\ndata: "t1"\n\ndata: "t2"\n\n'
        "event: done\ndata: null\n\n")
    assert got["deploy_config"] == ["hey, you", "hey, you"]
    assert got["status"]["greet"]["running_replicas"] == 2


def test_public_names_match_jax():
    """Every name of ``ray_tpu.serve.__all__`` is in the port's, each
    module of the JAX package's front has its twin, and each public
    function or class there has its counterpart under the same name."""
    import importlib

    import ray_tpu.serve as jserve
    import ray_tpu_torch.serve as tserve

    assert set(jserve.__all__) <= set(tserve.__all__)
    for name in tserve.__all__:
        assert getattr(tserve, name) is not None
    for mod in ("api", "batching", "config", "controller", "grpc_ingress",
                "handle", "multiplex", "replica"):
        jm = importlib.import_module(f"ray_tpu.serve.{mod}")
        tm = importlib.import_module(f"ray_tpu_torch.serve.{mod}")
        # Functions and classes defined there, and its actor classes.
        public = {n for n, v in vars(jm).items() if not n.startswith("_")
                  and (getattr(v, "__module__", None) == jm.__name__
                       or type(v).__name__ == "ActorClass")}
        assert public and public <= set(vars(tm)), (mod, public)


_SCALE_INPUTS = list(itertools.product(
    (1, 2, 3),                 # current replicas
    (0.0, 0.4, 1.0, 2.5),      # queue per replica
    (None, 0.05, 0.3),         # TTFT p90
    (None, 0.1),               # TTFT target
    (None, 0.05, 0.2, 0.6)))   # stall fraction


@pytest.mark.parametrize("chunk", range(4))
def test_scale_decision_matches_jax(chunk):
    for cur, per_q, ttft, target, stall in _SCALE_INPUTS[chunk::4]:
        args = (cur, 1, 3, per_q, 1.0, ttft, target, stall, 0.25)
        assert tcontroller._scale_decision(*args) == \
            jcontroller._scale_decision(*args), args


def test_pick_replica_for_model_matches_jax():
    for n in range(1, 6):
        ids = [7 * i + 3 for i in range(n)]
        for model in (f"m{i}" for i in range(40)):
            assert tmultiplex.pick_replica_for_model(model, ids) == \
                jmultiplex.pick_replica_for_model(model, ids)
    # Scaling from 4 to 5 replicas moves only the models the new one wins.
    old, new = [1, 2, 3, 4], [1, 2, 3, 4, 5]
    moved = [m for m in (f"m{i}" for i in range(200))
             if tmultiplex.pick_replica_for_model(m, new) != 4
             and old[tmultiplex.pick_replica_for_model(m, old)]
             != new[tmultiplex.pick_replica_for_model(m, new)]]
    assert moved == []


@pytest.mark.parametrize("mod", [jmultiplex, tmultiplex],
                         ids=["jax", "port"])
def test_multiplexed_lru(mod):
    class Host:
        def __init__(self):
            self.loads = []

        @mod.multiplexed(max_num_models_per_replica=2)
        def get(self, model_id):
            self.loads.append(model_id)
            return model_id.upper()

    h = Host()
    got = [h.get(m) for m in ("a", "b", "a", "c", "b", "a")]
    assert got == ["A", "B", "A", "C", "B", "A"]
    assert h.loads == ["a", "b", "c", "b", "a"]
    token = mod._set_model_id("x")
    assert mod.get_multiplexed_model_id() == "x"
    mod._reset_model_id(token)
    assert mod.get_multiplexed_model_id() == ""


@pytest.mark.parametrize("mod", [jbatching, tbatching], ids=["jax", "port"])
def test_batch_fans_results_out(mod):
    class Model:
        def __init__(self):
            self.sizes = []

        @mod.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        async def __call__(self, items):
            self.sizes.append(len(items))
            return [x + 100 for x in items]

    async def go():
        m = Model()
        out = await asyncio.gather(*(m(i) for i in range(10)))
        return out, m.sizes

    out, sizes = asyncio.run(go())
    assert out == [i + 100 for i in range(10)]
    assert sizes == [4, 4, 2]
