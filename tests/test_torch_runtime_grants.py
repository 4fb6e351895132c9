"""GPU grants in the port's runtime against the JAX package's TPU chip
grants: the same scenario with two mocked cards (``RT_GPUS=2`` on the
port, ``RT_TPU_CHIPS=2`` on JAX) must hand out the same IDs, hold a task
back while the cards are held, and free a grant on ``kill``.  Then the
port alone: ``CUDA_VISIBLE_DEVICES`` in granted and ungranted workers and
under a parent's own list, an ungranted task's ``resolve_device()``
raising, and the refused options.
"""

import pytest

import _torch_runtime_scenarios as sc
from ray_tpu import accelerators as jacc
from ray_tpu.core import scheduler as jsched
from ray_tpu.core.ids import NodeID as JNodeID
from ray_tpu_torch import accelerators as tacc
from ray_tpu_torch.core import scheduler as tsched
from ray_tpu_torch.core.ids import NodeID as TNodeID

_results = {}


def _grants():
    if "grants" not in _results:
        _results["grants"] = sc.run_pair(
            "grants", jax_env={"RT_TPU_CHIPS": "2"},
            port_env={"RT_GPUS": "2", "CUDA_VISIBLE_DEVICES": None})
    return _results["grants"]


@pytest.mark.parametrize("key", ["cpu_task", "one", "two", "actor_1",
                                 "actor_2", "queued_while_held",
                                 "after_kill", "fraction"])
def test_gpu_grants_match_tpu_grants(key):
    ref, got = _grants()
    assert got[key] == ref[key]
    expect = {"cpu_task": None, "one": [0], "two": [0, 1], "actor_1": [0],
              "actor_2": [1], "queued_while_held": 0, "after_kill": [0],
              "fraction": None}
    assert got[key] == expect[key]


def test_gpu_resource_autodetect_matches_chips():
    ref, got = _grants()
    assert ref["resources"] == {"TPU": 2.0}
    assert got["resources"] == {"GPU": 2.0}


def _port_grants(parent):
    key = f"port_grants:{parent}"
    if key not in _results:
        env = ({"RT_GPUS": "2", "CUDA_VISIBLE_DEVICES": None}
               if parent is None
               else {"RT_GPUS": None, "CUDA_VISIBLE_DEVICES": parent})
        _results[key] = sc.result(sc.run("port_grants", "ray_tpu_torch", env))
    return _results[key]


@pytest.mark.parametrize("parent", [None, "3,5"])
def test_worker_visibility(parent):
    out = _port_grants(parent)
    assert out["resources"] == 2.0
    assert out["ungranted"] == ["", parent]
    if parent is None:
        assert out["granted_one"] == ["0", None]
        assert out["granted_two"] == ["0,1", None]
    else:
        assert out["granted_one"] == ["3", parent]
        assert out["granted_two"] == ["3,5", parent]


def test_ungranted_task_cannot_reach_the_card():
    out = _port_grants(None)
    msg, available = out["resolve_device"]
    assert "CUDA is not available" in msg and available is False


def test_refused_options():
    out = _port_grants(None)
    assert "GPU=1.5" in out["bad_count"]
    assert out["num_tpus"] == "ValueError"


def test_gpu_pool_matches_chip_pool():
    """The scheduler's ID pool, driven by one sequence of grants and
    frees, hands out what the JAX chip pool does."""
    js, ts = jsched.ClusterScheduler(), tsched.ClusterScheduler()
    jn, tn = JNodeID.from_random(), TNodeID.from_random()
    js.add_node(jn, {"CPU": 4.0, "TPU": 4.0})
    ts.add_node(tn, {"CPU": 4.0, "GPU": 4.0})
    grants, got = [], []
    for op, n in [("a", 1), ("a", 2), ("a", 2), ("f", 0), ("a", 1),
                  ("f", 1), ("a", 3), ("a", 2)]:
        if op == "a":
            t = ts.allocate_gpus(tn, n)
            assert t == js.allocate_tpu_chips(jn, n)
            got.append(t)
            if t is not None:
                grants.append(t)
        else:
            js.free_tpu_chips(jn, grants[n])
            ts.free_gpus(tn, grants[n])
    assert got == [[0], [1, 2], None, [0], [1, 2, 3], None]
    assert ts.nodes[tn].gpu_free == js.nodes[jn].tpu_free


def test_accelerator_detection_and_visibility(monkeypatch):
    monkeypatch.setenv("RT_GPUS", "3")
    monkeypatch.setenv("RT_TPU_CHIPS", "3")
    assert tacc.num_gpus() == jacc.num_chips() == 3
    assert tacc.node_resources() == {"GPU": 3.0}
    monkeypatch.delenv("RT_GPUS")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,7")
    assert tacc.num_gpus() == 2
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert tacc.num_gpus() == 0 and tacc.node_resources() == {}
    assert tacc.visibility_env([1, 0]) == {"CUDA_VISIBLE_DEVICES": "0,1"}
    assert tacc.visibility_env([1], "2,7") == {"CUDA_VISIBLE_DEVICES": "7"}
    for ok in (0.25, 0.5, 1, 2, 3, 8):
        assert tacc.validate_request(ok) is None
    for bad in (1.5, 2.25, -1):
        assert "GPU=" in tacc.validate_request(bad)
    env = {"CUDA_VISIBLE_DEVICES": "4,6", "PATH": "/bin"}
    tacc.set_worker_env(env)
    assert env == {"CUDA_VISIBLE_DEVICES": "",
                   tacc.PARENT_VISIBLE: "4,6", "PATH": "/bin"}
    env = {tacc.PARENT_VISIBLE: "stale"}
    tacc.set_worker_env(env)
    assert env == {"CUDA_VISIBLE_DEVICES": ""}
