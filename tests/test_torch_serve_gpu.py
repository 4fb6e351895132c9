"""GPU replicas in the port's serving front against TPU replicas in the
JAX package's, one mocked card each (``RT_GPUS=1`` on the port,
``RT_TPU_CHIPS=1`` on JAX): a replica granted the card, a rolling update
of it on the one card, and the card granted to the next app after a
delete.  Then the port alone: a replica pending on the card holds no other
deployment's reconcile and, deleted, leaves the card free;
``num_gpus`` becomes the "GPU" resource and
``num_tpus`` is refused; ``llm_app`` asks each replica for one card
unless ``device="cpu"``; a replica granted a card it cannot reach, or
granted none, raises instead of running on the CPU; the port's own
classes are shipped to replicas by reference, a driver's by value."""

import cloudpickle
import pytest
import torch

import _torch_serve_scenarios as sc
from ray_tpu_torch import serve
from ray_tpu_torch.models.llama import llama_init
from ray_tpu_torch.serve.api import Deployment, _dumps_by_value
from ray_tpu_torch.serve.engine import LLMServer, _MODEL_BUILDERS

_results = {}


_PORT_ONLY = ["no_card", "pending_card"]


def _runs():
    """The JAX process runs ``grants``; the port's runs ``grants`` and its
    own scenarios, in one process.  A failure is kept for every test."""
    if "runs" not in _results:
        try:
            jp = sc.run(["grants"], "ray_tpu", {"RT_TPU_CHIPS": "1"})
            tp = sc.run(["grants"] + _PORT_ONLY, "ray_tpu_torch",
                        {"RT_GPUS": "1", "CUDA_VISIBLE_DEVICES": None})
            _results["runs"] = (sc.result(jp, 600), sc.result(tp, 600))
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["runs"] = e
    if isinstance(_results["runs"], Exception):
        raise _results["runs"]
    return _results["runs"]


def _grants():
    ref, got = _runs()
    return ref["grants"], got["grants"]


@pytest.mark.parametrize("key", ["v1", "rolled", "v2", "status", "second",
                                 "final_status"])
def test_gpu_replicas_match_tpu_replicas(key):
    ref, got = _grants()
    assert got[key] == ref[key]
    expect = {"v1": ["v1", [0]], "rolled": True, "v2": ["v2", [0]],
              "second": ["second", [0]]}
    if key in expect:
        assert got[key] == expect[key]


def test_gpu_resource_matches_chip():
    ref, got = _grants()
    assert ref["resources"] == {"TPU": 1.0}
    assert got["resources"] == {"GPU": 1.0}


def _no_card():
    return _runs()[1]["no_card"]


def test_pending_replica_holds_neither_the_loop_nor_the_card():
    """App ``b`` waits for the card ``a`` holds: a CPU app deploys
    meanwhile, deleting ``b`` returns at once, and once ``a`` is deleted
    too the card is free and stays free (no leftover replica takes it)
    until app ``d`` is granted it."""
    out = _runs()[1]["pending_card"]
    assert out["a"] == ["a", [0]]
    assert out["cpu"] == "cpu" and out["cpu_fast"]
    assert out["b_status"] == {"target_replicas": 1, "running_replicas": 0}
    assert out["delete_fast"]
    assert out["card_freed"] and out["card_still_free"]
    assert out["d"] == ["d", [0]]
    assert out["apps"] == ["cpu", "d"]


@pytest.mark.parametrize("when", ["health_wait", "after_count"])
def test_replica_ready_after_delete_is_stopped(when):
    """``serve.delete`` landing inside a reconcile pass, while it waits on
    the live replicas' health pings or after it read the target count: a
    replica whose first ping landed in that pass is stopped, so every
    replica ends stopped or still held by the controller for the next
    pass to stop (none holds a card unseen)."""
    import threading

    from ray_tpu_torch.serve.controller import ServeController

    ctl = object.__new__(ServeController._cls)
    spec = {"version": 1, "num_replicas": 2}
    ctl.targets = {"b": spec}
    ctl.replicas = {"b": [{"handle": "h1", "id": 1, "version": 1}]}
    ctl.pending = {"b": [{"handle": "h2", "id": 2, "version": 1,
                          "ping": "ref"}]}
    ctl._lock = threading.Lock()
    ctl._version = 0
    stopped = []

    def alive_many(reps):
        if when == "health_wait":
            ctl.targets.pop("b")
        return [True] * len(reps)

    def collect_started(name, spec_):
        r = ctl.pending[name].pop()
        return [{k: r[k] for k in ("handle", "id", "version")}]

    def target_replicas(name):
        want = ServeController._cls._target_replicas(ctl, name)
        if when == "after_count":
            ctl.targets.pop("b")
        return want

    ctl._alive_many = alive_many
    ctl._collect_started = collect_started
    ctl._target_replicas = target_replicas
    ctl._start_replica = lambda *a: pytest.fail("started after delete")
    ctl._stop_replica = stopped.append
    ctl._reconcile("b", spec)
    held = ctl.replicas.get("b", []) + ctl.pending.get("b", [])
    assert {r["id"] for r in stopped} | {r["id"] for r in held} == {1, 2}
    assert 2 in {r["id"] for r in stopped}


def test_replica_without_a_reachable_card_raises():
    out = _no_card()
    assert out["options"] == {"num_gpus": 1}
    assert out["run"] == "TimeoutError" and out["running"] == 0
    assert out["granted"] == ["TaskError", True]
    assert out["ungranted"] == ["TaskError", True]


def test_actor_options_map_to_resources():
    def f():
        return 1

    dep = serve.deployment(ray_actor_options={"num_gpus": 1,
                                              "num_cpus": 2})(f)
    spec = dep.to_spec(dep.bind())
    assert spec["resources"] == {"CPU": 2, "GPU": 1}
    assert serve.deployment(f).to_spec(serve.deployment(f).bind())[
        "resources"] == {}
    for make in (lambda: serve.deployment(
                     ray_actor_options={"num_tpus": 1})(f),
                 lambda: Deployment(f, "f",
                                    ray_actor_options={"num_tpus": 1}),
                 lambda: serve.deployment(f).options(
                     ray_actor_options={"num_tpus": 1})):
        with pytest.raises(ValueError, match="num_tpus"):
            make()


def test_llm_app_asks_for_a_card_unless_on_the_cpu():
    app = serve.llm_app(model="tiny")
    assert app.deployment.ray_actor_options == {"num_gpus": 1}
    assert app.init_kwargs["device"] is None
    cpu = serve.llm_app(model="tiny", device="cpu", num_replicas=2)
    assert cpu.deployment.ray_actor_options == {}
    assert cpu.deployment.num_replicas == 2
    assert cpu.init_kwargs["device"] == "cpu"
    assert cpu.deployment.to_spec(cpu)["resources"] == {}


def test_llm_server_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMServer(model="tiny")
    server = LLMServer(model="tiny", device="cpu", adapters={"a": 1},
                       engine=dict(batch_slots=2, page_size=8,
                                   max_prompt_len=16))
    try:
        cfg = _MODEL_BUILDERS["tiny"]()
        want = llama_init(cfg, torch.Generator().manual_seed(0), "cpu")
        sums = server.weight_checksums()
        assert sums == {n: float(p.double().sum())
                        for n, p in want.named_parameters()}
        assert cfg.dtype == torch.float32
        assert _MODEL_BUILDERS["b1"]().dtype == torch.bfloat16
        toks = list(server([1, 2, 3], max_new_tokens=4))
        with_a = list(server([1, 2, 3], max_new_tokens=4, adapter="a"))
        assert len(toks) == len(with_a) == 4 and toks != with_a
        st = server.stats()
        assert st["kernel_launches"]["flash_fwd"] == 0  # CPU: plain paths
        assert st["completed"] == 2 and st["adapters"]["registered"] == 1
        assert set(server.engine_metrics()) >= {"ttft_p90_s", "queue_depth"}
    finally:
        server.engine.shutdown()


class _Local:
    def __call__(self):
        return 1


def test_dumps_by_value_keeps_the_package_by_reference(tmp_path):
    """A fresh interpreter that cannot import this test module still
    loads its class (shipped by value) and finds ``LLMServer`` in the
    package by reference."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    for name, obj in (("local", _Local), ("server", LLMServer)):
        (tmp_path / name).write_bytes(_dumps_by_value(obj))
    code = ("import sys, cloudpickle\n"
            "local = cloudpickle.loads(open('local', 'rb').read())\n"
            "server = cloudpickle.loads(open('server', 'rb').read())\n"
            "print(local()(), 'test_torch_serve_gpu' in sys.modules, "
            "server.__module__, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=str(root)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "False", "ray_tpu_torch.serve.engine",
                                  "True"]
    assert len(_dumps_by_value(LLMServer)) < 200


def test_replica_replaced_after_missed_probes_not_one():
    """A live replica whose probe misses its 5-s deadline is kept until it
    misses ``PROBE_MISSES`` passes in a row (an answer resets the count);
    a failed probe (a dead actor) replaces it at once.  The JAX controller
    replaces it at the first miss."""
    import threading

    from ray_tpu_torch.serve.controller import PROBE_MISSES, ServeController

    ctl = object.__new__(ServeController._cls)
    spec = {"version": 1, "num_replicas": 2}
    ctl.targets = {"a": spec}
    ctl.replicas = {"a": [{"handle": "h1", "id": 1, "version": 1},
                          {"handle": "h2", "id": 2, "version": 1}]}
    ctl.pending = {"a": []}
    ctl._lock = threading.Lock()
    ctl._version = 0
    stopped = []
    probes = iter([[None, True], [True, None], [None, None], [None, None],
                   [False, None]])
    ctl._alive_many = lambda reps: next(probes)[:len(reps)]
    ctl._collect_started = lambda name, spec_: []
    ctl._target_replicas = lambda name: 2
    ctl._autoscale = lambda *a: None
    ctl._start_replica = lambda name, spec_: {"handle": "new", "id": 9,
                                              "version": 1}
    ctl._stop_replica = lambda r: stopped.append(r["id"])
    for _ in range(PROBE_MISSES + 1):
        ctl._reconcile("a", spec)
    # Replica 1 missed passes 1, 3, 4 (an answer between): kept until the
    # third miss in a row would come; replica 2 missed passes 2-4.
    assert PROBE_MISSES == 3
    assert stopped == [2]
    ctl._reconcile("a", spec)  # replica 1's probe fails: dead, replaced
    assert stopped == [2, 1]
