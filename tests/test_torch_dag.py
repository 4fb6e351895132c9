"""The port's compiled DAGs (``ray_tpu_torch.dag``) against the JAX
package's: the scenario ``dag`` of ``tests/_torch_lib_scenarios.py`` runs
once under each package (both clusters at once on this host) and every
test compares one piece of the two results: test_dag.py's shm channel,
pipeline, error, diamond, multi-output, overlapped-execution and
diamond-error cases, then an encode -> middle -> collect chain whose
middle stage holds the one mocked card (``RT_GPUS=1`` on the port,
``RT_TPU_CHIPS=1`` on JAX) and whose inner edges carry a torch tensor on
the port (a numpy array on JAX)."""

import pytest

import _torch_lib_scenarios as sc

_results = {}


def _dag():
    """Both packages' results; a failure is kept for every test."""
    if "dag" not in _results:
        try:
            ref, got = sc.run_pair(
                ["dag"], jax_env={"RT_TPU_CHIPS": "1"},
                port_env={"RT_GPUS": "1", "CUDA_VISIBLE_DEVICES": None})
            _results["dag"] = (ref["dag"], got["dag"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["dag"] = e
    if isinstance(_results["dag"], Exception):
        raise _results["dag"]
    return _results["dag"]


@pytest.mark.parametrize("key", [
    "channel", "pipeline", "error", "diamond", "multi_output", "overlapped",
    "diamond_error", "tensor_edge", "granted_stage"])
def test_dag_matches_jax(key):
    ref, got = _dag()
    assert got[key] == ref[key]


def test_dag_values():
    """What test_dag.py asserts of the JAX package, of the port."""
    _, got = _dag()
    assert got["channel"] == ["hello", "again", "EOFError: channel closed"]
    assert got["pipeline"] == [41, True, True, True]
    assert got["error"] == [1, "ValueError: unlucky", 2]
    assert got["diamond"] == [i * 110 for i in range(10)]
    assert got["multi_output"] == [[10, 15], [14, 21]]
    assert got["overlapped"] == [[3, 4, 5, 6], True]
    assert got["diamond_error"] == ["ValueError: branch failed"] * 2
    assert got["tensor_edge"] == [[3, 5, 7], [15, 17]]
    assert got["granted_stage"] == [[0], [0]]


def test_edges_carry_torch_tensors():
    """On the port a tensor crosses each edge as a CPU torch tensor of its
    dtype (the JAX package's edges carry numpy arrays)."""
    ref, got = _dag()
    assert got["edge_types"] == [["torch", "torch.int64", "torch"]] * 2
    assert ref["edge_types"] == [["numpy", "int64", "numpy"]] * 2


def test_bind_builds_a_graph_node():
    """``ActorMethod.bind`` wires a DAG step (it raised before the port
    had ``dag``); ``enable_compiled_dags`` adds the exec loop; bind takes
    only graph nodes."""
    from ray_tpu_torch.core.api import ActorClass, ActorHandle, ActorMethod
    from ray_tpu_torch.core.ids import ActorID
    from ray_tpu_torch.dag import InputNode, enable_compiled_dags
    from ray_tpu_torch.dag.compiled import ClassMethodNode

    class Stage:
        def run(self, x):
            return x

    cls = enable_compiled_dags(ActorClass(Stage, {}))
    assert hasattr(cls._cls, "__rt_dag_exec_loop__")
    handle = ActorHandle(ActorID.from_random(), ["run"], class_name="Stage")
    with InputNode() as inp:
        node = ActorMethod(handle, "run").bind(inp)
    assert isinstance(node, ClassMethodNode)
    assert node.method_name == "run" and node.upstreams == [inp]
    with pytest.raises(TypeError):
        ActorMethod(handle, "run").bind(3)


def test_channel_refuses_oversize_payload(tmp_path):
    """A payload over the channel's capacity raises before it is written:
    a [1, 2048, 4096] bf16 activation (16 MiB) needs a capacity above the
    8-MiB default, given at compile time."""
    from ray_tpu_torch.dag import ShmChannel

    path = str(tmp_path / "chan")
    ch = ShmChannel(path, capacity=64, create=True)
    try:
        with pytest.raises(ValueError, match="exceeds channel capacity"):
            ch.write_bytes(b"x" * 65)
        ch.write_bytes(b"x" * 64)
    finally:
        ch.close(unlink=True)
