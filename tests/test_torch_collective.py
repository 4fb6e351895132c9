"""The port's host-plane collective against the JAX package's:
``tests/test_collective.py``'s tree collectives at worlds 3 and 4 (its
world-16 case is ``slow``), run by rank actors of each package's cluster
at once (``_torch_train_scenarios.collective``).  Every rank's results,
its KV puts and its ``op_totals``/``op_stats`` deltas must equal the JAX
package's bit for bit; a CPU tensor as input gives the numpy array's
results."""

import numpy as np
import pytest
import torch

import _torch_train_scenarios as sc
from ray_tpu_torch.collective import collective as tcol

_results = {}


def _pair():
    if "collective" not in _results:
        try:
            ref, got = sc.run_pair(["collective"])
            _results["collective"] = (ref["collective"], got["collective"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["collective"] = e
    if isinstance(_results["collective"], Exception):
        raise _results["collective"]
    return _results["collective"]


@pytest.mark.parametrize("world", [3, 4])
def test_tree_collectives_match_jax(world):
    ref, got = _pair()
    name = f"tree{world}"
    assert got[name] == ref[name]
    assert got[name]["ranks"] == list(range(world))
    expect = float(sum(range(1, world + 1)))
    for res in got[name]["results"]:
        assert res["sum"] == [expect] and res["sum_type"] == "ndarray"
        assert res["gathered"] == [[r] for r in range(world)]
        assert res["mean"] == [expect / world]
        assert res["max"] == [float(world)]
        assert res["broadcast"] == [8.5]
        # allreduce x3, allgather, broadcast, barrier.
        assert res["ops"] == 6
        assert res["calls"] == {"allgather": 1, "allreduce": 3,
                                "barrier": 2, "broadcast": 1}
    assert got[name]["scattered"] == [[float(r * world)]
                                      for r in range(world)]


def test_tensor_input_gives_the_numpy_results():
    """A CPU tensor in: numpy out, the same values, bytes and puts as
    the JAX package's numpy gang."""
    ref, got = _pair()
    assert got["tree4t"] == ref["tree4"]


def test_host_copy_of_tensors():
    """``_host``: a tensor is detached and copied to the host (bf16 widened
    to fp32, which numpy can hold); numpy passes through."""
    x = torch.arange(4.0, requires_grad=True)
    out = tcol._host(x * 2)
    assert isinstance(out, np.ndarray) and out.tolist() == [0, 2, 4, 6]
    bf = tcol._host(torch.tensor([1.5, -2.0], dtype=torch.bfloat16))
    assert bf.dtype == np.float32 and bf.tolist() == [1.5, -2.0]
    a = np.arange(3)
    assert tcol._host(a) is a
