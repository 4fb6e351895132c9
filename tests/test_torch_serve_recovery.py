"""Replica death and autoscaling in the port's serving front against the
JAX package's (``_torch_serve_scenarios.recovery``, both clusters at
once): a killed replica is replaced, and sustained load adds replicas.
Then the port alone: streams that hold every lane of a replica past the
controller's 5-s probe deadline leave the replica alive (its probes are
coroutines)."""

import pytest

import _torch_serve_scenarios as sc

_results = {}


def _recovery():
    """Both packages' results, computed once; a failure is kept too, so
    one scenario error fails every case at once instead of starting the
    cluster pair again."""
    if "recovery" not in _results:
        try:
            _results["recovery"] = sc.run_pair("recovery")
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["recovery"] = e
    if isinstance(_results["recovery"], Exception):
        raise _results["recovery"]
    return _results["recovery"]


@pytest.mark.parametrize("key", ["before", "replaced", "after",
                                 "autoscale_start", "autoscaled",
                                 "autoscaled_results"])
def test_recovery_matches_jax(key):
    ref, got = _recovery()
    assert got[key] == ref[key]
    expect = {"before": 2, "replaced": True, "after": 2,
              "autoscale_start": 1, "autoscaled": True,
              "autoscaled_results": ["done"]}
    assert got[key] == expect[key]


def test_busy_replica_answers_its_probes():
    """Two 8-item streams of 1 s an item on a replica of two lanes: both
    finish, all 8 items from one replica process."""
    _, got = _recovery()
    assert got["busy_streams"] == [[8, 1], [8, 1]]
