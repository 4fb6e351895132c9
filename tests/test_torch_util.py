"""The port's actor pool, distributed queue and ``multiprocessing.Pool``
(``ray_tpu_torch.util``) against the JAX package's: the scenario ``util``
of ``tests/_torch_lib_scenarios.py`` (test_util.py's seven tests in one
cluster) runs once under each package, both at once on this host, and
every test compares one piece of the two results.  Nothing here touches a
device, in either package."""

import pytest

import _torch_lib_scenarios as sc

_results = {}


def _util():
    if "util" not in _results:
        try:
            ref, got = sc.run_pair(["util"])
            _results["util"] = (ref["util"], got["util"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["util"] = e
    if isinstance(_results["util"], Exception):
        raise _results["util"]
    return _results["util"]


@pytest.mark.parametrize("key", [
    "pool_map", "pool_submit", "queue", "queue_timed_put", "queue_shared",
    "pool_mixed", "multiprocessing"])
def test_util_matches_jax(key):
    ref, got = _util()
    assert got[key] == ref[key]


def test_util_values():
    """What test_util.py asserts of the JAX package, of the port."""
    _, got = _util()
    assert got["pool_map"] == [[0, 2, 4, 6, 8, 10], [0, 2, 4, 6], 0, True]
    assert got["pool_submit"] == [True, False, True, 20, 22, False,
                                  "StopIteration"]
    assert got["queue"][:3] == [True, 2, "Full: queue full"]
    assert got["queue"][8:] == [["late"],
                                "Full: queue accepted only 3/4 items",
                                [1, 2, 3]]
    # The timed-out put left no phantom item behind it.
    assert got["queue_timed_put"] == [
        "Full: queue full after 0.5s", True, 1, "only",
        "Empty: queue empty", "a", False, "b"]
    assert got["queue_shared"] == [list(range(8)), 8]
    assert got["pool_mixed"] == [True, True, [0, 2], False, [10, 12]]
    assert got["multiprocessing"][-1] == "ValueError: Pool is closed"


def test_util_exports_match_jax():
    import ray_tpu.util as jutil
    import ray_tpu_torch.util as tutil

    assert tutil.__all__ == jutil.__all__
    assert issubclass(tutil.Empty, Exception)
    assert issubclass(tutil.Full, Exception)
