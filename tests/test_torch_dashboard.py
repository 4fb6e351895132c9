"""The port's dashboard and job submission against the JAX package's: the
scenario ``dashboard`` of ``tests/_torch_lib_scenarios.py`` starts each
package's cluster with ``init(include_dashboard=True)`` and runs
test_dashboard.py's five tests, then test_observability.py's two jobs
(one that succeeds with its output in the logs, one that exits 3), listed
by ``/api/jobs``; both packages at once on this host, every test
comparing one piece of the two results."""

import pytest

import _torch_lib_scenarios as sc

_results = {}


def _dash():
    if "dash" not in _results:
        try:
            ref, got = sc.run_pair(["dashboard"])
            _results["dash"] = (ref["dashboard"], got["dashboard"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["dash"] = e
    if isinstance(_results["dash"], Exception):
        raise _results["dash"]
    return _results["dash"]


@pytest.mark.parametrize("key", [
    "status", "state_endpoints", "html", "metrics_history", "unknown_path",
    "jobs", "stopped"])
def test_dashboard_matches_jax(key):
    ref, got = _dash()
    assert got[key] == ref[key]


def test_dashboard_values():
    """What test_dashboard.py and test_observability.py assert of the JAX
    package, of the port."""
    _, got = _dash()
    assert got["status"] == [42, 1, 4.0]
    assert all(v == [200, True] for v in got["state_endpoints"][1].values())
    assert got["state_endpoints"][2:] == [True, True]
    assert got["html"] == [200, True, 200]
    assert got["metrics_history"] == [1, [200, True, True, True], True]
    assert got["unknown_path"] == 404
    assert got["jobs"] == ["SUCCEEDED", True, True, "FAILED",
                           ["FAILED", "SUCCEEDED"], True]


def test_routes_match_jax():
    """Every route and state kind of the JAX dashboard is the port's."""
    import inspect

    from ray_tpu import dashboard as jdash
    from ray_tpu_torch import dashboard as tdash

    assert tdash._STATE_KINDS == jdash._STATE_KINDS
    jsrc = inspect.getsource(jdash.Dashboard._route)
    tsrc = inspect.getsource(tdash.Dashboard._route)
    assert tsrc.replace("ray_tpu_torch", "ray_tpu") == jsrc
