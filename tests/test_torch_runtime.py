"""The port's runtime core (``ray_tpu_torch.init`` and the rest) against the
JAX package's: tasks, ``get``/``wait``, ``ObjectRef`` arguments, numpy over
shared memory, actors and errors.

Each scenario of ``tests/_torch_runtime_scenarios.py`` runs once under each
package, both clusters at once on this host, and every test compares one
piece of the two results, which must be equal.
"""

import pytest

import _torch_runtime_scenarios as sc

_results = {}


def _pair(name):
    if name not in _results:
        _results[name] = sc.run_pair(name)
    return _results[name]


@pytest.mark.parametrize("key", ["fan_out", "wait_timeout", "wait_all",
                                 "get_timeout", "num_returns", "nested",
                                 "ref_args", "nested_ref"])
def test_tasks_match_jax(key):
    ref, got = _pair("tasks")
    assert got[key] == ref[key]
    if key == "wait_timeout":
        assert got[key] == [1, 1, [0.0]]
    if key == "get_timeout":
        assert got[key] == "GetTimeoutError"


@pytest.mark.parametrize("key", ["put_get", "by_ref", "by_value"])
def test_numpy_over_shm_matches_jax(key):
    ref, got = _pair("shm")
    assert got[key] == ref[key]


@pytest.mark.parametrize("key", ["state", "named", "kill", "max_restarts",
                                 "async"])
def test_actors_match_jax(key):
    ref, got = _pair("actors")
    assert got[key] == ref[key]
    if key == "kill":
        assert got[key] == "ActorDiedError"
    if key == "max_restarts":
        assert got[key] == [True, 1]


@pytest.mark.parametrize("key", ["task_error", "actor_error", "actor_died"])
def test_errors_match_jax(key):
    ref, got = _pair("errors")
    assert got[key] == ref[key]
