"""The port's runtime core against the JAX package's under faults and
pressure: ``max_retries`` after SIGKILL of a leased worker, a placement
group, spill and restore under a 3 MiB store, the head's ``list_state``
kinds, and a two-node ``cluster_utils.Cluster`` with cross-node pulls.

Each scenario of ``tests/_torch_runtime_scenarios.py`` runs once under each
package, both at once on this host; every test compares one piece of the
two results.
"""

import pytest

import _torch_runtime_scenarios as sc

_results = {}


def _pair(name):
    if name not in _results:
        _results[name] = sc.run_pair(name)
    return _results[name]


@pytest.mark.parametrize("key", ["retried", "no_retry"])
def test_retries_after_sigkill_match_jax(key):
    ref, got = _pair("retries")
    assert got[key] == ref[key]
    assert got == {"retried": 2, "no_retry": "WorkerCrashedError"}


def test_placement_group_matches_jax():
    ref, got = _pair("placement")
    assert got == ref
    assert got["pg"] == [True, [0, 1, 2, 3], 2.0, 4.0]


def test_spill_and_restore_match_jax():
    ref, got = _pair("spill")
    assert got == ref
    assert got["spill"][0] == [float(i) for i in range(8)]


@pytest.mark.parametrize("kind", sc.STATE_KINDS)
def test_list_state_kinds_match_jax(kind):
    ref, got = _pair("state")
    assert got[kind] == ref[kind]


@pytest.mark.parametrize("key", ["nodes", "placed", "driver_pull",
                                 "worker_pull"])
def test_two_node_cluster_matches_jax(key):
    ref, got = _pair("cluster")
    assert got[key] == ref[key]


def test_live_actor_survives_a_stalled_head():
    """A head whose event loop stalls (its process starved on a loaded
    host) reads no health acks meanwhile; the port's head then gives every
    worker a fresh window, so a live actor is not killed for the head's
    own silence.  The JAX head kills it (``ActorDiedError``), a fault this
    port does not copy."""
    out = sc.result(sc.run("stalled_head", "ray_tpu_torch"))
    assert out == {"before": 1, "after": 2}
