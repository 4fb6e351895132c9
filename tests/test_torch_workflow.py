"""The port's workflows (``ray_tpu_torch.workflow``) against the JAX
package's: the scenarios ``workflow`` (test_workflow.py's chain, resume,
``run_async``, parallel branches, dynamic continuations, event steps and
the event timeout, in one cluster) and ``restart`` (a head SIGKILLed while
a workflow waits on a KV event and a job is submitted; the restarted head
keeps the job's rows and the resumed run loads its pre-event step from
storage, as test_workflow.py's and test_fault_tolerance.py's restarts)
of ``tests/_torch_lib_scenarios.py`` run once under each package, both
at once on this host, and every test compares one piece of the two
results."""

import pytest

import _torch_lib_scenarios as sc

_results = {}


def _runs():
    if "runs" not in _results:
        try:
            _results["runs"] = sc.run_pair(["workflow", "restart"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["runs"] = e
    if isinstance(_results["runs"], Exception):
        raise _results["runs"]
    return _results["runs"]


@pytest.mark.parametrize("key", [
    "chain", "resume", "run_async", "parallel", "dynamic", "event",
    "event_timeout"])
def test_workflow_matches_jax(key):
    ref, got = _runs()
    assert got["workflow"][key] == ref["workflow"][key]


@pytest.mark.parametrize("key", ["job_row", "resume"])
def test_head_restart_matches_jax(key):
    ref, got = _runs()
    assert got["restart"][key] == ref["restart"][key]


def test_workflow_values():
    """What test_workflow.py and test_fault_tolerance.py assert of the
    JAX package, of the port."""
    _, got = _runs()
    wf, rs = got["workflow"], got["restart"]
    assert wf["chain"] == sum(range(10)) * 2 + 5
    # Failed once, step one ran once and was not re-run by the resume.
    assert wf["resume"] == [True, "x", 20, "x", True, False]
    assert wf["run_async"] == 21
    assert wf["parallel"] == [6, True]
    assert wf["dynamic"] == [[0, 1, 4, 9, 16], 5, True]
    assert wf["event"] == ["got:payload", True, "got:payload"]
    assert wf["event_timeout"] == ["TimeoutError", True]
    assert rs["job_row"] == [True, "python -c 'print(42)'"]
    assert rs["resume"] == ["pre:late", True]


def test_default_storage_is_a_scratch_root():
    """Workflows persist under the port's own scratch root, apart from the
    JAX package's ``/tmp/ray_tpu_workflows``."""
    from ray_tpu_torch import workflow
    from ray_tpu_torch.core.config import tmp_root

    assert workflow.DEFAULT_STORAGE == tmp_root("workflows")
    assert workflow.DEFAULT_STORAGE.endswith("ray_tpu_torch_workflows")
