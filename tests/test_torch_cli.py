"""The port's CLI (``python -m ray_tpu_torch``) against the JAX package's
(``python -m ray_tpu``): the scenario ``cli`` of
``tests/_torch_lib_scenarios.py`` runs every subcommand that
test_observability.py, test_flight_recorder.py and test_tracing.py drive
against each package's live cluster (list, status, summary, metrics,
timeline, events, logs, stack, step records through list/status/top,
profile, logs --post-mortem, trace), then ``serve deploy`` of a JSON and
a YAML file and ``down``; both at once on this host, every test comparing
one piece of the two results.  Then the port alone: ``lint``'s declared
refusal, the host trace ``profile`` writes for a worker granted no card,
the address's order of precedence, and the CLI's modules loading no
torch."""

import json
import os
import subprocess
import sys

import pytest

import _torch_lib_scenarios as sc

_results = {}

_STATE = ["list_actors", "status", "summary", "metrics", "timeline",
          "list_pgs", "events", "events_errors", "events_task", "logs"]


def _cli():
    if "cli" not in _results:
        try:
            ref, got = sc.run_pair(["cli"])
            _results["cli"] = (ref["cli"], got["cli"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["cli"] = e
    if isinstance(_results["cli"], Exception):
        raise _results["cli"]
    return _results["cli"]


@pytest.mark.parametrize("key", _STATE)
def test_state_commands_match_jax(key):
    ref, got = _cli()
    assert got["state"][key] == ref["state"][key]
    assert got["state"][key][0] == 0 and all(got["state"][key][1:])


@pytest.mark.parametrize("key", [
    "stack", "dead_log", "engine_steps", "profile", "post_mortem", "trace",
    "serve_deploy", "help", "down"])
def test_commands_match_jax(key):
    ref, got = _cli()
    assert got[key] == ref[key]


def test_command_values():
    """What the JAX package's tests assert of its CLI, of the port's."""
    _, got = _cli()
    assert got["stack"] == [0, True, True]
    assert got["dead_log"] == [True, True, 0, True, True]
    assert got["engine_steps"] == [5, [0, True], [0, True, True],
                                   [0, True, True, True]]
    # The capture: rc 0, its trace dir, a trace written, the actor still
    # serving; an unknown worker a clean error.
    assert got["profile"] == [6, True, 0, True, True, True, True, 1, True]
    assert got["post_mortem"] == [True, True, 0, True, True]
    assert got["trace"] == [[0, True, True], [0, True, True, True, True],
                            [0, 5, 2], 1]
    assert got["serve_deploy"] == [
        {"json": [0, True, True], "yaml": [0, True, True]},
        ["hey, you", "hey, you"], [0, True, True], [0, True]]
    assert got["down"] == [0, True, True]


def test_profile_traces_an_ungranted_worker_host():
    """``profile`` of a worker granted no card captures its host with
    ``torch.profiler``: the Chrome trace holds events."""
    _, got = _cli()
    assert got["profile_trace"] == [0, True]


def test_lint_is_a_declared_refusal():
    """The port has no rtlint yet: ``lint`` exits 2 and names the ROADMAP
    item that ports it (the JAX package's lint runs and passes)."""
    ref, got = _cli()
    assert ref["lint"][0] == 0
    rc, err = got["lint"]
    assert rc == 2
    assert "not ported" in err and "devtools" in err and "ROADMAP" in err


def test_help_lists_every_jax_subcommand():
    """``--help`` lists the JAX CLI's subcommands, no more and no fewer,
    and ``list`` shows the same columns of each kind."""
    from ray_tpu import scripts as jscripts
    from ray_tpu_torch import scripts as tscripts

    ref, got = _cli()
    assert got["help"][0] == 0
    assert got["help"][1] == ref["help"][1]
    assert len(got["help"][1]) == 18
    assert tscripts._LIST_COLUMNS == jscripts._LIST_COLUMNS


def test_address_precedence(tmp_path, monkeypatch):
    """``--address``, then ``RT_TORCH_ADDRESS``, then the address file
    that ``init()`` writes under the temp dir (the JAX package's
    ``RT_ADDRESS`` is not read)."""
    from ray_tpu_torch import scripts
    from ray_tpu_torch.core import config

    monkeypatch.setattr(config.tempfile, "tempdir", str(tmp_path))
    monkeypatch.delenv("RT_TORCH_ADDRESS", raising=False)
    monkeypatch.setenv("RT_ADDRESS", "127.0.0.1:1")
    with pytest.raises(SystemExit, match="RT_TORCH_ADDRESS"):
        scripts._resolve_address(None)
    path = config.address_file()
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        f.write("127.0.0.1:3\n")
    assert scripts._resolve_address(None) == "127.0.0.1:3"
    monkeypatch.setenv("RT_TORCH_ADDRESS", "127.0.0.1:2")
    assert scripts._resolve_address(None) == "127.0.0.1:2"
    assert scripts._resolve_address("127.0.0.1:4") == "127.0.0.1:4"


def test_cli_and_libraries_load_no_torch():
    """The CLI, the dashboard, job submission, workflows, DAGs and the
    util modules import neither torch nor the JAX package, so a CLI call
    and a CPU actor of these libraries start fast."""
    mods = ["ray_tpu_torch.scripts", "ray_tpu_torch.dashboard",
            "ray_tpu_torch.job_submission", "ray_tpu_torch.workflow",
            "ray_tpu_torch.dag", "ray_tpu_torch.util",
            "ray_tpu_torch.util.multiprocessing"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "import json; print(json.dumps(sorted(m for m in sys.modules"
              " if m.split('.')[0] in ('jax', 'ray_tpu', 'torch'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
