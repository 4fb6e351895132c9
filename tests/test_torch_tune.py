"""The port's ``tune`` against the JAX package's.

The pure parts run here under both packages on the same inputs: variant
generation (grids, random domains from one seed, nesting), ASHA, the
median rule, HyperBand and PBT deciding on the same result streams, the
concurrency limiter, and TPE's suggestions from one seed.  Then
``_torch_data_scenarios.tune`` runs ``tests/test_tune.py``'s Tuner cases
under each package (one process a package, both at once): the trials'
configs, statuses and metrics must be equal.  Every comparison is exact:
the same Python and numpy code runs on the same seeds."""

import os
import tempfile

import pytest

import _torch_data_scenarios as sc
from ray_tpu import tune as jtune
from ray_tpu_torch import tune as ttune

_results = {}


def _pair():
    """Both packages' ``tune`` results, computed once; a failure is kept
    too, so every test reports the one run's error."""
    if "pair" not in _results:
        try:
            ref, got = sc.run_pair(["tune"])
            _results["pair"] = (ref["tune"], got["tune"])
        except Exception as e:  # noqa: BLE001: re-raised by every test
            _results["pair"] = e
    if isinstance(_results["pair"], Exception):
        raise _results["pair"]
    return _results["pair"]


# ------------------------------------------------------------ pure parts


def _spaces(tune):
    return {
        "grid_random": ({"lr": tune.grid_search([0.1, 0.01]),
                         "wd": tune.grid_search([1, 2]),
                         "drop": tune.uniform(0, 1),
                         "lg": tune.loguniform(1e-4, 1e-1),
                         "n": tune.randint(1, 9),
                         "act": tune.choice(["relu", "gelu", "silu"]),
                         "fixed": 7}, 2, 1),
        "nested": ({"opt": {"lr": tune.uniform(0.1, 0.2),
                            "name": tune.grid_search(["adam", "sgd"])},
                    "layers": [1, 2]}, 1, 0),
        "samples": ({"x": tune.uniform(-1, 1)}, 5, 42),
    }


@pytest.mark.parametrize("space", ["grid_random", "nested", "samples"])
def test_generate_variants_match_jax(space):
    jspace, n, seed = _spaces(jtune)[space]
    tspace, _, _ = _spaces(ttune)[space]
    want = jtune.tuner.generate_variants(jspace, num_samples=n, seed=seed)
    got = ttune.tuner.generate_variants(tspace, num_samples=n, seed=seed)
    assert got == want
    if space == "grid_random":
        assert len(got) == 8
        assert all(v["fixed"] == 7 and 0 <= v["drop"] <= 1 for v in got)


def _stream(n_trials=9, steps=6, seed=0, rising=False):
    """A fixed interleaving of reports: trial i's score at step t, the
    later trials worse (lower, or higher when ``rising``)."""
    import random

    r = random.Random(seed)
    out = []
    for t in range(1, steps + 1):
        for i in range(n_trials):
            base = i if rising else 8 - i
            out.append((f"t{i}", {"score": base + r.random(),
                                  "training_iteration": t}))
    return out


def _decide(sched, stream):
    return [sched.on_result(tid, res) for tid, res in stream]


def _schedulers(tune):
    from importlib import import_module

    s = import_module(tune.__name__ + ".schedulers")
    return {
        "asha": lambda: tune.ASHAScheduler(metric="score", mode="max",
                                           max_t=27, grace_period=1,
                                           reduction_factor=3),
        "asha_min": lambda: tune.ASHAScheduler(metric="score", mode="min",
                                               max_t=9, grace_period=2,
                                               reduction_factor=2),
        "median": lambda: s.MedianStoppingRule(
            metric="score", mode="max", grace_period=2,
            min_samples_required=2),
        "hyperband": lambda: s.HyperBandScheduler(
            metric="score", mode="max", max_t=27, grace_period=1, eta=3),
    }


@pytest.mark.parametrize("name", ["asha", "asha_min", "median",
                                  "hyperband"])
def test_scheduler_decisions_match_jax(name):
    stream = _stream(rising=name == "asha_min")
    want = _decide(_schedulers(jtune)[name](), stream)
    got = _decide(_schedulers(ttune)[name](), stream)
    assert got == want
    assert "STOP" in got and "CONTINUE" in got


def test_asha_on_complete_and_rung_cut_match_jax():
    """``tests/test_tune.py``'s ASHA unit case, then completions."""
    out = []
    for tune in (jtune, ttune):
        sched = tune.ASHAScheduler(metric="score", mode="max", max_t=27,
                                   grace_period=1, reduction_factor=3)
        d = [sched.on_result(f"t{i}", {"score": 8 - i,
                                       "training_iteration": 1})
             for i in range(9)]
        for i in range(9):
            sched.on_complete(f"t{i}", {"score": 8 - i})
        d.append(sched.on_result("late", {"score": 100,
                                          "training_iteration": 3}))
        out.append(d)
    assert out[1] == out[0]
    assert out[1][0] == "CONTINUE" and out[1][8] == "STOP"


def _pbt_run(tune):
    pbt = tune.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0],
                              "wd": tune.uniform(0.0, 0.1)},
        seed=7)
    for tid, lr in (("hi", 1.0), ("mid", 0.5), ("lo", 0.1)):
        pbt.on_trial_add(tid, {"lr": lr, "wd": 0.05}, f"/tmp/{tid}")
    out = []
    for t in range(1, 7):
        for tid, lr in (("hi", 1.0), ("mid", 0.5), ("lo", 0.1)):
            out.append(pbt.on_result(
                tid, {"score": lr * t, "training_iteration": t},
                checkpoint=f"/ck/{tid}{t}", config={"lr": lr, "wd": 0.05}))
    pbt.on_complete("hi", {"score": 6.0})
    return out, pbt.num_exploits


def test_pbt_decisions_match_jax():
    want, wn = _pbt_run(jtune)
    got, gn = _pbt_run(ttune)
    assert got == want and gn == wn
    exploits = [d for d in got if isinstance(d, dict)]
    assert exploits and all(d["source"] in ("hi", "mid") for d in exploits)


def test_hyperband_rejects_degenerate_params():
    from ray_tpu_torch.tune.schedulers import HyperBandScheduler

    with pytest.raises(ValueError, match="eta"):
        HyperBandScheduler(metric="s", mode="max", eta=1)
    with pytest.raises(ValueError, match="grace_period"):
        HyperBandScheduler(metric="s", mode="max", grace_period=100,
                           max_t=81)


def _limiter(tune):
    from importlib import import_module

    s = import_module(tune.__name__ + ".search")
    lim = s.ConcurrencyLimiter(s.BasicVariantGenerator(
        {"x": tune.grid_search([1, 2, 3, 4]), "y": tune.uniform(0, 1)},
        num_samples=2, seed=3), max_concurrent=2)
    out = [lim.suggest("t0"), lim.suggest("t1"), lim.suggest("t2")]
    lim.on_trial_complete("t0", {})
    out += [lim.suggest(f"t{i}") for i in range(3, 12)]
    for i in range(1, 12):
        lim.on_trial_complete(f"t{i}", {})
    out += [lim.suggest("t12")]
    return out


def test_concurrency_limiter_matches_jax():
    want, got = _limiter(jtune), _limiter(ttune)
    assert got == want
    assert got[2] is None and got[3] is not None


def _tpe(tune):
    from importlib import import_module

    s = import_module(tune.__name__ + ".search")

    def objective(x, y, kind, n):
        return (x - 2.0) ** 2 + (y - 0.5) ** 2 + (kind != "good") * 5.0 + n

    searcher = s.TPESearcher(
        {"x": tune.uniform(-10.0, 10.0), "y": tune.loguniform(0.01, 3.0),
         "kind": tune.choice(["good", "bad"]), "n": tune.randint(0, 3)},
        metric="loss", mode="min", n_initial=10, seed=7)
    history = []
    for i in range(40):
        cfg = searcher.suggest(f"t{i}")
        history.append(cfg)
        searcher.on_trial_complete(f"t{i}", {"loss": objective(**cfg)})
    return history


def test_tpe_suggestions_match_jax():
    """TPE from the same seed makes the same 40 suggestions (10 random,
    then 30 from its densities)."""
    got = _tpe(ttune)
    assert got == _tpe(jtune)
    assert len(got) == 40


def test_tuner_results_root_is_the_ports(tmp_path, monkeypatch):
    """With no ``storage_path`` an experiment goes under
    ``ray_tpu_torch_results`` in the temp dir (the JAX tuner's is
    ``ray_tpu_results``), so the two packages never share one."""
    import ray_tpu_torch as rt

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    tuner = ttune.Tuner(lambda c: {"v": 1},
                        run_config=rt.train.RunConfig(name="exp"))
    monkeypatch.setattr(rt, "is_initialized", lambda: True)
    monkeypatch.setattr(rt, "cluster_resources", lambda: {"CPU": 0.0})
    tuner._trials = []  # nothing to run: fit() only lays out the dir
    tuner.fit()
    assert os.path.isdir(tmp_path / "ray_tpu_torch_results" / "exp")
    assert os.path.exists(tmp_path / "ray_tpu_torch_results" / "exp"
                          / "tuner_state.json")


def test_tune_imports_no_torch():
    """A trial actor running a plain function loads the tune package
    only: ``train/`` (and torch) load where a trainer is used."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", "import sys, ray_tpu_torch.tune; "
         "print('torch' in sys.modules)"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]


# -------------------------------------------------------------- scenarios

CASES = ["grid_fifo", "actor_death", "asha", "over_trainer", "restore",
         "pbt", "searcher", "tpe_tuner"]


@pytest.mark.parametrize("case", CASES)
def test_tuner_matches_jax(case):
    ref, got = _pair()
    assert got[case] == ref[case]


def test_tuner_values():
    """The values ``tests/test_tune.py`` asserts of the JAX package, read
    from the port's run."""
    _, got = _pair()
    trials, errors, best_lr, best_loss = got["grid_fifo"]
    assert len(trials) == 4 and errors == [] and best_lr == 1.0
    assert best_loss == 1.0
    assert got["actor_death"] == [[[0, "TERMINATED"], [1, "ERROR"],
                                   [2, "TERMINATED"]], 2, 1]
    assert got["asha"] == [8, True, 7, "TERMINATED"]
    n, errors, lr, loss, _ = got["over_trainer"]
    assert (n, errors, lr, loss) == (3, [], 0.1, 0.01)
    assert got["restore"][:3] == [[], True, 8] and got["restore"][4:] == [
        True, 7]
    trials, exploits = got["pbt"]
    assert exploits >= 2
    scores = sorted(t[2]["score"] for t in trials)
    assert scores[-1] >= 20.0 - 1e-6 and scores[1] > 2.0 + 1e-6
    assert got["searcher"][1] == 10
    assert got["tpe_tuner"][:3] == [12, True, True]
