"""The port's chaos tooling against the JAX package's: retriable work
finishes under a ``WorkerKiller`` on each package's cluster at once
(``tests/test_chaos.py``'s first test, ``_torch_train_scenarios.chaos``),
and the ``StragglerSchedule`` DSL picks the same victim rank and delays
from the same seed and spec."""

import time

import pytest

import _torch_train_scenarios as sc
from ray_tpu.util import chaos as jchaos
from ray_tpu_torch.util import chaos as tchaos

_results = {}


def test_retriable_work_survives_worker_chaos():
    if "chaos" not in _results:
        ref, got = sc.run_pair(["chaos"])
        _results["chaos"] = (ref["chaos"], got["chaos"])
    ref, got = _results["chaos"]
    assert got == ref
    assert got["results"] == [i * 2 for i in range(12)]
    assert got["fired"], "chaos never fired; the test proved nothing"


_SPECS = ["phase=data,ms=300,ranks=4,dur=6", "phase=compute,ms=150,rank=2",
          "phase=checkpoint,ms=5,ranks=8", "ms=40,ranks=16,at=0",
          "phase=data,ranks=3,at=100", ""]


@pytest.mark.parametrize("spec", _SPECS)
def test_straggler_schedule_matches_jax(spec):
    """For every seed, the same victim, window and per-(phase, rank)
    delay; ``describe`` reads the same."""
    for seed in range(12):
        j = jchaos.StragglerSchedule(spec, seed)
        t = tchaos.StragglerSchedule(spec, seed)
        assert (t.rank, t.phase, t.ms, t.at, t.dur) == \
            (j.rank, j.phase, j.ms, j.at, j.dur)
        assert t.describe() == j.describe()
        for phase in ("data", "compute", "checkpoint"):
            for rank in range(16):
                assert t.delay_s(phase, rank) == j.delay_s(phase, rank)


@pytest.mark.parametrize("spec", ["phase=gpu", "speed=3", "ms=fast"])
def test_bad_straggler_spec_raises_as_jax(spec):
    for mod in (jchaos, tchaos):
        with pytest.raises(ValueError):
            mod.StragglerSchedule(spec)


def test_armed_straggler_delays_its_victim_only():
    """``arm_straggler`` in this process, then ``maybe_straggle`` at the
    session's hooks: only the victim's phase sleeps, counted in
    ``delays``; disarmed, nothing does."""
    try:
        s = tchaos.arm_straggler("phase=compute,ms=30,rank=1", seed=0)
        t0 = time.perf_counter()
        assert tchaos.maybe_straggle("compute", 1) == 0.03
        assert time.perf_counter() - t0 >= 0.03
        assert tchaos.maybe_straggle("compute", 0) == 0.0
        assert tchaos.maybe_straggle("data", 1) == 0.0
        assert s.delays == 1
    finally:
        tchaos.disarm_straggler()
    assert tchaos.maybe_straggle("compute", 1) == 0.0
