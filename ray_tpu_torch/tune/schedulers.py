"""Trial schedulers: FIFO and ASHA early stopping.

Role-equivalent to the reference's FIFOScheduler and AsyncHyperBandScheduler
(reference: tune/schedulers/trial_scheduler.py, async_hyperband.py:36 — the
asynchronous successive-halving algorithm: rungs at grace_period *
reduction_factor^k; a trial reaching a rung continues only if its metric is
in the top 1/reduction_factor of results recorded at that rung).
"""

from __future__ import annotations

import math
from typing import Dict, List

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    """Run every trial to completion."""

    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE

    def on_complete(self, trial_id: str, result: Dict) -> None:
        pass


class _Rung:
    __slots__ = ("t", "recorded")

    def __init__(self, t: float):
        self.t = t
        self.recorded: Dict[str, float] = {}

    def cutoff(self, reduction_factor: float):
        """Values are normalized bigger-is-better; a trial survives the rung
        only if its value is >= the (1 - 1/rf) quantile of recorded values
        (keep the top 1/rf fraction — reference: async_hyperband.py cutoff
        via nanpercentile)."""
        values = sorted(self.recorded.values())
        k = int(math.floor(len(values) * (1 - 1 / reduction_factor)))
        if k <= 0:
            return None
        return values[min(k, len(values) - 1)]


class ASHAScheduler:
    """Asynchronous successive halving (reference: async_hyperband.py:36)."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 3,
    ):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.reduction_factor = reduction_factor
        self.rungs: List[_Rung] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(_Rung(t))
            t *= reduction_factor
        self.rungs.reverse()  # highest rung first (match a trial's furthest)

    def _value(self, result: Dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v  # normalize to bigger=better

    def on_result(self, trial_id: str, result: Dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return CONTINUE
        t = result[self.time_attr]
        value = self._value(result)
        decision = CONTINUE
        for rung in self.rungs:
            if t < rung.t or trial_id in rung.recorded:
                continue
            rung.recorded[trial_id] = value
            cutoff = rung.cutoff(self.reduction_factor)
            if cutoff is not None and value < cutoff:
                decision = STOP
            break  # only the highest newly-reached rung counts
        return decision

    def on_complete(self, trial_id: str, result: Dict) -> None:
        if result and self.metric in result and self.time_attr in result:
            for rung in self.rungs:
                if result[self.time_attr] >= rung.t \
                        and trial_id not in rung.recorded:
                    rung.recorded[trial_id] = self._value(result)


class MedianStoppingRule:
    """Stop a trial whose running mean falls below the median of other
    trials' running means (reference: tune/schedulers/median_stopping_rule.py
    MedianStoppingRule — the original Vizier rule)."""

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        grace_period: int = 1,
        min_samples_required: int = 3,
    ):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples_required = min_samples_required
        self._values: Dict[str, List[float]] = {}

    def _value(self, result: Dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_result(self, trial_id: str, result: Dict) -> str:
        if self.metric not in result or self.time_attr not in result:
            return CONTINUE
        self._values.setdefault(trial_id, []).append(self._value(result))
        if result[self.time_attr] < self.grace_period:
            return CONTINUE
        other_means = [
            sum(vs) / len(vs)
            for tid, vs in self._values.items()
            if tid != trial_id and vs
        ]
        if len(other_means) < self.min_samples_required:
            return CONTINUE
        import statistics

        median = statistics.median(other_means)
        mine = self._values[trial_id]
        if sum(mine) / len(mine) < median:
            return STOP
        return CONTINUE

    def on_complete(self, trial_id: str, result: Dict) -> None:
        pass


class PopulationBasedTraining:
    """PBT: bottom-quantile trials clone a top-quantile trial's checkpoint
    and continue with perturbed hyperparameters (reference:
    tune/schedulers/pbt.py PopulationBasedTraining — exploit via
    checkpoint copy, explore via resample-or-scale).

    Requires cooperative trainables: they must pass ``checkpoint=<dir>`` to
    ``tune.report`` and restore from ``tune.get_checkpoint()`` at start.
    The Tuner relaunches an exploited trial's function from the source
    trial's checkpoint with the perturbed config.
    """

    #: Tuner passes (result, checkpoint=..., config=...) to on_result.
    wants_context = True

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        perturbation_interval: int = 5,
        hyperparam_mutations: Dict | None = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: int = 0,
    ):
        assert mode in ("min", "max")
        assert 0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.perturbation_interval = perturbation_interval
        self.hyperparam_mutations = hyperparam_mutations or {}
        self.quantile_fraction = quantile_fraction
        self.resample_probability = resample_probability
        import random

        self._rng = random.Random(seed)
        self._scores: Dict[str, float] = {}        # latest normalized score
        self._checkpoints: Dict[str, str] = {}     # latest checkpoint dir
        self._configs: Dict[str, Dict] = {}
        self._last_perturb: Dict[str, float] = {}
        self.num_exploits = 0

    def _value(self, result: Dict) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    # -- explore -------------------------------------------------------------

    def _explore(self, config: Dict) -> Dict:
        """Perturb the source config (reference: pbt.py explore: resample
        with probability ``resample_probability``, else scale numeric values
        by 1.2/0.8 or step categorical values to a neighbor)."""
        new = dict(config)
        for key, spec in self.hyperparam_mutations.items():
            resample = self._rng.random() < self.resample_probability
            cur = new.get(key)
            if callable(spec):
                if resample or not isinstance(cur, (int, float)):
                    new[key] = spec()
                else:
                    new[key] = cur * self._rng.choice((0.8, 1.2))
            elif isinstance(spec, (list, tuple)):
                if resample or cur not in spec:
                    new[key] = self._rng.choice(list(spec))
                else:
                    i = list(spec).index(cur)
                    j = max(0, min(len(spec) - 1,
                                   i + self._rng.choice((-1, 1))))
                    new[key] = list(spec)[j]
            elif hasattr(spec, "sample"):  # search.Domain
                if resample or not isinstance(cur, (int, float)):
                    new[key] = spec.sample(self._rng)
                else:
                    new[key] = cur * self._rng.choice((0.8, 1.2))
            elif isinstance(cur, (int, float)):
                new[key] = cur * self._rng.choice((0.8, 1.2))
        return new

    # -- scheduler protocol ---------------------------------------------------

    def on_trial_add(self, trial_id: str, config: Dict, trial_dir: str):
        self._configs[trial_id] = dict(config)

    def on_result(self, trial_id: str, result: Dict, checkpoint=None,
                  config=None):
        if config is not None:
            self._configs[trial_id] = dict(config)
        if checkpoint:
            self._checkpoints[trial_id] = checkpoint
        if self.metric not in result or self.time_attr not in result:
            return CONTINUE
        t = result[self.time_attr]
        self._scores[trial_id] = self._value(result)
        if t - self._last_perturb.get(trial_id, 0) < self.perturbation_interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        if len(self._scores) < 2:
            return CONTINUE
        ranked = sorted(self._scores, key=self._scores.get)
        k = max(1, int(len(ranked) * self.quantile_fraction))
        bottom, top = ranked[:k], ranked[-k:]
        if trial_id not in bottom:
            return CONTINUE
        sources = [tid for tid in top
                   if tid != trial_id and tid in self._checkpoints]
        if not sources:
            return CONTINUE
        source = self._rng.choice(sources)
        self.num_exploits += 1
        return {
            "decision": "exploit",
            "config": self._explore(self._configs[source]),
            "restore_from": self._checkpoints[source],
            "source": source,
        }

    def on_complete(self, trial_id: str, result: Dict) -> None:
        # Completed trials stay in the population: their final scores keep
        # the quantiles honest and their checkpoints remain valid exploit
        # sources for stragglers.
        pass


class HyperBandScheduler:
    """Multi-bracket successive halving (reference:
    tune/schedulers/hyperband.py HyperBandScheduler — brackets trade off
    exploration breadth vs per-trial budget; Li et al. 2018).

    The asynchronous (infinite-horizon) variant: each trial is assigned
    round-robin to one of ``s_max + 1`` brackets; bracket ``s`` runs ASHA
    rungs starting at ``grace_period * eta**s`` so aggressive brackets
    stop early and conservative brackets let trials run long.  Decisions
    are rung-local and asynchronous — no pause/promote barrier — which is
    the same trade the reference's ASHA docs recommend over synchronous
    HyperBand for distributed execution.
    """

    def __init__(
        self,
        metric: str = "loss",
        mode: str = "min",
        time_attr: str = "training_iteration",
        max_t: int = 81,
        grace_period: int = 1,
        eta: float = 3,
    ):
        assert mode in ("min", "max")
        if eta <= 1:
            raise ValueError(f"eta must be > 1, got {eta}")
        if grace_period > max_t:
            raise ValueError(
                f"grace_period ({grace_period}) must be <= max_t ({max_t})")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.eta = eta
        self._brackets: List[ASHAScheduler] = []
        s = 0
        g = grace_period
        while g <= max_t:
            self._brackets.append(ASHAScheduler(
                metric=metric, mode=mode, time_attr=time_attr,
                max_t=max_t, grace_period=g, reduction_factor=eta,
            ))
            s += 1
            g = grace_period * int(eta ** s)
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def _bracket_of(self, trial_id: str) -> ASHAScheduler:
        idx = self._assignment.get(trial_id)
        if idx is None:
            idx = self._assignment[trial_id] = \
                self._next % len(self._brackets)
            self._next += 1
        return self._brackets[idx]

    @property
    def num_brackets(self) -> int:
        return len(self._brackets)

    def on_result(self, trial_id: str, result: Dict) -> str:
        return self._bracket_of(trial_id).on_result(trial_id, result)

    def on_complete(self, trial_id: str, result: Dict) -> None:
        self._bracket_of(trial_id).on_complete(trial_id, result)
