"""Tuner + trial controller (port of ``ray_tpu/tune/tuner.py``).

Role-equivalent to the reference's Tuner / TuneController event loop
(reference: tune/tuner.py:44, tune/execution/tune_controller.py:68 step:666)
over trial actors, with experiment state snapshots + resume
(tune/execution/experiment_state.py, Tuner.restore).

Function trainables report via ray_tpu_torch.tune.report(...) (reference:
tune/trainable/function_trainable.py session) or by returning a final
metrics dict.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ..core.config import tmp_root
from ..exceptions import RayTpuError
from .schedulers import CONTINUE, STOP, FIFOScheduler
from .search import generate_variants

PENDING, RUNNING, TERMINATED, ERROR, STOPPED = (
    "PENDING", "RUNNING", "TERMINATED", "ERROR", "STOPPED",
)


class TuneError(RayTpuError):
    pass


class TuneInterrupted(TuneError):
    """fit() was aborted; the experiment state on disk supports restore()."""


# ---------------------------------------------------------------- session


class _StopTrial(BaseException):
    """Raised inside the trainable when the scheduler stops the trial."""


class _TrialSession:
    def __init__(self, trial_id: str, trial_dir: str,
                 restore_path: Optional[str] = None):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.restore_path = restore_path
        self.queue: "queue.Queue" = queue.Queue()
        self.iteration = 0
        self.stop_requested = False
        # report() blocks until the controller acks the event (reference:
        # function_trainable.py _StatusReporter blocks on _continue_semaphore
        # until the driver consumed the result).  This makes scheduler
        # decisions synchronous with training: a STOP/exploit decision lands
        # before the trainable takes its next step, deterministically.
        # Sequence numbers (not a semaphore) so a backstop timeout cannot
        # leave a stale permit that desynchronizes every later decision:
        # the Nth report waits for the Nth ack, late acks just catch up.
        self._reported_seq = 0
        self._decided_seq = 0
        self._cv = threading.Condition()

    def ack(self, stop: bool = False):
        with self._cv:
            if stop:
                self.stop_requested = True
            self._decided_seq += 1
            self._cv.notify_all()

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[str] = None):
        self.iteration += 1
        out = dict(metrics)
        out.setdefault("training_iteration", self.iteration)
        ev = {"kind": "report", "metrics": out}
        if checkpoint is not None:
            ev["checkpoint"] = checkpoint
        self._reported_seq += 1
        seq = self._reported_seq
        self.queue.put(ev)
        # Wait for the controller's decision on THIS report.  The timeout is
        # a deadlock backstop (controller death); the kill path tears the
        # actor down anyway.
        with self._cv:
            self._cv.wait_for(lambda: self._decided_seq >= seq, timeout=60)
        if self.stop_requested:
            raise _StopTrial()


_session: Optional[_TrialSession] = None


def report(metrics: Dict[str, Any], checkpoint: Optional[str] = None) -> None:
    """Report intermediate metrics from inside a trial (reference:
    ray.tune.report / session.report).  ``checkpoint`` is a directory the
    trainable saved this round — registering it enables PBT exploitation
    and best-checkpoint tracking."""
    if _session is None:
        raise RuntimeError("tune.report() called outside a Tuner trial")
    _session.report(metrics, checkpoint=checkpoint)


def get_trial_dir() -> str:
    if _session is None:
        raise RuntimeError("not inside a Tuner trial")
    return _session.trial_dir


def get_checkpoint() -> Optional[str]:
    """Checkpoint directory to restore from, when the controller relaunched
    this trial from another trial's checkpoint (PBT exploit) or a prior run
    (reference: ray.tune.get_checkpoint)."""
    if _session is None:
        raise RuntimeError("not inside a Tuner trial")
    return _session.restore_path


@ray_tpu_torch.remote(max_concurrency=4)
class _TrialRunner:
    """Hosts one trial's function trainable; reports stream through poll()."""

    def __init__(self):
        self._session: Optional[_TrialSession] = None

    def run(self, fn_blob: bytes, config: dict, trial_id: str,
            trial_dir: str):
        global _session
        import ray_tpu_torch.tune.tuner as tuner_mod

        config = dict(config)
        restore_path = config.pop("_tune_restore_path", None)
        sess = _TrialSession(trial_id, trial_dir, restore_path=restore_path)
        self._session = sess
        tuner_mod._session = sess
        final: Dict[str, Any] = {}
        try:
            fn = cloudpickle.loads(fn_blob)
            out = fn(config)
            if isinstance(out, dict):
                out.setdefault("training_iteration", sess.iteration + 1)
                final = out
                sess.queue.put({"kind": "report", "metrics": out})
            sess.queue.put({"kind": "done", "status": TERMINATED,
                            "final": final})
        except _StopTrial:
            sess.queue.put({"kind": "done", "status": STOPPED, "final": {}})
        except BaseException as e:  # noqa: BLE001 — relayed to the driver
            import traceback

            sess.queue.put({
                "kind": "done", "status": ERROR,
                "error": f"{e}\n{traceback.format_exc()}",
            })

    def poll(self) -> List[dict]:
        out: List[dict] = []
        if self._session is None:
            return out
        while True:
            try:
                out.append(self._session.queue.get_nowait())
            except queue.Empty:
                return out

    def request_stop(self):
        """Out-of-band stop (interrupt paths): also releases a reporter
        blocked waiting for its ack so the stop lands immediately."""
        if self._session is not None:
            self._session.ack(stop=True)
        return True

    def ack(self, stop: bool = False):
        """Controller acknowledgment of one report event; ``stop`` rides
        along so stop-and-ack is atomic (no window where the trainable can
        take another step before the stop lands)."""
        if self._session is not None:
            self._session.ack(stop=stop)
        return True


# ------------------------------------------------------------------ trials


class Trial:
    def __init__(self, trial_id: str, config: dict):
        self.trial_id = trial_id
        self.config = config
        self.status = PENDING
        self.last_result: Dict[str, Any] = {}
        self.error: Optional[str] = None
        self.actor = None
        self.run_ref = None
        self.latest_checkpoint: Optional[str] = None
        # Set when a PBT exploit decision is in flight: the trial stops,
        # then relaunches from the source trial's checkpoint.
        self.pending_exploit: Optional[dict] = None

    def to_json(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": self.last_result,
            "error": self.error,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Trial":
        t = cls(d["trial_id"], d["config"])
        t.status = d["status"]
        t.last_result = d.get("last_result", {})
        t.error = d.get("error")
        return t


class Result:
    def __init__(self, trial: Trial):
        self.config = trial.config
        self.metrics = trial.last_result
        self.error = trial.error
        self.trial_id = trial.trial_id
        self.status = trial.status


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, i) -> Result:
        return Result(self._trials[i])

    def __iter__(self):
        return (Result(t) for t in self._trials)

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._trials if t.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise TuneError("no metric given (TuneConfig.metric or argument)")
        best = None
        for t in self._trials:
            if metric not in t.last_result:
                continue
            v = t.last_result[metric]
            if best is None or (v > best[0] if mode == "max" else v < best[0]):
                best = (v, t)
        if best is None:
            raise TuneError(f"no trial reported metric {metric!r}")
        return Result(best[1])

    def get_dataframe(self):
        rows = [
            {"trial_id": t.trial_id, "status": t.status,
             **{f"config/{k}": v for k, v in t.config.items()},
             **t.last_result}
            for t in self._trials
        ]
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows


# ------------------------------------------------------------------- config


class TuneConfig:
    """(reference: tune/tune_config.py TuneConfig)"""

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: str = "min",
        num_samples: int = 1,
        max_concurrent_trials: Optional[int] = None,
        scheduler=None,
        search_alg=None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        seed: int = 0,
    ):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.max_concurrent_trials = max_concurrent_trials
        self.scheduler = scheduler or FIFOScheduler()
        # Incremental searcher (search.Searcher, possibly wrapped in a
        # ConcurrencyLimiter); None -> eager variant expansion of
        # param_space (reference: tune_config.py search_alg).
        self.search_alg = search_alg
        self.resources_per_trial = resources_per_trial or {"CPU": 1}
        self.seed = seed


# -------------------------------------------------------------------- Tuner


def _trainer_trainable(trainer) -> Callable:
    """Adapt a DataParallelTrainer into a function trainable: each trial
    runs trainer.fit() with the trial's `train_loop_config` merged in
    (reference: BaseTrainer.fit wraps itself as_trainable and runs through
    Tune, train/base_trainer.py:111,567)."""

    def fn(config):
        import copy

        from ..train.config import RunConfig as TrainRunConfig

        t = copy.copy(trainer)
        loop_cfg = dict(t.train_loop_config or {})
        loop_cfg.update(config.get("train_loop_config", config) or {})
        t.train_loop_config = loop_cfg
        base_run = t.run_config or TrainRunConfig()
        t.run_config = TrainRunConfig(
            name="train",
            storage_path=get_trial_dir(),
            failure_config=base_run.failure_config,
            checkpoint_config=base_run.checkpoint_config,
        )
        # Bridge intermediate train.report rounds to the tune session so
        # schedulers (ASHA) can stop bad trials mid-run — a final-only
        # report would make early stopping inert.
        t._report_callback = report
        result = t.fit()
        if result.error is not None:
            raise result.error
        # Every round already reached the tune session via the callback;
        # returning metrics again would duplicate the final report.
        return None

    return fn


def _trainer_trial_resources(trainer, per_trial: Dict[str, float]) -> Dict[str, float]:
    """A trainer trial holds its own actor PLUS a nested worker gang; the
    concurrency cap must count both or trials saturate the cluster and the
    gangs inside them can never start (deadlock)."""
    eff = dict(per_trial)
    sc = trainer.scaling_config
    worker_res = sc.worker_resources()
    for res, amt in worker_res.items():
        eff[res] = eff.get(res, 0.0) + amt * sc.num_workers
    return eff


class Tuner:
    """(reference: tune/tuner.py:44 Tuner; fit -> tune_controller loop).

    `trainable` may be a plain function taking a config dict or a
    DataParallelTrainer/TorchTrainer instance (each trial runs fit() with
    the trial's train_loop_config merged in; a trainer's gang asks the
    cluster for its own cards, so on one card its trials run one at a time,
    and on a cluster with no card a GPU trainer's trial fails with the
    trainer's own error)."""

    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        _restored_trials: Optional[List[Trial]] = None,
        _experiment_dir: Optional[str] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        # train/ loads torch, so it is imported where it is used: a trial
        # actor running a plain function never pays for it.
        from ..train.config import RunConfig

        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._trials = _restored_trials
        self._experiment_dir = _experiment_dir
        # Test hook / Ctrl-C analog: set to interrupt fit() with state saved.
        self._abort = threading.Event()

    # -- state ------------------------------------------------------------

    def _state_path(self) -> str:
        return os.path.join(self._experiment_dir, "tuner_state.json")

    def _save_state(self):
        state = {
            "tune_config": {
                "metric": self.tune_config.metric,
                "mode": self.tune_config.mode,
            },
            "trials": [t.to_json() for t in self._trials],
        }
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, self._state_path())
        # Full config (scheduler, resources, concurrency) isn't JSON;
        # pickle it alongside so restore() keeps the experiment's behavior.
        cfg_path = os.path.join(self._experiment_dir, "tune_config.pkl")
        if not os.path.exists(cfg_path):
            try:
                with open(cfg_path, "wb") as f:
                    f.write(cloudpickle.dumps(self.tune_config))
            except Exception:
                pass

    @classmethod
    def restore(cls, experiment_dir: str, trainable: Callable,
                tune_config: Optional[TuneConfig] = None) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        results; pending/running ones run (again) (reference:
        Tuner.restore + experiment_state.py)."""
        with open(os.path.join(experiment_dir, "tuner_state.json")) as f:
            state = json.load(f)
        trials = [Trial.from_json(d) for d in state["trials"]]
        for t in trials:
            if t.status == RUNNING:  # interrupted mid-run: run again
                t.status = PENDING
        cfg = tune_config
        if cfg is None:
            cfg_path = os.path.join(experiment_dir, "tune_config.pkl")
            try:
                with open(cfg_path, "rb") as f:
                    cfg = cloudpickle.loads(f.read())
            except Exception:
                cfg = TuneConfig(**state["tune_config"])
        return cls(
            trainable,
            tune_config=cfg,
            _restored_trials=trials,
            _experiment_dir=experiment_dir,
        )

    # -- fit ---------------------------------------------------------------

    def fit(self) -> ResultGrid:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        cfg = self.tune_config
        if self._experiment_dir is None:
            name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
            storage = self.run_config.storage_path or tmp_root("results")
            self._experiment_dir = os.path.join(storage, name)
        os.makedirs(self._experiment_dir, exist_ok=True)
        searcher = cfg.search_alg
        if searcher is not None and self.param_space:
            raise TuneError(
                "pass the search space to the search_alg, not param_space — "
                "with search_alg set, param_space would be silently ignored"
            )
        if self._trials is None:
            if searcher is not None:
                # Incremental: trials materialize as the searcher suggests
                # them (bounded by num_samples) in the loop below.
                self._trials = []
            else:
                variants = generate_variants(
                    self.param_space, cfg.num_samples, cfg.seed
                )
                self._trials = [
                    Trial(f"trial_{i:05d}", v) for i, v in enumerate(variants)
                ]
        self._save_state()

        from ..train.trainer import DataParallelTrainer
        from ..train.worker_group import _dumps_by_value

        trainable = self.trainable
        if isinstance(trainable, DataParallelTrainer):
            # Serialize by value against the USER's module (the train loop's
            # defining module, typically a driver script workers can't
            # import), then wrap.
            import cloudpickle as _cp
            import sys as _sys

            mod = _sys.modules.get(
                getattr(trainable.train_loop, "__module__", None)
            )
            registered = False
            if mod is not None and mod.__name__ != "__main__":
                try:
                    _cp.register_pickle_by_value(mod)
                    registered = True
                except Exception:
                    pass
            try:
                fn_blob = _cp.dumps(_trainer_trainable(trainable))
            finally:
                if registered:
                    try:
                        _cp.unregister_pickle_by_value(mod)
                    except Exception:
                        pass
        else:
            fn_blob = _dumps_by_value(trainable)
        scheduler = cfg.scheduler
        # Placement capacity across every requested resource dimension: an
        # actor beyond capacity would never start and its poll would stall
        # the controller.  Trainer trials count their nested worker gang.
        cluster = ray_tpu_torch.cluster_resources()
        per_trial = cfg.resources_per_trial
        if isinstance(self.trainable, DataParallelTrainer):
            per_trial = _trainer_trial_resources(self.trainable, per_trial)
        capacity = min(
            (int(cluster.get(res, 0) // amt)
             for res, amt in per_trial.items() if amt > 0),
            default=1,
        )
        capacity = max(1, capacity)
        max_concurrent = min(
            cfg.max_concurrent_trials or capacity, capacity
        )
        opts = {"num_cpus": cfg.resources_per_trial.get("CPU", 1)}
        if cfg.resources_per_trial.get("GPU"):
            opts["num_gpus"] = cfg.resources_per_trial["GPU"]

        def launch(trial: Trial, extra_config: Optional[dict] = None):
            trial.actor = _TrialRunner.options(**opts).remote()
            trial_dir = os.path.join(self._experiment_dir, trial.trial_id)
            os.makedirs(trial_dir, exist_ok=True)
            run_cfg = dict(trial.config)
            if extra_config:
                run_cfg.update(extra_config)
            trial.run_ref = trial.actor.run.remote(
                fn_blob, run_cfg, trial.trial_id, trial_dir
            )
            trial.status = RUNNING
            if hasattr(scheduler, "on_trial_add"):
                scheduler.on_trial_add(trial.trial_id, trial.config,
                                       trial_dir)
            self._save_state()

        def scheduler_decision(trial: Trial, metrics: dict):
            """Old-style schedulers take (trial_id, result); context-aware
            ones (wants_context, e.g. PBT) also get checkpoint + config."""
            if getattr(scheduler, "wants_context", False):
                return scheduler.on_result(
                    trial.trial_id, metrics,
                    checkpoint=trial.latest_checkpoint,
                    config=trial.config,
                )
            return scheduler.on_result(trial.trial_id, metrics)

        pending = [t for t in self._trials if t.status == PENDING]
        suggested = len(self._trials)
        running: List[Trial] = []
        try:
            while pending or running or (
                searcher is not None and suggested < cfg.num_samples
            ):
                if self._abort.is_set():
                    raise TuneInterrupted(
                        f"experiment interrupted; restore from "
                        f"{self._experiment_dir}"
                    )
                # Pull new suggestions while capacity remains (reference:
                # tune_controller asks the search algorithm for the next
                # trial as slots free up).
                while (searcher is not None and suggested < cfg.num_samples
                       and len(running) + len(pending) < max_concurrent):
                    trial_id = f"trial_{suggested:05d}"
                    config = searcher.suggest(trial_id)
                    if config is None:
                        if not running and not pending:
                            # Nothing in flight and nothing suggested: the
                            # space is exhausted, not limiter-saturated.
                            suggested = cfg.num_samples
                        break
                    trial = Trial(trial_id, config)
                    suggested += 1
                    self._trials.append(trial)
                    pending.append(trial)
                # Launch up to the concurrency cap (the controller loop —
                # reference: tune_controller.py step:666).
                while pending and len(running) < max_concurrent:
                    trial = pending.pop(0)
                    launch(trial)
                    running.append(trial)
                # Drain reports per trial: one trial's dead worker (OOM,
                # segfault) must fail that trial, not the experiment
                # (reference: tune_controller handles trial-actor failure
                # by erroring the trial).
                still_running: List[Trial] = []
                for trial in running:
                    try:
                        events = ray_tpu_torch.get(
                            trial.actor.poll.remote(), timeout=120
                        )
                    except RayTpuError as e:
                        trial.status = ERROR
                        trial.error = f"trial actor died: {e}"
                        scheduler.on_complete(trial.trial_id,
                                              trial.last_result)
                        if searcher is not None:
                            searcher.on_trial_complete(trial.trial_id,
                                                       trial.last_result)
                        trial.actor = None
                        self._save_state()
                        continue
                    finished = False
                    for ev in events:
                        if ev["kind"] == "report":
                            trial.last_result = ev["metrics"]
                            if ev.get("checkpoint"):
                                trial.latest_checkpoint = ev["checkpoint"]
                            decision = scheduler_decision(
                                trial, ev["metrics"]
                            )
                            stop = decision == STOP
                            if (isinstance(decision, dict)
                                    and decision.get("decision") == "exploit"):
                                # PBT: stop, then relaunch from the source
                                # trial's checkpoint with perturbed config
                                # (reference: pbt.py _exploit).
                                trial.pending_exploit = decision
                                stop = True
                            # Every report must be acked — the trainable is
                            # blocked in report() until the decision lands.
                            try:
                                trial.actor.ack.remote(stop=stop)
                            except Exception:
                                pass
                        elif ev["kind"] == "done":
                            if trial.pending_exploit is not None \
                                    and ev["status"] == STOPPED:
                                exp = trial.pending_exploit
                                trial.pending_exploit = None
                                ray_tpu_torch.kill(trial.actor)
                                trial.config = exp["config"]
                                launch(trial, extra_config={
                                    "_tune_restore_path": exp["restore_from"]
                                })
                                continue
                            finished = True
                            trial.status = ev["status"]
                            if ev.get("final"):
                                trial.last_result = ev["final"]
                            if ev.get("error"):
                                trial.error = ev["error"]
                            scheduler.on_complete(
                                trial.trial_id, trial.last_result
                            )
                            if searcher is not None:
                                searcher.on_trial_complete(
                                    trial.trial_id, trial.last_result
                                )
                    if finished:
                        ray_tpu_torch.kill(trial.actor)
                        trial.actor = None
                        trial.run_ref = None
                        self._save_state()
                    else:
                        still_running.append(trial)
                running = still_running
                if running:
                    time.sleep(0.05)
        finally:
            for t in running:
                if t.actor is not None:
                    try:
                        ray_tpu_torch.kill(t.actor)
                    except Exception:
                        pass
            self._save_state()
        return ResultGrid(self._trials, cfg.metric, cfg.mode)
