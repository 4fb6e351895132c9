"""Worker-side train session: report(), get_checkpoint(), rank info, dataset
shards (port of ``ray_tpu/train/session.py``).

Role-equivalent to the reference's per-worker _TrainSession
(reference: train/_internal/session.py — report:403, public report:667,
get_checkpoint:754) with the same synchronous-collective semantics: report()
blocks until the driver has consumed the round, keeping workers in lockstep
(which is exactly what an SPMD gang wants).
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, Optional

from .checkpoint import Checkpoint

_session: Optional["TrainSession"] = None

_m_data_wait = None


def _observe_data_wait(seconds: float) -> None:
    """Rank-side data-wait histogram — lazily resolved so sessions built
    directly in unit tests don't spin up the metrics registry."""
    global _m_data_wait
    try:
        from ..util.metrics import get_histogram

        if _m_data_wait is None:
            _m_data_wait = get_histogram(
                "ray_tpu_gang_data_wait_seconds",
                "Per-round dataset wait observed by one gang rank")
        _m_data_wait.observe(seconds)
    except Exception:
        pass  # metrics must never fail a training round


class _TimedShard:
    """Transparent dataset-shard proxy: times blocking iteration (and any
    ``iter_batches`` stream) so report() can attribute the round's data
    wait.  Everything else delegates to the wrapped shard."""

    def __init__(self, shard, session: "TrainSession"):
        self._shard = shard
        self._session = session

    def __getattr__(self, name):
        return getattr(self._shard, name)

    def __iter__(self):
        return self._timed(iter(self._shard))

    def iter_batches(self, *args, **kwargs):
        return self._timed(self._shard.iter_batches(*args, **kwargs))

    def _timed(self, it: Iterator):
        import time as _time

        from ..util import chaos as _chaos

        s = self._session
        while True:
            t0 = _time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                s._data_wait_s += _time.perf_counter() - t0
                return
            # Chaos straggler injection ("data"): inside the timed window,
            # so the injected delay is attributed as data wait.
            _chaos.maybe_straggle("data", s.world_rank)
            s._data_wait_s += _time.perf_counter() - t0
            yield item


class TrainSession:
    def __init__(
        self,
        world_rank: int,
        world_size: int,
        trial_dir: str,
        restored_checkpoint: Optional[Checkpoint],
        dataset_shards: Optional[Dict[str, Any]] = None,
    ):
        self.world_rank = world_rank
        self.world_size = world_size
        self.trial_dir = trial_dir
        self.restored_checkpoint = restored_checkpoint
        self.dataset_shards = dataset_shards or {}
        # Set at worker setup when ScalingConfig.mesh is given: the
        # DeviceMesh over the gang that every rank shards its train step
        # over (ray_tpu_torch.train.get_mesh()).
        self.mesh = None
        # Name of the gang's host-side collective group (cross-worker
        # allreduce of metrics/grads outside compiled programs).
        self.collective_group: Optional[str] = None
        self.result_queue: "queue.Queue" = queue.Queue()
        self.consumed = threading.Semaphore(0)
        self.step = 0
        self.finished = False
        # Preemption drain: the DRIVER observes node drains and piggybacks
        # the signal on the lockstep ack (see ack(should_checkpoint=True)),
        # so every rank's should_checkpoint() flips at the same round
        # boundary — a gang-wide same-step drain save (per-rank pubsub
        # delivery would skew ranks by a round and persist partial-rank
        # checkpoints).  Reporting a checkpoint clears the flag.
        self._drain_pending = False
        # Peer-replicated in-memory checkpoints: ring successor's actor
        # handle + cadence (set by WorkerGroup after all ranks are placed),
        # and this process's view of replicated snapshots —
        # {rank: [(step, ObjectRef-of-packed-dir), ...]} holding its OWN
        # latest snapshots plus any peer snapshots pushed to it.  The last
        # TWO per rank are kept: lockstep reporting bounds rank skew to one
        # round, so two generations guarantee a common step exists across
        # the gang even when a node dies mid-round.
        self._peer_handle = None
        self._memory_every_k: Optional[int] = None
        self._ckpt_count = 0
        # Guarded by _snapshots_lock: pushed to by the peer's RPC thread
        # while the train loop replicates and the driver collects.
        self.memory_snapshots: Dict[int, list] = {}
        self._snapshots_lock = threading.Lock()
        # Goodput accounting (train/telemetry.py): report() derives step
        # time / tokens-per-sec / MFU per round and both sets the
        # ray_tpu_train_* gauges and merges the numbers into the reported
        # metrics.  Created lazily so sessions built directly in unit
        # tests don't spin up the metrics flusher.
        self._telemetry = None
        self._last_report_t: Optional[float] = None
        # Gang round flight recorder (util/gangrec.py): every report()
        # appends ONE fixed-size record attributing the round across
        # data / compute / collective / checkpoint / lockstep-ack, joined
        # head-side by (gang, round) into skew profiles.  gang_id is set
        # by WorkerGroup.setup (one id per gang incarnation); the phase
        # accumulators are touched only by the train loop thread —
        # report() is synchronous — so they need no lock.
        self.gang_id: Optional[str] = None
        self._data_wait_s = 0.0
        self._coll_base: Optional[Dict[str, Any]] = None
        self._compile_base = 0.0

    @property
    def telemetry(self):
        if self._telemetry is None:
            from .telemetry import TrainTelemetry

            self._telemetry = TrainTelemetry(rank=self.world_rank)
        return self._telemetry

    # ---- drain / in-memory replication wiring -------------------------------

    def should_checkpoint(self) -> bool:
        """True when a preemption drain was announced and no checkpoint has
        been reported since — the user loop should save NOW, ahead of its
        periodic cadence (reference shape: TorchTitan/elastic trainers
        checkpoint on SIGTERM notice)."""
        return self._drain_pending

    def configure_memory_checkpoints(self, peer_handle,
                                     every_k: Optional[int]) -> None:
        self._peer_handle = peer_handle
        self._memory_every_k = every_k

    def remember_snapshot(self, rank: int, step: int, ref) -> None:
        """Record an in-memory snapshot handle for ``rank``, keeping the
        last two generations (older refs drop → their store segments free)."""
        with self._snapshots_lock:
            entries = self.memory_snapshots.setdefault(rank, [])
            entries.append((step, ref))
            del entries[:-2]

    def snapshot_view(self) -> Dict[int, list]:
        """Consistent copy of the replica table (safe against concurrent
        peer pushes)."""
        with self._snapshots_lock:
            return {r: list(v) for r, v in self.memory_snapshots.items()}

    def _replicate_checkpoint(self, staged_dir: str) -> None:
        """Push this rank's host snapshot into the object store (own node)
        and to its ring peer's store, so a new gang can restore from memory
        after this rank's node dies.  Best-effort: replication must never
        fail a training round."""
        import ray_tpu_torch

        from .checkpoint import pack_directory

        blob = pack_directory(staged_dir)
        # Own copy: survives THIS PROCESS dying (worker crash) as long as
        # the node's store daemon lives; the driver re-owns it at collection.
        self.remember_snapshot(self.world_rank, self.step,
                               ray_tpu_torch.put(blob))
        if self._peer_handle is not None:
            # Peer copy: survives this NODE dying.  CONFIRMED, not fire-and-
            # forget: the trainer skips the disk write on the strength of
            # this replica, so an unacknowledged push must surface here
            # (the caller then reports memory_replicated=False and the
            # round persists to disk instead).  No await cycle: the peer's
            # handler only does a local put on its own concurrency slot.
            ray_tpu_torch.get(
                self._peer_handle.store_peer_snapshot.remote(
                    self.world_rank, self.step, blob
                ),
                timeout=30.0,
            )

    # ---- called from user train loop ----------------------------------------

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        import time as _time

        from ..util import chaos as _chaos

        # Chaos straggler injection ("compute"): a slowdown here is
        # indistinguishable from a slow step body — it lands in the round
        # record's compute residual.
        _chaos.maybe_straggle("compute", self.world_rank)
        self.step += 1
        metrics = self._augment_metrics(dict(metrics))
        persisted = None
        replicated = False
        ckpt_s = 0.0
        if checkpoint is not None:
            ckpt_t0 = _time.perf_counter()
            _chaos.maybe_straggle("checkpoint", self.world_rank)
            # Stage the worker's checkpoint under the trial dir so it outlives
            # the user's temp directory.
            dest = os.path.join(
                self.trial_dir, "staging",
                f"step_{self.step:06d}_rank_{self.world_rank}",
            )
            # A restarted gang may stage the same step again: fresh files,
            # never a rewrite of ones the trainer has linked into storage.
            shutil.rmtree(dest, ignore_errors=True)
            shutil.copytree(checkpoint.path, dest, dirs_exist_ok=True)
            persisted = dest
            self._ckpt_count += 1
            drain_save = self._drain_pending
            self._drain_pending = False
            if self._memory_every_k is not None and (
                    drain_save
                    or (self._ckpt_count % self._memory_every_k) == 0):
                try:
                    self._replicate_checkpoint(dest)
                    replicated = True
                except Exception:
                    pass  # replication is best-effort by design
            ckpt_s = _time.perf_counter() - ckpt_t0
        else:
            drain_save = False
        self.result_queue.put(
            {"metrics": metrics, "checkpoint_dir": persisted,
             "step": self.step, "rank": self.world_rank,
             "drain": drain_save, "memory_replicated": replicated}
        )
        # Lockstep with the driver (reference behavior: session.report blocks
        # until the round is processed).
        ack_t0 = _time.perf_counter()
        self.consumed.acquire()
        now = _time.perf_counter()
        self._emit_round(metrics, ckpt_s=ckpt_s, ack_s=now - ack_t0)
        # Step time measures the user's loop body, not the driver's round
        # processing: restart the clock after the lockstep wait returns.
        self._last_report_t = _time.perf_counter()

    def _emit_round(self, metrics: Dict[str, Any], *, ckpt_s: float,
                    ack_s: float) -> None:
        """Append this round's flight record (util/gangrec.py).  All the
        goodput numbers come from the SAME telemetry.record_step sample
        that _augment_metrics merged into the reported metrics — the round
        record and the metrics history can never disagree.  Best-effort:
        recording must never fail a training round."""
        try:
            import time as _time

            from ..collective import collective as _coll
            from ..util import gangrec

            tel = self.telemetry.last
            totals = _coll.op_totals()
            base = self._coll_base or {"ops": 0, "wall_s": 0.0, "bytes": 0}
            self._coll_base = totals
            compile_total = float(getattr(
                self._telemetry, "_compile_total", 0.0) or 0.0)
            compile_s = max(0.0, compile_total - self._compile_base)
            self._compile_base = compile_total
            data_s, self._data_wait_s = self._data_wait_s, 0.0
            rec = {
                "gang": self.gang_id or self.collective_group or "local",
                "rank": self.world_rank,
                "world": self.world_size,
                "round": self.step,
                "t": _time.time(),
                "wall_s": round(float(tel.get("step_time_s", 0.0)), 6),
                "data_s": round(data_s, 6),
                "coll_s": round(
                    max(0.0, totals["wall_s"] - base["wall_s"]), 6),
                "coll_bytes": max(0, totals["bytes"] - base["bytes"]),
                "ack_s": round(ack_s, 6),
                "ckpt_s": round(ckpt_s, 6),
                "compile_s": round(compile_s, 6),
                "tokens": metrics.get("tokens"),
                "tps": tel.get("tokens_per_sec"),
                "mfu": tel.get("mfu"),
            }
            gangrec.record_round(rec)
            if data_s > 0:
                _observe_data_wait(data_s)
        except Exception:
            pass

    def _augment_metrics(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Derive goodput numbers for this report round.  Step time is the
        wall clock since the previous report returned (the user's loop
        body); ``tokens``/``flops_per_step`` keys in the reported metrics
        opt into tokens/sec and MFU.  User-provided keys always win."""
        import time as _time

        now = _time.perf_counter()
        prev, self._last_report_t = self._last_report_t, now
        if prev is None:
            return metrics
        try:
            derived = self.telemetry.record_step(
                now - prev,
                tokens=metrics.get("tokens"),
                flops=metrics.get("flops_per_step"),
            )
            for k, v in derived.items():
                metrics.setdefault(k, v)
        except Exception:
            pass  # goodput accounting must never fail a training round
        return metrics

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.restored_checkpoint

    def get_dataset_shard(self, name: str = "train"):
        shard = self.dataset_shards.get(name)
        if shard is None:
            raise KeyError(f"no dataset shard named {name!r}")
        return _TimedShard(shard, self)

    # ---- called from the actor's polling method -----------------------------

    def next_result(self, timeout: float = 3600.0) -> Optional[dict]:
        try:
            return self.result_queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def ack(self, should_checkpoint: bool = False):
        """Driver's round acknowledgment.  ``should_checkpoint=True``
        carries a drain notice: set BEFORE the semaphore release so the
        rank observes it on its very next should_checkpoint() poll — and,
        because every rank's ack for a round carries the same flag, the
        whole gang saves the SAME step."""
        if should_checkpoint:
            self._drain_pending = True
        self.consumed.release()


def init_session(**kwargs) -> TrainSession:
    global _session
    _session = TrainSession(**kwargs)
    return _session


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No train session: this API must be called inside a train loop "
            "launched by a Trainer."
        )
    return _session


def shutdown_session():
    global _session
    _session = None


# ---- public module-level API (mirrors ray.train.*) --------------------------


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_session().get_dataset_shard(name)


def get_mesh():
    """The ``DeviceMesh`` over the gang built from ScalingConfig.mesh (None
    when the trainer was not configured with a mesh)."""
    return get_session().mesh


def should_checkpoint() -> bool:
    """True when the cluster announced a preemption (node drain) and this
    worker should checkpoint NOW, ahead of its periodic cadence.  Cleared
    by the next report() that carries a checkpoint."""
    return get_session().should_checkpoint()


class TrainContext:
    def get_world_rank(self) -> int:
        return get_session().world_rank

    def get_world_size(self) -> int:
        return get_session().world_size

    def get_trial_dir(self) -> str:
        return get_session().trial_dir


def get_context() -> TrainContext:
    return TrainContext()
