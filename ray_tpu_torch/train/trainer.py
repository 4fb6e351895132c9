"""DataParallelTrainer: drive a gang of train workers to completion (port of
``ray_tpu/train/trainer.py``).

Role-equivalent to the reference's DataParallelTrainer.training_loop over a
BackendExecutor (reference: train/data_parallel_trainer.py:25,428;
_internal/backend_executor.py:135,451,578), with elastic restart from the
latest checkpoint on worker failure (FailureConfig — reference:
backend_executor worker-group restart semantics).
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ..core.config import tmp_root
from ..exceptions import ActorDiedError, RayTpuError, WorkerCrashedError
from .checkpoint import Checkpoint, CheckpointManager
from .config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from .worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TrainingFailedError(RayTpuError):
    pass


# Guards every set/consume of a trainer's one-shot _drain_requested flag
# (pubsub thread vs drive loop).  Module-level, not per-instance: trainers
# must stay picklable (the Tuner ships them to trial actors), and the
# critical sections are two-instruction swaps — coarse sharing is free.
_drain_flag_lock = threading.Lock()


def _quiet_demand_pg(resources: Dict[str, float], bundles: int):
    """Best-effort demand signal: a placement group of ``bundles`` worker-
    shaped bundles, created without the may-not-fit warning (not fitting is
    the point — pending PGs are what the autoscaler scales against).
    Returns None on failure."""
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return ray_tpu_torch.placement_group(
                [dict(resources) for _ in range(bundles)]
            )
    except Exception:
        return None


class DataParallelTrainer:
    """Runs `train_loop_per_worker` on `scaling_config.num_workers` actors.

    The worker loop uses ray_tpu_torch.train.report/get_checkpoint/
    get_mesh — same shape as the reference's ray.train API.  ``datasets=``
    waits for the port of ``ray_tpu/data/`` and raises until then.
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        if datasets:
            raise NotImplementedError(
                "datasets= needs ray_tpu_torch.data, which is not ported "
                "yet (ROADMAP.md Queue 1, the data/ item); read the data "
                "inside the train loop until then")
        self.train_loop = train_loop_per_worker
        self.train_loop_config = train_loop_config
        self.scaling_config = scaling_config or ScalingConfig()
        if self.scaling_config.mesh is not None:
            # The mesh spans the gang: one position a worker.
            self.scaling_config.mesh.resolve(self.scaling_config.num_workers)
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        # Optional hook: called with each report round's metrics (the Tuner
        # bridges this to tune.report so ASHA can early-stop trainer trials).
        self._report_callback = None
        # World size of the CURRENT gang incarnation (elastic restarts may
        # run below num_workers) and the session step of the last disk
        # checkpoint this incarnation (memory-replica freshness gate).
        self.world_size = self.scaling_config.num_workers
        self._last_disk_ckpt_step = 0
        self._ckpt_rounds = 0
        self._disk_every_k = 1
        # Driver-observed preemption notice for the CURRENT gang: set by the
        # node_events subscription (installed for the duration of fit(),
        # removed after — a leaked handler would pin this trainer forever),
        # relayed to every rank on the same lockstep ack so the whole gang
        # drain-saves the same step.
        self._drain_requested = False
        self._gang_nodes: set = set()
        self._drain_handler = None
        # Newest disk-skipped checkpoint round, held on the driver's disk
        # as (step, merged_dir, metrics) until a newer round persists.
        self._pending_skipped = None
        # Standing demand for the capacity a downsized gang is missing
        # (num_workers - world bundles): the autoscaler backfills against
        # it so the next restart can upsize.  Removed before capacity
        # measurement and at fit() exit.
        self._backfill_pg = None

    # ------------------------------------------------------------------ fit

    def _check_cards(self) -> None:
        """A GPU gang on a cluster with no card would park its workers
        forever: refuse it, and never train it on the CPU instead."""
        need = self.scaling_config.worker_resources().get("GPU", 0)
        have = ray_tpu_torch.cluster_resources().get("GPU", 0)
        if need and have < need:
            raise RuntimeError(
                f"ScalingConfig asks {need:g} GPU a worker and the cluster "
                f"has {have:g}; pass ScalingConfig(use_gpu=False) to train "
                "on the CPU")

    def _install_drain_subscription(self) -> None:
        """Listen for head-announced node drains (preemption notices).  A
        drain of any node hosting a gang member flips _drain_requested; the
        drive loop relays it on the next round's acks, so every rank's
        should_checkpoint() flips at the SAME step (per-rank pubsub would
        skew ranks by a round and persist partial-rank checkpoints)."""
        if self._drain_handler is not None:
            return
        from ..core.context import ctx

        if ctx.client is None:
            return

        def on_event(data):
            if not (isinstance(data, dict) and data.get("event") == "drain"):
                return
            # Unknown gang membership (empty set) counts as relevant —
            # better a spurious checkpoint than a missed grace window.
            if self._gang_nodes and data.get("node_id") not in self._gang_nodes:
                return
            with _drain_flag_lock:
                self._drain_requested = True

        ctx.client.subscribe("node_events", on_event)
        self._drain_handler = on_event

    def _consume_drain_notice(self) -> bool:
        """Atomically read-and-clear the one-shot drain notice: a lock-free
        swap could overwrite a notice the pubsub thread set mid-swap, and
        node_drain publishes exactly once per node."""
        with _drain_flag_lock:
            drain, self._drain_requested = self._drain_requested, False
            return drain

    def _remove_drain_subscription(self) -> None:
        handler, self._drain_handler = self._drain_handler, None
        if handler is None:
            return
        from ..core.context import ctx

        try:
            if ctx.client is not None:
                ctx.client.unsubscribe("node_events", handler)
        except Exception:
            pass

    def fit(self) -> Result:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._check_cards()
        try:
            self._install_drain_subscription()
        except Exception:
            pass  # drain relay is an optimization, never a fit() blocker
        try:
            return self._fit()
        finally:
            # Handler removal, not just dedup: a leaked closure would keep
            # this trainer reachable and fire on every future drain.
            self._remove_drain_subscription()
            self._clear_backfill_demand()

    def _fit(self) -> Result:
        name = self.run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        storage = self.run_config.storage_path or tmp_root("results")
        trial_dir = os.path.join(storage, name)
        os.makedirs(trial_dir, exist_ok=True)

        ckpt_cfg = self.run_config.checkpoint_config or CheckpointConfig()
        manager = CheckpointManager(
            os.path.join(trial_dir, "checkpoints"),
            num_to_keep=ckpt_cfg.num_to_keep,
            score_attribute=ckpt_cfg.checkpoint_score_attribute,
            score_order=ckpt_cfg.checkpoint_score_order,
        )
        fail_cfg = self.run_config.failure_config or FailureConfig()
        failures = 0
        restore = self.resume_from_checkpoint
        last_metrics: Dict[str, Any] = {}
        history: List[dict] = []
        error: Optional[BaseException] = None

        while True:
            try:
                world = self._resolve_world_size(settle=failures > 0)
            except TrainingFailedError as e:
                error = e
                break
            self.world_size = world
            # Per-incarnation step bookkeeping: session steps restart at 0
            # with each gang, so disk-vs-memory freshness is only compared
            # within one incarnation.
            self._last_disk_ckpt_step = 0
            self._ckpt_rounds = 0
            self._disk_every_k = max(1, ckpt_cfg.disk_ckpt_every_k)
            self._drop_pending_skipped()
            # Drop any notice consumed by (or aimed at) the PREVIOUS gang
            # before the new one forms; events landing from here on are
            # accepted conservatively (empty gang set = relevant).
            self._gang_nodes = set()
            self._consume_drain_notice()
            group = WorkerGroup(
                world,
                self.scaling_config.worker_resources(),
                trial_dir,
                self.scaling_config.placement_strategy,
                mesh_config=self.scaling_config.mesh,
                torch_distributed=(
                    self.scaling_config.wants_torch_distributed()),
                runtime_env=self.scaling_config.runtime_env,
                memory_ckpt_every_k=ckpt_cfg.memory_ckpt_every_k,
                use_gpu=self.scaling_config.use_gpu,
            )
            try:
                group.setup(
                    restore.path if restore else None,
                    None,
                    collective_group=f"train-{name}",
                )
                # Scope drain notices to this incarnation's hosts, then OR
                # in ground truth: a drain announced mid-setup (event
                # handled before this snapshot OR racing it) must still
                # trigger the grace-window save — never overwrite a
                # concurrently-set flag with a stale nodes() view.
                self._gang_nodes = set(group.gang_nodes)
                try:
                    if any(n.get("draining")
                           and n.get("node_id") in self._gang_nodes
                           for n in ray_tpu_torch.nodes()):
                        with _drain_flag_lock:
                            self._drain_requested = True
                except Exception:
                    pass
                group.start_training(self.train_loop, self.train_loop_config)
                # Downsized? keep the shortfall visible as autoscaler
                # demand so the next restart can grow back to num_workers.
                self._set_backfill_demand(world)
                last_metrics, history_part = self._drive(group, manager)
                history.extend(history_part)
                error = None
                break
            except (WorkerCrashedError, ActorDiedError,
                    ray_tpu_torch.exceptions.RayTpuError) as e:
                failures += 1
                history_part = getattr(e, "_history", [])
                history.extend(history_part)
                # Fast gang recovery: the held disk-skipped round (already
                # on the driver's disk) first, then any NEWER in-memory
                # replicas pulled off the surviving workers BEFORE the gang
                # is torn down — resume loses seconds, not a checkpoint
                # interval.  This runs even when the failure is terminal:
                # Result.checkpoint must be the freshest restorable state
                # (a round must never vanish from both tiers just because
                # the retry budget ran out).
                # Best-effort like the replication that fed them: a broken
                # recovery tier (ENOSPC during register, a corrupt blob)
                # must degrade to the older disk checkpoint, not escape the
                # except clause and turn a retryable failure terminal.
                try:
                    self._flush_pending_skipped(manager)
                except Exception:
                    logger.exception("persisting the held checkpoint failed")
                try:
                    self._restore_from_memory_snapshots(group, manager)
                except Exception:
                    logger.exception("in-memory checkpoint recovery failed")
                if fail_cfg.max_failures >= 0 and failures > fail_cfg.max_failures:
                    error = TrainingFailedError(
                        f"training failed after {failures} failure(s): {e}"
                    )
                    break
                restore = manager.latest() or self.resume_from_checkpoint
            finally:
                group.shutdown()

        return Result(
            metrics=last_metrics,
            checkpoint=manager.latest(),
            path=trial_dir,
            error=error,
            metrics_history=history,
        )

    # -------------------------------------------------------------- elastic

    def _clear_backfill_demand(self) -> None:
        pg, self._backfill_pg = self._backfill_pg, None
        if pg is not None:
            try:
                ray_tpu_torch.remove_placement_group(pg)
            except Exception:
                pass

    def _set_backfill_demand(self, world: int) -> None:
        """Downsized gang: park a placement group for the MISSING capacity
        (num_workers - world bundles).  Pending, it is exactly the demand
        signal the autoscaler keys on; once satisfied it holds the arrived
        capacity until the next restart claims it for the upsize."""
        self._clear_backfill_demand()
        shortfall = self.scaling_config.num_workers - world
        if self.scaling_config.min_workers is None or shortfall <= 0:
            return
        self._backfill_pg = _quiet_demand_pg(
            self.scaling_config.worker_resources(), shortfall
        )

    def _resolve_world_size(self, settle: bool = False) -> int:
        """Largest feasible world size right now.  Non-elastic configs
        (min_workers=None) always get num_workers.  Elastic configs size the
        gang to the schedulable capacity within [min_workers, num_workers]:
        a preempted-but-unreplaced node shrinks the gang instead of stalling
        the run; a later restart on a backfilled cluster grows it back."""
        sc = self.scaling_config
        if sc.min_workers is None:
            return sc.num_workers
        # The previous incarnation's backfill reservation (if satisfied)
        # holds capacity that belongs to THIS measurement: release first.
        self._clear_backfill_demand()
        if settle:
            # Give the control plane a beat to notice the dead/drained node
            # (and release the dead gang's reservations) so capacity isn't
            # computed against a stale view.
            time.sleep(1.0)
        res = sc.worker_resources()
        key = "GPU" if sc.use_gpu else "CPU"
        per = res.get(key) or 1.0
        floor = max(1, min(sc.min_workers, sc.num_workers))

        def feasible_now() -> int:
            # AVAILABLE capacity, not totals: co-tenant workloads (serve
            # replicas, other jobs) must not be double-counted into the
            # gang — an oversized gang would park unplaceable actors.
            # Whole worker slots PER NODE, not a cross-node sum: three
            # nodes with 1 free CPU each cannot host one 2-CPU worker,
            # and an unplaceable gang would hang setup forever.
            slots = 0
            try:
                for n in ray_tpu_torch.nodes():
                    if n.get("alive") and not n.get("draining"):
                        avail = (n.get("available") or {}).get(key, 0.0)
                        slots += int(avail // per)
            except Exception:
                pass
            return min(slots, sc.num_workers)

        deadline = time.monotonic() + sc.elastic_wait_s
        demand_pg = None

        def release_demand_pg():
            nonlocal demand_pg
            if demand_pg:
                try:
                    ray_tpu_torch.remove_placement_group(demand_pg)
                except Exception:
                    pass
            demand_pg = None

        try:
            while True:
                # A demand PG that got SATISFIED holds real reservations —
                # release it BEFORE measuring, or its own bundles would be
                # subtracted from availability and the gang would re-form
                # undersized on a fully backfilled cluster.
                if demand_pg and demand_pg.ready(timeout=0.05):
                    release_demand_pg()
                feasible = feasible_now()
                if feasible >= sc.num_workers:
                    return feasible
                if feasible >= floor:
                    # Mid-range reading: the dead gang's releases may still
                    # be landing — confirm with a second poll and take the
                    # larger view before committing to a downsize.  Release
                    # the demand PG first: if it got satisfied in the gap
                    # after the ready() check above, its reservation would
                    # depress both readings and lock in an undersized gang.
                    release_demand_pg()
                    time.sleep(0.5)
                    return max(feasible, feasible_now())
                if time.monotonic() >= deadline:
                    raise TrainingFailedError(
                        f"elastic restart: only {feasible} worker slot(s) "
                        f"of {key!r} capacity available after "
                        f"{sc.elastic_wait_s}s; min_workers={floor}"
                    )
                if demand_pg is None:
                    # Make the wait visible as scheduler demand: a pending
                    # placement group is what the autoscaler keys on —
                    # without it a cold cluster would never backfill for us.
                    demand_pg = _quiet_demand_pg(res, floor) or False
                time.sleep(0.5)
        finally:
            release_demand_pg()

    def _restore_from_memory_snapshots(self, group: WorkerGroup,
                                       manager: CheckpointManager) -> None:
        """Materialize the freshest complete in-memory checkpoint set (if it
        beats the last disk write this incarnation) into the manager, so the
        normal latest()-restore path picks it up."""
        try:
            got = group.collect_memory_snapshots()
        except Exception:
            return
        if not got:
            return
        step, blobs = got
        if step <= self._last_disk_ckpt_step:
            return  # disk already has this round (e.g. a drain save landed)
        from .checkpoint import unpack_directory

        rank_dirs: List[str] = []
        for rank, blob in sorted(blobs.items()):
            d = tempfile.mkdtemp(prefix=f"rt_mem_ckpt_r{rank}_")
            unpack_directory(blob, d)
            rank_dirs.append(d)
        merged = self._merge_checkpoints(rank_dirs)
        persisted = manager.register(
            Checkpoint(merged),
            {"step": step, "memory_checkpoint": True},
        )
        # Durable marker: lets operators (and tests) see that this restore
        # point came from the in-memory replicas, not a periodic disk save.
        try:
            persisted.update_metadata(
                {"memory_checkpoint": True, "session_step": step}
            )
        except Exception:
            pass
        shutil.rmtree(merged, ignore_errors=True)
        for d in rank_dirs:
            shutil.rmtree(d, ignore_errors=True)

    # ---------------------------------------------------------------- drive

    def _drive(self, group: WorkerGroup, manager: CheckpointManager):
        """Poll report rounds until every worker finishes
        (reference: backend_executor.get_next_results:578).  Any failure
        carries the rounds processed so far (``e._history``) so an elastic
        restart doesn't lose the pre-failure metrics history."""
        history: List[dict] = []
        try:
            return self._drive_inner(group, manager, history)
        except BaseException as e:  # noqa: BLE001 — annotated and re-raised
            if not getattr(e, "_history", None):
                e._history = history
            raise

    def _drive_inner(self, group: WorkerGroup, manager: CheckpointManager,
                     history: List[dict]):
        last_metrics: Dict[str, Any] = {}
        done = [False] * group.num_workers
        while not all(done):
            active = [r for r in range(group.num_workers) if not done[r]]
            results = group.poll_all(active)
            reports = []
            for r in results:
                if r is None:
                    raise TrainingFailedError("worker poll timed out")
                if r.get("done"):
                    done[r["rank"]] = True
                    if r.get("error"):
                        err = TrainingFailedError(
                            f"rank {r['rank']} failed:\n{r['error']}"
                        )
                        err._history = history
                        raise err
                else:
                    reports.append(r)
            if reports:
                rank0 = next((r for r in reports if r["rank"] == 0), reports[0])
                metrics = rank0["metrics"]
                ckpt_dirs = [r["checkpoint_dir"] for r in reports
                             if r.get("checkpoint_dir")]
                if ckpt_dirs:
                    self._ckpt_rounds += 1
                    # Disk cadence: persist every K-th checkpoint round;
                    # drain saves (announced preemption) always persist.
                    # A round may ONLY skip disk when every reporting rank
                    # confirmed an in-memory replica for it — a checkpoint
                    # must never vanish from both tiers (e.g. single-worker
                    # gangs or replication disabled/mis-cadenced).
                    drain_round = any(r.get("drain") for r in reports)
                    replicated = all(
                        r.get("memory_replicated")
                        for r in reports if r.get("checkpoint_dir")
                    )
                    merged = self._merge_checkpoints(ckpt_dirs)
                    if (drain_round or not replicated
                            or self._ckpt_rounds % self._disk_every_k == 0):
                        self._last_disk_ckpt_step = rank0.get("step", 0)
                        manager.register(Checkpoint(merged), metrics)
                        shutil.rmtree(merged, ignore_errors=True)
                        self._drop_pending_skipped()
                    else:
                        # Skipped round: hold the newest merged copy on the
                        # DRIVER's disk until a newer round persists — the
                        # run's final checkpoint must never exist only in
                        # replicas that die with the gang at shutdown.
                        self._drop_pending_skipped()
                        self._pending_skipped = (
                            rank0.get("step", 0), merged, metrics
                        )
                    for d in ckpt_dirs:
                        shutil.rmtree(d, ignore_errors=True)
                last_metrics = metrics
                history.append(metrics)
                if self._report_callback is not None:
                    self._report_callback(metrics)
                # Relay a pending preemption notice on THIS round's acks:
                # every rank sees should_checkpoint() at the same boundary.
                group.ack_all([r["rank"] for r in reports],
                              should_checkpoint=self._consume_drain_notice())
        # Clean finish: if the run's newest checkpoint round was a disk-
        # skipped one, its in-memory replicas are about to die with the
        # gang — persist the held driver-side copy now.
        self._flush_pending_skipped(manager)
        return last_metrics, history

    def _drop_pending_skipped(self) -> None:
        pending, self._pending_skipped = self._pending_skipped, None
        if pending is not None:
            shutil.rmtree(pending[1], ignore_errors=True)

    def _flush_pending_skipped(self, manager: CheckpointManager) -> None:
        """Persist the newest disk-skipped checkpoint round (if any) —
        called when its in-memory replicas are about to become unreachable
        (clean finish, or a failure before collection)."""
        pending, self._pending_skipped = self._pending_skipped, None
        if pending is None:
            return
        step, merged, metrics = pending
        if step > self._last_disk_ckpt_step:
            self._last_disk_ckpt_step = step
            persisted = manager.register(Checkpoint(merged), metrics)
            try:
                persisted.update_metadata(
                    {"held_checkpoint": True, "session_step": step}
                )
            except Exception:
                pass
        shutil.rmtree(merged, ignore_errors=True)

    @staticmethod
    def _merge_checkpoints(dirs: List[str]) -> str:
        """Merge per-rank checkpoint dirs (rank files must be distinct or
        identical; rank 0 wins collisions by being copied last)."""
        merged = tempfile.mkdtemp(prefix="rt_merged_ckpt_")
        for d in sorted(dirs, reverse=True):
            shutil.copytree(d, merged, dirs_exist_ok=True)
        return merged


class TorchTrainer(DataParallelTrainer):
    """The reference's TorchTrainer (train/torch/torch_trainer.py:11): the
    JAX package's ``JaxTrainer``, which stands for it there."""
