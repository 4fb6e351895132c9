"""WorkerGroup: a gang of train-worker actors (port of
``ray_tpu/train/worker_group.py``).

Role-equivalent to the reference's WorkerGroup + BackendExecutor
(reference: train/_internal/worker_group.py:102, backend_executor.py:68):
spawns N actors into a placement group, each granted one card when the gang
asks for GPUs, initializes the process group (_setup_torch_process_group:
NCCL where a rank holds a card, gloo on the CPU), builds the mesh over the
gang, runs the user train loop, and relays session reports.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from . import session as session_mod
from .checkpoint import Checkpoint


def _dumps_by_value(fn) -> bytes:
    """Serialize a user train loop so workers never need to import its
    defining module: driver scripts and test files are typically not
    importable from worker processes (pytest imports test files as top-level
    modules; ad-hoc scripts are __main__).  Modules inside installed
    packages keep by-reference semantics."""
    import sys

    mod = sys.modules.get(getattr(fn, "__module__", None))
    by_value = False
    if mod is not None and mod.__name__ not in ("__main__",):
        mod_file = getattr(mod, "__file__", "") or ""
        pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        in_site = "site-packages" in mod_file or "dist-packages" in mod_file
        in_framework = mod_file.startswith(os.path.join(pkg_dir, ""))
        if mod_file and not in_site and not in_framework:
            try:
                cloudpickle.register_pickle_by_value(mod)
                by_value = True
            except Exception:
                by_value = False
    try:
        return cloudpickle.dumps(fn)
    finally:
        if by_value:
            try:
                cloudpickle.unregister_pickle_by_value(mod)
            except Exception:
                pass


@ray_tpu_torch.remote(max_concurrency=8)
class TrainWorker:
    """One rank of the gang.  max_concurrency lets poll()/ack() — and peer
    snapshot pushes / failure-time snapshot collection — run while the train
    loop blocks inside run()."""

    def __init__(self, rank: int, world_size: int, trial_dir: str):
        self.rank = rank
        self.world_size = world_size
        self.trial_dir = trial_dir
        self.session = None

    def setup(
        self,
        restored_ckpt_path: Optional[str],
        dataset_shards: Optional[Dict[str, Any]],
        collective_group: Optional[str],
        mesh_config=None,
        torch_distributed: bool = False,
        gang_id: str = "",
        use_gpu: bool = False,
    ):
        from . import session as smod

        if use_gpu:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"train worker {self.rank} was granted a card but sees "
                    "none (CUDA_VISIBLE_DEVICES="
                    f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        self.session = smod.init_session(
            world_rank=self.rank,
            world_size=self.world_size,
            trial_dir=self.trial_dir,
            restored_checkpoint=(
                Checkpoint(restored_ckpt_path) if restored_ckpt_path else None
            ),
            dataset_shards=dataset_shards,
        )
        self.session.collective_group = collective_group
        # One gang id per WorkerGroup incarnation: the round flight
        # recorder keys its records on it, so a restarted gang's rounds
        # never join against the dead attempt's.
        self.session.gang_id = gang_id or None
        if collective_group is not None:
            from ..collective import init_collective_group

            init_collective_group(
                self.world_size, self.rank, group_name=collective_group
            )
        if torch_distributed and self.world_size > 1:
            # Gang SPMD bootstrap: after this, the default process group
            # spans the gang and the mesh below is global (reference:
            # _setup_torch_process_group runs on every worker in on_start,
            # train/torch/config.py:66-153).  The gang id makes the KV
            # coordinator key unique per WorkerGroup incarnation — a
            # restarted gang must not read the dead attempt's address.
            from ..parallel.distributed import initialize_process_group

            initialize_process_group(
                self.world_size, self.rank,
                group_name=f"{collective_group or 'train'}-{gang_id}",
            )
        if mesh_config is not None:
            # One card (or CPU) a worker: the mesh spans the gang's ranks,
            # where a JAX worker's spans its own local devices.
            import torch.distributed as dist

            from ..parallel.mesh import make_mesh

            mesh_config.resolve(self.world_size)  # ValueError: not covered
            if self.world_size > 1 and not dist.is_initialized():
                raise ValueError(
                    f"a mesh over a gang of {self.world_size} workers needs "
                    "the gang's process group (ScalingConfig."
                    "torch_distributed)")
            self.session.mesh = make_mesh(
                mesh_config, device=None if use_gpu else "cpu")
        # Rank + host identity: the driver uses node ids to pick each rank's
        # replication peer on a DIFFERENT node where possible.
        return {"rank": self.rank, "node_id": os.environ.get("RT_NODE_ID", "")}

    def configure_memory_checkpoints(self, peer_handle, every_k):
        """Wire this rank's in-memory checkpoint replication: snapshots go
        to the local object store and to ``peer_handle``'s store every K-th
        reported checkpoint (and always on a drain save)."""
        self.session.configure_memory_checkpoints(peer_handle, every_k)
        return True

    def store_peer_snapshot(self, rank: int, step: int, blob: bytes):
        """Receive a peer rank's packed checkpoint: pin it in THIS node's
        object store and remember the handle (last two generations; dropped
        refs free the older replicas)."""
        import ray_tpu_torch

        self.session.remember_snapshot(rank, step, ray_tpu_torch.put(blob))
        return True

    def memory_snapshots(self):
        """{rank: [(step, ObjectRef), ...]} of every in-memory snapshot this
        rank holds (its own + replicas pushed by peers).  Serializing the
        refs to the driver increfs them, so the blobs outlive this worker."""
        return self.session.snapshot_view()

    def run(self, fn_blob: bytes, config: Optional[dict]):
        """Execute the user train loop; always ends with a 'done' sentinel —
        including when the loop fails to even deserialize (the driver polls
        the session queue, so a raised-instead-of-queued error would hang it)."""
        sentinel = {"done": True, "rank": self.rank}
        try:
            fn = cloudpickle.loads(fn_blob)
            if config is not None:
                fn(config)
            else:
                fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the driver
            import traceback

            sentinel["error"] = f"{e}\n{traceback.format_exc()}"
        self.session.finished = True
        # Ship the tail of the round flight recorder BEFORE the done
        # sentinel, synchronously: the driver tears the gang down the
        # moment every loop reports done — faster than the client's 0.5s
        # flush cadence AND faster than a fire-and-forget batch drains —
        # so the last rounds of every run would otherwise only survive
        # in the black box.
        try:
            from ..util import gangrec

            gangrec.flush_rounds(sync=True)
        except Exception:
            pass
        # Same race for the final metrics window: collective-op timings
        # and recorder counters incremented during the last rounds must
        # not die with the actor (bounded: drain_bg times out at 2s).
        try:
            from ..util.metrics import _final_flush

            _final_flush()
        except Exception:
            pass
        self.session.result_queue.put(sentinel)

    def poll(self, timeout: float = 600.0):
        return self.session.next_result(timeout=timeout)

    def ack(self, should_checkpoint: bool = False):
        self.session.ack(should_checkpoint)
        return True

    def _init_collective(self, world_size, rank, group_name):
        from ..collective import init_collective_group

        init_collective_group(world_size, rank, group_name=group_name)


class WorkerGroup:
    def __init__(self, num_workers: int, resources_per_worker: Dict[str, float],
                 trial_dir: str, placement_strategy: str = "PACK",
                 mesh_config=None, torch_distributed: bool = False,
                 runtime_env: Optional[dict] = None,
                 memory_ckpt_every_k: Optional[int] = None,
                 use_gpu: bool = False):
        self.num_workers = num_workers
        self.trial_dir = trial_dir
        self.mesh_config = mesh_config
        self.torch_distributed = torch_distributed
        self.use_gpu = use_gpu
        self.runtime_env = runtime_env
        # <=0 means disabled, same as None (0 would ZeroDivision in the
        # session's cadence check; negative cadences are meaningless).
        self.memory_ckpt_every_k = (
            memory_ckpt_every_k
            if memory_ckpt_every_k and memory_ckpt_every_k > 0 else None
        )
        self.gang_nodes: set = set()  # filled by setup()
        self.gang_id = os.urandom(4).hex()
        self.pg = None
        if num_workers > 1:
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pg = ray_tpu_torch.placement_group(
                    [dict(resources_per_worker) for _ in range(num_workers)],
                    strategy=placement_strategy,
                )
            if pg.infeasible_now:
                # Bundles don't fit this cluster: a pending PG would park the
                # whole gang forever — drop it and schedule best-effort.
                ray_tpu_torch.remove_placement_group(pg)
            else:
                self.pg = pg
        opts: Dict[str, Any] = {"num_cpus": resources_per_worker.get("CPU", 1)}
        if resources_per_worker.get("GPU"):
            opts["num_gpus"] = resources_per_worker["GPU"]
        if runtime_env:
            opts["runtime_env"] = runtime_env
        self.workers: List[Any] = []
        for rank in range(num_workers):
            cls = TrainWorker
            if self.pg is not None:
                cls = TrainWorker.options(
                    scheduling_strategy=(
                        ray_tpu_torch.PlacementGroupSchedulingStrategy(
                            self.pg, rank)),
                    **opts,
                )
            else:
                cls = TrainWorker.options(**opts)
            self.workers.append(
                cls.remote(rank, num_workers,
                           os.path.join(trial_dir, f"rank_{rank}"))
            )

    def setup(self, restored_ckpt: Optional[str],
              dataset_shards: Optional[List[Dict[str, Any]]],
              collective_group: Optional[str]):
        refs = [
            w.setup.remote(
                restored_ckpt,
                dataset_shards[i] if dataset_shards else None,
                collective_group,
                self.mesh_config,
                self.torch_distributed,
                self.gang_id,
                self.use_gpu,
            )
            for i, w in enumerate(self.workers)
        ]
        infos = ray_tpu_torch.get(refs)
        # Which cluster nodes host this gang (hex ids) — the trainer
        # filters drain notices against this set.
        self.gang_nodes = {i.get("node_id", "") for i in infos} - {""}
        if self.memory_ckpt_every_k is not None and self.num_workers > 1:
            self._wire_replication_peers(infos)
        return infos

    def _wire_replication_peers(self, infos: List[dict]):
        """Give each rank a replication peer: the nearest ring successor on
        a DIFFERENT node when one exists (with PACK placement, consecutive
        ranks co-locate — a same-node ring neighbor would die with the rank
        it is supposed to back up), else the plain ring successor."""
        nodes = {i["rank"]: i.get("node_id", "") for i in infos}
        n = self.num_workers
        refs = []
        for r in range(n):
            peer = (r + 1) % n
            for off in range(1, n):
                cand = (r + off) % n
                if nodes.get(cand) and nodes.get(cand) != nodes.get(r):
                    peer = cand
                    break
            refs.append(self.workers[r].configure_memory_checkpoints.remote(
                self.workers[peer], self.memory_ckpt_every_k
            ))
        ray_tpu_torch.get(refs)

    def start_training(self, fn: Callable, config: Optional[dict]):
        blob = _dumps_by_value(fn)
        self.run_refs = [w.run.remote(blob, config) for w in self.workers]

    def poll_all(self, ranks: Optional[List[int]] = None,
                 timeout: float = 600.0) -> List[dict]:
        targets = (
            self.workers if ranks is None else [self.workers[r] for r in ranks]
        )
        return ray_tpu_torch.get(
            [w.poll.remote(timeout) for w in targets],
            timeout=timeout + 60,
        )

    def ack_all(self, ranks: Optional[List[int]] = None,
                should_checkpoint: bool = False):
        """Release the round's lockstep.  ``should_checkpoint=True`` relays
        a drain notice to every acked rank at the same round boundary."""
        targets = (
            self.workers if ranks is None else [self.workers[r] for r in ranks]
        )
        ray_tpu_torch.get([w.ack.remote(should_checkpoint) for w in targets])

    def collect_memory_snapshots(self, timeout: float = 5.0):
        """Gather in-memory checkpoint replicas from the surviving workers
        after a gang failure (call BEFORE shutdown()).  Returns
        ``(step, {rank: packed_dir_blob})`` for the newest step with full
        rank coverage, or None when no complete in-memory set survived
        (e.g. consecutive co-located ranks died with their replicas)."""
        import time as _time

        avail: Dict[int, Dict[int, Any]] = {}  # rank -> {step: ref}
        # Fan out first, then collect against ONE shared deadline: dead
        # ranks burn the timeout concurrently instead of serially stalling
        # the recovery path (each get charges only the time remaining).
        calls = [w.memory_snapshots.remote() for w in self.workers]
        deadline = _time.monotonic() + timeout
        for ref in calls:
            try:
                snaps = ray_tpu_torch.get(
                    ref, timeout=max(0.2, deadline - _time.monotonic())
                )
            except Exception:
                continue  # dead or unreachable rank: its peers cover it
            for rank, entries in snaps.items():
                for step, ref in entries:
                    avail.setdefault(rank, {})[step] = ref
        if len(avail) < self.num_workers:
            return None  # some rank left no surviving replica at all
        # Newest step EVERY rank has a snapshot for (ranks may be one round
        # apart when a node dies mid-round; two kept generations guarantee
        # an intersection when replication ran on consecutive rounds).
        common = set.intersection(
            *(set(steps) for steps in avail.values())
        )
        if not common:
            return None
        best = max(common)
        blobs: Dict[int, bytes] = {}
        deadline = _time.monotonic() + timeout
        for rank in range(self.num_workers):
            try:
                blobs[rank] = ray_tpu_torch.get(
                    avail[rank][best],
                    timeout=max(0.2, deadline - _time.monotonic()),
                )
            except Exception:
                return None  # replica's store node died too
        return best, blobs

    def shutdown(self):
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self.pg is not None:
            try:
                ray_tpu_torch.remove_placement_group(self.pg)
            except Exception:
                pass
