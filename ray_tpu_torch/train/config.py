"""Train configuration dataclasses (port of ``ray_tpu/train/config.py``).

Role-equivalent to the reference's air/config.py (RunConfig, ScalingConfig,
FailureConfig, CheckpointConfig) and air/result.py (Result).  A worker that
asks for a card says ``use_gpu`` (Ray's own name: ``{"GPU": 1}`` a worker)
where the JAX package says ``use_tpu``, and holds one card, as in Ray's
TorchTrainer.  Like the port's other entry points, a gang runs on the card
unless the caller asks for the CPU (``use_gpu=False``); so ScalingConfig's mesh spans the gang (its axis sizes
multiply to ``num_workers``), where a JAX worker's mesh spans that
worker's own local devices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..parallel.mesh import MeshConfig


@dataclasses.dataclass
class ScalingConfig:
    """How many framework workers, with what resources, and how the gang's
    ranks form a mesh (reference: air/config.py ScalingConfig)."""

    num_workers: int = 1
    # Elastic floor: after a failure that shrank the cluster (e.g. a
    # preempted node not yet replaced), the trainer re-forms the gang at the
    # largest feasible world size within [min_workers, num_workers] instead
    # of waiting for full capacity, and grows back toward num_workers on a
    # later restart once the autoscaler backfills.  None = not elastic
    # (always num_workers — the reference's fixed-size semantics).
    min_workers: Optional[int] = None
    # How long a restart may wait for at least min_workers' worth of
    # capacity to appear before giving up (elastic gangs only).
    elastic_wait_s: float = 30.0
    # One card a worker ({"GPU": 1}); a cluster without a card refuses the
    # gang rather than train it on the CPU.  False: CPU workers.
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None
    # Mesh built in every worker at setup (exposed via
    # ray_tpu_torch.train.get_mesh()): over the gang's ranks, one position
    # a worker, on each worker's card (its CPU without use_gpu).
    mesh: Optional[MeshConfig] = None
    # Join the gang in torch.distributed's default group before building
    # the mesh (_setup_torch_process_group, reference:
    # train/torch/config.py:66): NCCL where a rank holds a card, gloo on
    # the CPU.  None = auto: multi-worker GPU gangs, and any multi-worker
    # gang given a mesh (a mesh over the gang needs the group).
    torch_distributed: Optional[bool] = None
    # Per-worker runtime env (e.g. env_vars setting XLA flags).
    runtime_env: Optional[dict] = None
    placement_strategy: str = "PACK"

    def wants_torch_distributed(self) -> bool:
        if self.torch_distributed is not None:
            return self.torch_distributed
        return self.num_workers > 1 and (self.use_gpu
                                         or self.mesh is not None)

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res.setdefault("GPU", 1.0)
        return res


@dataclasses.dataclass
class FailureConfig:
    """(reference: air/config.py FailureConfig) — max_failures < 0 means
    unlimited restarts."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """(reference: air/config.py CheckpointConfig)"""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # "max" | "min"
    # Peer-replicated in-memory checkpoints: every K-th reported checkpoint,
    # each rank also pushes its host snapshot into a surviving peer's object
    # store (ring-neighbor, different-node preferred).  After a failure the
    # new gang restores from the freshest in-memory copy when it is newer
    # than the last disk write — recovery costs seconds, not a checkpoint
    # interval (TorchTitan-style replicated in-memory checkpoints).
    # OPT-IN (None disables): replication packs the whole checkpoint into
    # host memory and does a confirmed cross-node push inside the report
    # path — a price multi-GB checkpoints must choose, not inherit.
    memory_ckpt_every_k: Optional[int] = None
    # Disk-persistence cadence among reported checkpoints: the trainer
    # registers every K-th reported checkpoint into durable storage (drain
    # saves always persist).  With frequent cheap host snapshots + sparse
    # disk writes, an un-announced failure recovers from the in-memory
    # replicas at a step strictly later than the last disk checkpoint.
    disk_ckpt_every_k: int = 1


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None


@dataclasses.dataclass
class Result:
    """(reference: air/result.py Result)"""

    metrics: Dict[str, Any]
    checkpoint: Optional["Checkpoint"]  # noqa: F821
    path: str
    error: Optional[BaseException] = None
    metrics_history: Optional[list] = None

    @property
    def best_checkpoints(self):
        return self._best_checkpoints

    _best_checkpoints: list = dataclasses.field(default_factory=list)
