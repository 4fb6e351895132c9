"""Distributed training orchestration (port of ``ray_tpu/train/``;
reference: ray.train).

The worker gang is actor-based like the reference: each worker holds one
card (the default; ``ScalingConfig(use_gpu=False)`` runs it on the CPU)
and the gang joins one ``torch.distributed`` group.  Instead of wrapping models in DDP/FSDP, a
ScalingConfig carries a MeshConfig over the gang and models shard via
ShardingRules (``models.make_train_step(mesh=, rules=)``).
``TorchTrainer`` is the JAX package's ``JaxTrainer``.
"""

from .checkpoint import (
    AsyncCheckpointWriter,
    Checkpoint,
    CheckpointManager,
    load_pytree,
    save_pytree,
)
from .config import (
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from . import telemetry
from .session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    get_mesh,
    report,
    should_checkpoint,
)
from .telemetry import TrainTelemetry
from .trainer import DataParallelTrainer, TorchTrainer, TrainingFailedError

__all__ = [
    "Checkpoint", "CheckpointManager", "save_pytree", "load_pytree",
    "AsyncCheckpointWriter",
    "RunConfig", "ScalingConfig", "FailureConfig", "CheckpointConfig",
    "Result", "report", "get_checkpoint", "get_context", "get_dataset_shard",
    "get_mesh", "should_checkpoint",
    "DataParallelTrainer", "TorchTrainer", "TrainingFailedError",
    "telemetry", "TrainTelemetry",
]
