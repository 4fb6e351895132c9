"""ray_tpu_torch.dag: compiled static actor pipelines (reference: ray.dag)."""

from .channel import ShmChannel
from .compiled import (
    CompiledDAG,
    DagFuture,
    DagNode,
    InputNode,
    MultiOutputNode,
    bind,
    enable_compiled_dags,
)

__all__ = [
    "InputNode", "DagNode", "MultiOutputNode", "CompiledDAG", "DagFuture",
    "bind", "enable_compiled_dags", "ShmChannel",
]
