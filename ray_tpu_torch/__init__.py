"""PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper (H100).

A second package beside the JAX ``ray_tpu``, which stays the reference it
is held against.  It follows ``ray_tpu``'s layout and names (``core``,
``ops``, ``models``, ``serve``, ``train``, ``parallel``, ``collective``,
``rllib``, ``util``, ``data``, ``tune``, ``dag``, ``workflow``) so
each module's counterpart is easy to find, and imports only torch, numpy,
cloudpickle, msgpack and the standard library: nothing of JAX and nothing of
``ray_tpu``.  The Pallas TPU kernels on its path are kernels written by hand
in CUDA C++ under ``csrc/``, built with nvcc at first use (``_build.py``).
Entry points run on the card unless the caller passes ``device="cpu"``.

The runtime core is the JAX package's, with GPU grants in place of TPU chip
grants: ``init``, ``@remote`` tasks and actors (``num_gpus=n``), ``put``,
``get``, ``wait``, ``kill``, ``cancel`` and placement groups.  Importing the
package loads neither torch nor CUDA (the worker zygote imports it before
it forks); ``resolve_device`` and the subpackages reached as attributes
(``rt.serve``, ``rt.train``, ``rt.rllib``, ...) load on first use.
"""

from .core.api import (
    ActorClass,
    ActorHandle,
    NodeAffinitySchedulingStrategy,
    PlacementGroup,
    PlacementGroupSchedulingStrategy,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    get_log,
    init,
    is_initialized,
    kill,
    list_named_actors,
    method,
    nodes,
    placement_group,
    put,
    remote,
    remove_placement_group,
    shutdown,
    stack_dump,
    task_events,
    timeline,
    wait,
)
from .core.context import get_runtime_context
from .core.object_ref import ObjectRef, ObjectRefGenerator
from . import exceptions

__version__ = "0.1.0"


#: Subpackages reached as attributes (``ray_tpu_torch.train``), imported on
#: first touch as the JAX package's are: most of them load torch.
_SUBPACKAGES = ("serve", "train", "rllib", "collective", "util",
                "cluster_utils", "data", "tune", "workflow", "dag",
                "job_submission")


def __getattr__(name):
    """``resolve_device`` and the subpackages import torch, so they load on
    first touch."""
    if name == "resolve_device":
        from .device import resolve_device

        globals()[name] = resolve_device
        return resolve_device
    if name in _SUBPACKAGES:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "method", "get", "put",
    "wait",
    "cancel", "kill", "get_actor", "list_named_actors", "placement_group",
    "remove_placement_group", "PlacementGroup",
    "PlacementGroupSchedulingStrategy", "NodeAffinitySchedulingStrategy",
    "cluster_resources", "available_resources", "nodes", "timeline",
    "task_events", "get_log", "stack_dump",
    "ObjectRef", "ObjectRefGenerator", "ActorClass", "ActorHandle",
    "exceptions", "get_runtime_context", "resolve_device", "__version__",
]
