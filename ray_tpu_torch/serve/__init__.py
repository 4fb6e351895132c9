"""ray_tpu_torch.serve: model serving on the port's actor runtime (port of
``ray_tpu/serve``, the same public names).

Role-equivalent to Ray Serve (reference: python/ray/serve — controller
reconcile loop, replica actors, power-of-two routing, batching, HTTP and
gRPC ingress, request-based autoscaling), beside the continuous-batching
inference engine and its multi-tenant plane (radix prefix cache, LoRA
adapter pool).  Replicas reserve cards through
``ray_actor_options={"num_gpus": n}`` and run the engine's paged programs
on them.
"""

from .adapter_pool import AdapterNotFoundError, AdapterPool
from .api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_deployment_handle,
    run,
    shutdown,
    start_http,
    status,
    stop_http,
)
from .batching import batch
from .config import deploy as deploy_config
from .engine import (
    EngineConfig,
    EngineOverloadedError,
    InferenceEngine,
    LLMServer,
    TokenStream,
    llm_app,
    random_lora,
)
from .grpc_ingress import start_grpc, stop_grpc
from .handle import DeploymentHandle, DeploymentResponse
from .multiplex import (
    get_multiplexed_model_id,
    multiplexed,
    pick_replica_for_model,
)
from .prefix_cache import PrefixMatch, RadixPrefixCache

__all__ = [
    "deployment", "Deployment", "Application", "run", "delete", "status",
    "shutdown", "get_deployment_handle", "DeploymentHandle",
    "DeploymentResponse", "batch", "start_http", "stop_http",
    "multiplexed", "get_multiplexed_model_id", "pick_replica_for_model",
    "deploy_config", "start_grpc", "stop_grpc",
    "EngineConfig", "EngineOverloadedError", "InferenceEngine",
    "LLMServer", "llm_app", "random_lora",
    "AdapterPool", "AdapterNotFoundError", "RadixPrefixCache",
    "PrefixMatch", "TokenStream",
]
