"""Model multiplexing: many models share one replica pool (port of
``ray_tpu/serve/multiplex.py``, unchanged).

Role-equivalent to the reference's serve.multiplexed / get_multiplexed_model_id
(reference: serve/multiplex.py _ModelMultiplexWrapper — per-replica LRU of
loaded models, model-id-aware routing in the replica scheduler) — re-designed
for this framework: the loader decorator keeps an LRU on the replica, the
request's model id travels in request metadata and is exposed through a
contextvar, and the handle routes a given model id to a stable replica
(hash affinity) so repeated requests hit a warm cache.
"""

from __future__ import annotations

import contextvars
import functools
import inspect
from collections import OrderedDict
from typing import Callable, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rt_serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """The model id of the request being handled (reference:
    serve/api.py get_multiplexed_model_id)."""
    return _current_model_id.get()


def pick_replica_for_model(model_id: str, replica_ids) -> int:
    """Rendezvous (highest-random-weight) hashing: return the INDEX into
    ``replica_ids`` of the replica that owns ``model_id``.

    Unlike ``hash(model_id) % n``, scaling from n to n+1 replicas only
    remaps ~1/(n+1) of the model ids — every other model keeps its warm
    replica-side LRU (reference: the replica scheduler's model-id
    affinity survives replica-set churn).  ``replica_ids`` must be the
    controller-issued STABLE ids, not list positions: positions shift on
    any membership change, stable ids only vanish with their replica."""
    import hashlib

    best, best_w = 0, b""
    for i, rid in enumerate(replica_ids):
        w = hashlib.md5(f"{model_id}:{rid}".encode()).digest()
        if w > best_w:
            best_w, best = w, i
    return best


def _set_model_id(model_id: str):
    return _current_model_id.set(model_id)


def _reset_model_id(token) -> None:
    _current_model_id.reset(token)


def multiplexed(func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorator for a model-loader method: results are cached per replica
    in an LRU of ``max_num_models_per_replica`` entries (reference:
    serve/multiplex.py _ModelMultiplexWrapper.load_model).

    Usage::

        @serve.deployment
        class ModelHost:
            @serve.multiplexed(max_num_models_per_replica=2)
            async def get_model(self, model_id: str):
                return load_model_weights(model_id)

            async def __call__(self, x):
                model = await self.get_model(serve.get_multiplexed_model_id())
                return model(x)

    Evicted models are dropped from the cache; if the model object has a
    ``__del__`` it runs then (matching the reference's unload semantics).
    """

    def deco(fn: Callable):
        cache_attr = f"__mux_cache_{fn.__name__}"

        if inspect.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def wrapper(self, model_id: str):
                cache: OrderedDict = getattr(self, cache_attr, None)
                if cache is None:
                    cache = OrderedDict()
                    setattr(self, cache_attr, cache)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                model = await fn(self, model_id)
                cache[model_id] = model
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
                return model
        else:
            @functools.wraps(fn)
            def wrapper(self, model_id: str):
                cache: OrderedDict = getattr(self, cache_attr, None)
                if cache is None:
                    cache = OrderedDict()
                    setattr(self, cache_attr, cache)
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                model = fn(self, model_id)
                cache[model_id] = model
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
                return model

        return wrapper

    if func is not None:
        return deco(func)
    return deco
