"""Serving layer of the port: the continuous-batching inference engine
with its multi-tenant plane (radix prefix cache, LoRA adapter pool)."""

from .adapter_pool import AdapterNotFoundError, AdapterPool
from .engine import (EngineConfig, EngineOverloadedError, InferenceEngine,
                     TokenStream, random_lora)
from .prefix_cache import PrefixMatch, RadixPrefixCache

__all__ = ["AdapterNotFoundError", "AdapterPool", "EngineConfig",
           "EngineOverloadedError", "InferenceEngine", "PrefixMatch",
           "RadixPrefixCache", "TokenStream", "random_lora"]
