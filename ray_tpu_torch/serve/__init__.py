"""Serving layer of the port: the continuous-batching inference engine."""

from .engine import (EngineConfig, EngineOverloadedError, InferenceEngine,
                     TokenStream)

__all__ = ["EngineConfig", "EngineOverloadedError", "InferenceEngine",
           "TokenStream"]
