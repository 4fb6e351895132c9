"""Models of the port: the Llama forward pass, KV-cache decoding and the
paged programs of the serve engine."""

from .llama import LlamaConfig, Llama, llama_apply, llama_hidden, llama_init, \
    params_from_jax

__all__ = ["LlamaConfig", "Llama", "llama_apply", "llama_hidden",
           "llama_init", "params_from_jax"]
