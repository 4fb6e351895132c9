"""Models of the port: the Llama forward pass, loss and LoRA, the train
step, KV-cache decoding and the paged programs of the serve engine."""

from .llama import (Llama, LlamaConfig, Lora, llama_apply, llama_hidden,
                    llama_init, llama_loss, lora_from_jax, lora_init,
                    lora_merge, params_from_jax)
from .train_state import TrainState, default_optimizer, make_train_step

__all__ = ["Llama", "LlamaConfig", "Lora", "llama_apply", "llama_hidden",
           "llama_init", "llama_loss", "lora_from_jax", "lora_init",
           "lora_merge", "params_from_jax", "TrainState",
           "default_optimizer", "make_train_step"]
