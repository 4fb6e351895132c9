"""Models of the port: the Llama forward pass, loss and LoRA, the
Mixtral-family MoE decoder, the MNIST MLP, the train step (sharded over a
mesh too) and the sharding rules, KV-cache decoding and the paged programs
of the serve engine."""

from .generate import (generate, init_kv_cache, llama_decode_step,
                       llama_prefill)
from .llama import (Llama, LlamaConfig, Lora, llama_apply, llama_hidden,
                    llama_init, llama_loss, llama_sharding_rules,
                    lora_from_jax, lora_init, lora_merge,
                    lora_sharding_rules, params_from_jax)
from .mlp import (MLPConfig, mlp_apply, mlp_init, mlp_loss,
                  mlp_params_from_jax)
from .moe import (MoE, MoEConfig, moe_apply, moe_init, moe_loss,
                  moe_params_from_jax, moe_sharding_rules)
from .paged import (PageAllocator, adapter_load, copy_page,
                    init_adapter_pool, init_paged_pools, pack_lora,
                    paged_decode_step, paged_prefill, paged_prefill_prefix)
from .train_state import (TrainState, default_optimizer, make_train_step,
                          shard_train_state)

__all__ = ["generate", "init_kv_cache", "llama_decode_step",
           "llama_prefill",
           "Llama", "LlamaConfig", "Lora", "llama_apply", "llama_hidden",
           "llama_init", "llama_loss", "llama_sharding_rules",
           "lora_from_jax", "lora_init", "lora_merge", "lora_sharding_rules",
           "params_from_jax", "MLPConfig", "mlp_apply",
           "mlp_init", "mlp_loss", "mlp_params_from_jax", "MoE",
           "MoEConfig", "moe_apply", "moe_init", "moe_loss",
           "moe_params_from_jax", "moe_sharding_rules", "PageAllocator",
           "adapter_load", "copy_page", "init_adapter_pool",
           "init_paged_pools", "pack_lora",
           "paged_decode_step", "paged_prefill", "paged_prefill_prefix",
           "TrainState", "default_optimizer", "make_train_step",
           "shard_train_state"]
