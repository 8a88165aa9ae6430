from .convert import llama_params_from_flax, llama_params_to_flax
from .llama import (
    LlamaAttention,
    LlamaBlock,
    LlamaConfig,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    apply_partial_rope,
    apply_rope,
    cross_entropy_loss,
    naive_attention,
    rms_norm,
    rotary_embedding,
)

__all__ = [
    "LlamaAttention",
    "LlamaBlock",
    "LlamaConfig",
    "LlamaForCausalLM",
    "LlamaMLP",
    "LlamaModel",
    "apply_partial_rope",
    "apply_rope",
    "cross_entropy_loss",
    "llama_params_from_flax",
    "llama_params_to_flax",
    "naive_attention",
    "rms_norm",
    "rotary_embedding",
]
