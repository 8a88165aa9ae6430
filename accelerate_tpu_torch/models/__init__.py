from .convert import llama_params_from_flax, llama_params_to_flax
from .hub import llama_params_from_hf, llama_params_to_hf, load_pretrained, model_from_pretrained
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
    fused_cross_entropy_loss,
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
    "fused_cross_entropy_loss",
    "llama_params_from_flax",
    "llama_params_from_hf",
    "llama_params_to_flax",
    "llama_params_to_hf",
    "load_pretrained",
    "model_from_pretrained",
    "naive_attention",
    "rms_norm",
    "rotary_embedding",
]
