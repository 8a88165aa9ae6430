from .flash_attention import (
    attention_stats,
    auto_flash_attention,
    blockwise_attention,
    flash_attention,
)
from .fp8 import (
    backend_to_native,
    dequantize_params_fp8,
    eval_mode,
    fp8_dot_general,
    fp8_einsum,
    qdq_e4m3,
    qdq_e5m2,
    qdq_hybrid,
    quantize_params_fp8,
)
from .hopper_flash import flash_attention_with_lse, merge_flash_chunks

__all__ = [
    "attention_stats",
    "auto_flash_attention",
    "backend_to_native",
    "blockwise_attention",
    "dequantize_params_fp8",
    "eval_mode",
    "flash_attention",
    "flash_attention_with_lse",
    "fp8_dot_general",
    "fp8_einsum",
    "merge_flash_chunks",
    "qdq_e4m3",
    "qdq_e5m2",
    "qdq_hybrid",
    "quantize_params_fp8",
]
