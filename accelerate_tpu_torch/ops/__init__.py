from .flash_attention import (
    attention_stats,
    auto_flash_attention,
    blockwise_attention,
    flash_attention,
)
from .hopper_flash import flash_attention_with_lse, merge_flash_chunks

__all__ = [
    "attention_stats",
    "auto_flash_attention",
    "blockwise_attention",
    "flash_attention",
    "flash_attention_with_lse",
    "merge_flash_chunks",
]
