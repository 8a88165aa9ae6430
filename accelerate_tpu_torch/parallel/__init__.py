from .fsdp import apply_data_parallel, decoder_blocks

__all__ = ["apply_data_parallel", "decoder_blocks"]
