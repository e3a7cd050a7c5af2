"""Hand-written Hopper kernels for the port's hot ops, each beside its plain
PyTorch version (used for CPU tensors), the dense attention oracle, and the
paged KV cache's gather and int8 codec (torch ops; no kernel is owed)."""

from .flash_attention import (  # noqa: F401
    LAUNCHES,
    flash_attention,
    flash_with_lse,
    gather_paged_kv,
    reset_launch_counts,
    resolved_block_sizes,
)
from . import quant  # noqa: F401
from .quant import (  # noqa: F401
    dequantize_blockwise,
    dequantize_kv,
    quantize_blockwise,
    quantize_kv,
    quantized_all_reduce,
)
from .reference import dense_attention  # noqa: F401
