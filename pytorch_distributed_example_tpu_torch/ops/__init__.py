"""Hand-written Hopper kernels for the port's hot ops, each beside its plain
PyTorch version (used for CPU tensors), and the dense attention oracle."""

from .flash_attention import (  # noqa: F401
    LAUNCHES,
    flash_attention,
    flash_with_lse,
    reset_launch_counts,
    resolved_block_sizes,
)
from .reference import dense_attention  # noqa: F401
