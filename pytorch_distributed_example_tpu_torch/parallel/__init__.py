"""Parallelism of the port. So far context parallelism (ring attention and
Ulysses) in driver mode: the ranks' shards stacked on one device."""

from .context_parallel import (  # noqa: F401
    auto_block_kernel,
    make_cp_attention,
    ring_attention,
    ulysses_attention,
)
