"""The CPU side of a float32 card-against-CPU check.

PyTorch's CPU build computes a process's first float32 `torch.exp` after
an MKL batched matmul wrong in its first elements, by up to 1.5e-4
relative, in a few percent of fresh processes (more with more intra-op
threads; `tests/_flash_f32_fresh.py exp` shows it). A check whose CPU
reference is that first `exp` (the plain flash forward's softmax, a
cross-entropy) then fails with the card right. `cpu_reference()` runs one
float32 batched matmul and then one float32 `exp` over enough elements to
reach every intra-op thread, once a process, before the reference is
computed; `threads=` also runs the reference under that many intra-op
threads and restores the count afterwards.

    with cpu_reference(threads=1):
        want = plain_version(cpu_inputs)
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

_primed = False


def prime() -> None:
    """One float32 MKL batched matmul, then one float32 `exp`, once a process."""
    global _primed
    if _primed:
        return
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(8, 128, 64, generator=gen)
    b = torch.randn(8, 64, 128, generator=gen)
    torch.bmm(a, b)
    torch.exp(-torch.rand(1 << 20, generator=gen))
    _primed = True


@contextlib.contextmanager
def cpu_reference(threads: Optional[int] = None):
    """Prime the CPU's float32 path (`prime`), and with `threads` run the
    body under that many intra-op threads, restored on exit."""
    prime()
    old = torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        yield
    finally:
        if threads is not None:
            torch.set_num_threads(old)
