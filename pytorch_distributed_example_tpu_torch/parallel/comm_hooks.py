"""DDP communication hooks: the default mean all-reduce and the no-op.

The port of the reference's `parallel/comm_hooks.py` (torch's builtin
ALLREDUCE hook, `default_hooks.py:allreduce_hook`). A hook is
`hook(grads, group) -> grads`, where `grads` is the DistTensor of this
process's ranks' flat gradient buffers (n, N); it replaces the train
step's gradient reduction. Under ZeRO the step fuses the default hook into
one reduce-scatter and takes each rank's shard from any other hook's
output. The compression, quantized, PowerSGD and planner hooks are still
to port (ROADMAP, Queue 1 items 2 and 4).
"""

from __future__ import annotations

from typing import Callable

from .. import distributed as dist
from ..tensor import DistTensor
from ..types import ReduceOp

Hook = Callable[[DistTensor, object], DistTensor]


def allreduce_hook(grads: DistTensor, group) -> DistTensor:
    """Default: the mean over the group (all_reduce AVG)."""
    dist.all_reduce(grads, ReduceOp.AVG, group)
    return grads


def noop_hook(grads: DistTensor, group) -> DistTensor:
    """No reduction (single-rank groups, debugging)."""
    return grads
