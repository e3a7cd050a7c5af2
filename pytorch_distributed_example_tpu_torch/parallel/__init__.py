"""Parallelism of the port: data parallelism (DDP with ZeRO weight-update
sharding, its Reducer and comm hooks) over the c10d core, in driver and
multiproc mode; and context parallelism (ring attention and Ulysses) in
driver mode, the ranks' shards stacked on one device."""

from .comm_hooks import allreduce_hook, noop_hook  # noqa: F401
from .context_parallel import (  # noqa: F401
    auto_block_kernel,
    make_cp_attention,
    ring_attention,
    ulysses_attention,
)
from .ddp import DistributedDataParallel, make_ddp_train_step, make_eval_step  # noqa: F401
from .reducer import Reducer  # noqa: F401
