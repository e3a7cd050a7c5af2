"""Parallelism of the port, in driver mode (the ranks' shards stacked on
one device) and in multiproc mode (one process a rank, through the c10d
core): data parallelism (DDP with ZeRO weight-update sharding, its
Reducer and comm hooks: compression, block-quantized and PowerSGD),
context parallelism (ring attention and Ulysses), sharding rules, FSDP
(ZeRO-3) with ZeRO-2 and ZeRO-1, tensor parallelism, expert parallelism
and pipeline parallelism (GPipe, 1F1B, interleaved); Join for uneven
inputs and post-local SGD with periodic and hierarchical model
averaging (`HierarchicalModelAverager` in driver mode)."""

from . import comm_hooks  # noqa: F401
from .comm_hooks import (  # noqa: F401
    BlockwiseQuantHook,
    PowerSGDHook,
    allreduce_hook,
    bf16_compress_hook,
    blockwise_quant_hook,
    fp16_compress_hook,
    noop_hook,
    powerSGD_hook,
    quantize_hook,
)
from .context_parallel import (  # noqa: F401
    auto_block_kernel,
    make_cp_attention,
    ring_attention,
    ulysses_attention,
)
from .ddp import DistributedDataParallel, make_ddp_train_step, make_eval_step  # noqa: F401
from .reducer import Reducer  # noqa: F401
from .join import Join, Joinable, JoinHook, join_batches  # noqa: F401
from .localsgd import (  # noqa: F401
    HierarchicalModelAverager,
    PeriodicModelAverager,
    init_stacked_opt_state,
    make_localsgd_train_step,
    stack_replicas,
    unstack_replicas,
)
from . import sharding  # noqa: F401
from . import zero  # noqa: F401
from .fsdp import (  # noqa: F401
    FSDPModule,
    fully_shard,
    make_fsdp_train_step,
    make_zero2_train_step,
    shard_optimizer_only,
)
from .tensor_parallel import (  # noqa: F401
    ColwiseParallel,
    RowwiseParallel,
    SequenceParallel,
    loss_parallel,
    parallelize_module,
    vocab_parallel_cross_entropy,
)
from .expert_parallel import make_ep_moe, moe_mlp  # noqa: F401
from .pipeline import (  # noqa: F401
    make_pipeline_fn,
    make_pipeline_train_fn,
    merge_microbatches,
    pipeline_apply,
    pipeline_apply_interleaved,
    pipeline_train_1f1b,
    split_microbatches,
    stack_stage_params,
)
