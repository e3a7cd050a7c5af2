"""Parallelism of the port: data parallelism (DDP with ZeRO weight-update
sharding, its Reducer and comm hooks: compression, block-quantized and
PowerSGD) over the c10d core, in driver and
multiproc mode; and, in driver mode (the ranks' shards stacked on one
device), context parallelism (ring attention and Ulysses), sharding rules,
FSDP (ZeRO-3) with ZeRO-2 and ZeRO-1, tensor parallelism, expert
parallelism and pipeline parallelism (GPipe, 1F1B, interleaved)."""

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
