"""PyTorch/CUDA port of `pytorch_distributed_example_tpu`, for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
neither it nor JAX. Module names mirror the reference's. Each Pallas kernel
of the reference becomes a CUDA C++ kernel for sm_90a (`csrc/`), built at
first use by `ops/_build.py`.

Ported so far: the single-chip TransformerLM train step
(`examples/lm.py`), with flash attention's forward, dK/dV and dQ as Hopper
kernels (`ops/flash_attention.py`); ring and Ulysses attention in driver
mode (`parallel/context_parallel.py`); and the c10d core — process groups,
stores, rendezvous and every collective, in driver and multiproc mode
(`distributed.py`), driven by the toy all-reduce example
(`examples/toy.py`); and the reference workload on that core: the data
pipeline (`data/`), the MNIST ConvNet (`models/convnet.py`) and DDP with
ZeRO weight-update sharding (`parallel/ddp.py`), driven by the MNIST
example (`examples/mnist.py`) and timed by `bench.py`. ROADMAP.md lists
what is still to come.

Typical alias, as with the reference:

    import pytorch_distributed_example_tpu_torch as tdx

    tdx.init_process_group(backend="xla", world_size=8)   # 8 ranks on cuda:0
    t = tdx.DistTensor.from_rank_fn(lambda r: torch.tensor([float(r)]))
    tdx.all_reduce(t)          # every rank now holds sum(0..7)
"""

from .types import (  # noqa: F401
    DistBackendError,
    DistError,
    DistNetworkError,
    DistStoreError,
    DistTimeoutError,
    OpType,
    ReduceOp,
    Work,
)
from .mesh import DeviceMesh, init_device_mesh  # noqa: F401
from .distributed import (  # noqa: F401
    Backend,
    DistTensor,
    GroupMember,
    ProcessGroup,
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    destroy_process_group,
    gather,
    get_backend,
    get_rank,
    get_world_size,
    init_process_group,
    is_initialized,
    new_group,
    new_subgroups,
    scatter_object_list,
    get_process_group_ranks,
    default_pg_timeout,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    batch_isend_irecv,
    P2POp,
    irecv,
    isend,
    all_gather_object,
    broadcast_object_list,
    monitored_barrier,
    all_gather_into_tensor,
    all_to_all_single,
    reduce_scatter_tensor,
    split_group,
    shrink_group,
    gather_object,
    get_group_rank,
    get_global_rank,
    coalescing_manager,
    send_object_list,
    recv_object_list,
    all_reduce_coalesced,
    all_gather_coalesced,
    new_subgroups_by_enumeration,
    is_available,
    is_backend_available,
    is_nccl_available,
    is_gloo_available,
    is_mpi_available,
    is_ucc_available,
    is_torchelastic_launched,
    get_node_local_rank,
    get_pg_count,
    DebugLevel,
    get_debug_level,
    set_debug_level,
    set_debug_level_from_env,
    reduce_op,
)
from . import faults  # noqa: F401  (deterministic fault injection)
from .schedule import ScheduleMismatchError  # noqa: F401  (TDX_SCHEDULE_CHECK)
from .store import (  # noqa: F401  (torch exposes the store family here)
    FileStore,
    HashStore,
    PrefixStore,
    Store,
    TCPStore,
)

from .parallel.ddp import DistributedDataParallel  # noqa: F401

__version__ = "0.1.0"
