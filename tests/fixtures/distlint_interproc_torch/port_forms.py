"""The port's own collective call forms under the shared rules:
torch.distributed's functions (as `backends/process.py` calls them),
`ProcessGroup._dispatch`, and `nn/functional.py`'s rank collectives."""

import torch.distributed as tdist

from pytorch_distributed_example_tpu_torch.nn import functional as nnf


def gated_torch_distributed(t, rank, pg):
    if rank == 0:
        tdist.all_reduce(t, group=pg)  # expect: R001
    return t


def gated_dispatch(g, t):
    if g.rank() == 0:
        out, work = g._dispatch("all_reduce", t, None)  # expect: R001
        return out, work
    return t, None


def gated_rank_collectives(x, rank, perm):
    if rank > 0:
        return nnf.ppermute(x, "dp", perm)  # expect: R001
    return nnf.rank_all_reduce(x)  # expect: R001


def swallowed_torch_distributed(t, pg, log):
    try:
        tdist.broadcast(t, src=0, group=pg)  # expect: R002
    except Exception:
        log.warning("broadcast failed")
    return t


def dropped_torch_work(t, pg):
    tdist.all_reduce(t, group=pg, async_op=True)  # expect: R006


def ungated(x, t, pg, perm):
    tdist.all_reduce(t, group=pg)
    return nnf.ppermute(nnf.rank_all_reduce(x), "dp", perm)
