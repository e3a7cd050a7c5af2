"""StackedBackend — driver-mode collectives over a rank-stacked tensor.

The driver-mode half of the port of the reference's `backends/xla.py`.
There each collective is a `shard_map` program over the group's 1-D device
mesh (`psum`, `all_gather`, `psum_scatter`, `all_to_all`, `ppermute`). Here
the W ranks of a group are the rows of one `(W, *t)` tensor on one device,
so each collective is a plain torch computation over dim 0 of that tensor:
a reduction is `types.fold(op)` over the rows, a gather a copy of every row
to every rank, a permute an index over the rows. The semantics are the
reference's, source masks included: non-destination ranks of `reduce` keep
their input, and non-destination ranks of `gather` get zeros.

Every result holds W separate rows: a reduction is materialized W times,
never an `expand()` view of one row, so an in-place op on one rank's result
leaves every other rank's alone (the reference's `psum` writes W copies).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from ..mesh import DeviceMesh
from ..types import OpType, ReduceOp, TensorWork, Work, fold
from .base import Backend

# ops the reference's reduce_scatter takes (`backends/xla.py:200-225`);
# PREMUL_SUM has none there
_SCATTER_FOLDS = (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.MAX, ReduceOp.MIN,
                  ReduceOp.PRODUCT, ReduceOp.BAND, ReduceOp.BOR, ReduceOp.BXOR)


def check_scatter_op(op, dtype: torch.dtype) -> None:
    """Refuse what the reference's reduce_scatter refuses: PREMUL_SUM, and
    bool operands of SUM and AVG (its `psum_scatter` takes no bool)."""
    if op not in _SCATTER_FOLDS:
        raise NotImplementedError(f"reduce_scatter op {op}")
    if dtype == torch.bool and op in (ReduceOp.SUM, ReduceOp.AVG):
        raise TypeError(f"reduce_scatter {op} does not accept dtype bool")


def _rows(row: torch.Tensor, w: int) -> torch.Tensor:
    """W materialized copies of one row: (w, *row.shape)."""
    return row.unsqueeze(0).expand((w,) + tuple(row.shape)).clone()


class StackedBackend(Backend):
    """Collectives over dim 0 of a rank-stacked tensor on one device."""

    name = "stacked"

    def __init__(self, mesh: DeviceMesh, rank: int, world_size: int, timeout: float = 1800.0):
        super().__init__(mesh.flattened("_ranks"), rank, world_size, timeout)

    def _work(self, out, op_type: OpType, title: str) -> Tuple[Any, Work]:
        return out, TensorWork(out, op_type, f"stacked:{title}", device=out.device)

    # -- collectives -------------------------------------------------------
    def allreduce(self, x, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        return self._work(_rows(fold(op)(x), x.shape[0]), OpType.ALLREDUCE, "all_reduce")

    def broadcast(self, x, src: int) -> Tuple[Any, Work]:
        return self._work(_rows(x[src], x.shape[0]), OpType.BROADCAST, "broadcast")

    def reduce(self, x, dst: int, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        r = fold(op)(x)
        # the reference's `where(i == dst, r, t)` promotes the kept inputs to
        # the reduction's dtype (an int32 AVG makes every row float32)
        out = x.to(r.dtype, copy=True)
        out[dst] = r
        return self._work(out, OpType.REDUCE, "reduce")

    def allgather(self, x) -> Tuple[Any, Work]:
        return self._work(_rows(x, x.shape[0]), OpType.ALLGATHER, "all_gather")

    def gather(self, x, dst: int) -> Tuple[Any, Work]:
        out = x.new_zeros((x.shape[0],) + tuple(x.shape))
        out[dst] = x
        return self._work(out, OpType.GATHER, "gather")

    def scatter(self, x, src: int) -> Tuple[Any, Work]:
        # x: (W, W, *s), each rank's list of W chunks; src's list survives
        return self._work(x[src].clone(), OpType.SCATTER, "scatter")

    def reduce_scatter(self, x, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        # x: (W, W, *s); folding the rank dim leaves row i = rank i's chunk
        check_scatter_op(op, x.dtype)
        return self._work(fold(op)(x).contiguous(), OpType.REDUCE_SCATTER, "reduce_scatter")

    def alltoall(self, x) -> Tuple[Any, Work]:
        # x: (W, W, *s); row j of rank i goes to rank j's row i
        return self._work(x.transpose(0, 1).contiguous(), OpType.ALLTOALL, "all_to_all")

    def permute(self, x, perm: Sequence[Tuple[int, int]]) -> Tuple[Any, Work]:
        src = list(range(x.shape[0]))
        for s, d in perm:
            src[int(d)] = int(s)
        idx = torch.tensor(src, device=x.device)
        return self._work(x.index_select(0, idx), OpType.SEND, "permute")

    def barrier(self) -> Work:
        dev = self.mesh.device
        out, _ = self.allreduce(torch.zeros((self.world_size, 1), device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return TensorWork(out, OpType.BARRIER, "stacked:barrier")
