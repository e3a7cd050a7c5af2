"""ProcessBackend — multiproc-mode collectives through torch.distributed.

The multiproc half of the port of the reference's `backends/xla.py`. Each
process holds its own rank's row, a `(1, *t)` tensor, and each collective
calls torch.distributed on the torch.distributed group that
`distributed.py` built for this group from the port's own store: gloo for
CPU tensors, nccl for CUDA ones. The results have the driver-mode
semantics of `backends/stacked.py` and the same dtypes:

* all_reduce rides torch.distributed's all_reduce for SUM, AVG,
  PREMUL_SUM, MIN, MAX and PRODUCT (AVG and PREMUL_SUM as the reference
  computes them: a SUM, then a true division; the scaled operands summed
  in float32, see `types.premul_operand`); the bitwise ops and bool
  operands gather the rows and apply `types.fold`, which nccl would
  otherwise refuse;
* reduce and reduce_scatter reduce the whole operand the same way, and
  keep the destination's share (non-destination ranks of `reduce` keep
  their input);
* gather rides all_gather and zeroes every rank but the destination, as
  the reference does;
* the driver-mode permute is not here: `distributed.permute` moves a
  multiproc group's rows over the p2p plane.

gloo carries CUDA tensors too (the `"cuda:gloo"` backend: processes that
share one card). Its collectives copy a CUDA row to host memory and back
on their own streams; its send and recv read the row's pointer as host
memory and abort on a CUDA tensor, which is why no send or recv of the
port goes through gloo: they ride the p2p plane (`p2p.py`), which stages
a CUDA row through pinned host memory itself.

The collectives run synchronously; the `TensorWork` then records an event
on the current stream, which nccl's stream has been joined to.

`STATS` counts, for the process, the bytes each op hands its transport
(this process's input rows), the host seconds inside each op's
torch.distributed calls (which block until done, so on a card they
include gloo's own host copies); `reset_stats()` zeroes them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Tuple

import torch
import torch.distributed as tdist

from ..mesh import DeviceMesh
from ..types import (OpType, ReduceOp, TensorWork, Work, _PremulSum, avg_dtype, fold,
                     premul_operand)
from .base import Backend
from .stacked import check_scatter_op

_NATIVE_OPS = {
    ReduceOp.SUM: tdist.ReduceOp.SUM,
    ReduceOp.PREMUL_SUM: tdist.ReduceOp.SUM,
    ReduceOp.AVG: tdist.ReduceOp.SUM,
    ReduceOp.MIN: tdist.ReduceOp.MIN,
    ReduceOp.MAX: tdist.ReduceOp.MAX,
    ReduceOp.PRODUCT: tdist.ReduceOp.PRODUCT,
}


STATS = {"bytes": {}, "seconds": {}}


def reset_stats() -> None:
    STATS.update(bytes={}, seconds={})


@contextlib.contextmanager
def _count(op: str, t: torch.Tensor):
    """Count `t`'s bytes and the block's host seconds under `op`."""
    STATS["bytes"][op] = STATS["bytes"].get(op, 0) + t.numel() * t.element_size()
    t0 = time.perf_counter()
    yield
    STATS["seconds"][op] = STATS["seconds"].get(op, 0.0) + time.perf_counter() - t0


def wire(t: torch.Tensor) -> torch.Tensor:
    """What goes on the wire: bool travels as its bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


class ProcessBackend(Backend):
    """Collectives over one torch.distributed group, one rank per process."""

    name = "process"

    def __init__(self, mesh: DeviceMesh, rank: int, world_size: int, timeout: float,
                 torch_group):
        super().__init__(mesh.flattened("_ranks"), rank, world_size, timeout)
        self.torch_group = torch_group

    def _global(self, group_rank: int) -> int:
        return tdist.get_global_rank(self.torch_group, group_rank)

    def _work(self, out, op_type: OpType, title: str) -> Tuple[Any, Work]:
        return out, TensorWork(out, op_type, f"process:{title}", device=out.device)

    # -- building blocks ---------------------------------------------------
    def _gather_rows(self, row: torch.Tensor) -> torch.Tensor:
        """Every rank's row, stacked: (W, *row.shape)."""
        out = torch.empty((self.world_size,) + tuple(row.shape), dtype=row.dtype,
                          device=row.device)
        with _count("all_gather", row):
            tdist.all_gather(list(wire(out).unbind(0)), wire(row.contiguous()),
                             group=self.torch_group)
        return out

    def _reduced(self, row: torch.Tensor, op) -> torch.Tensor:
        """`fold(op)` over every rank's `row`, on every rank."""
        base = ReduceOp.PREMUL_SUM if isinstance(op, _PremulSum) else op
        if row.dtype == torch.bool or base not in _NATIVE_OPS:
            return fold(op)(self._gather_rows(row))
        if isinstance(op, _PremulSum):
            y = premul_operand(row, op.factor)
        else:
            y = row.clone()
        with _count("all_reduce", y):
            tdist.all_reduce(y, op=_NATIVE_OPS[base], group=self.torch_group)
        if base == ReduceOp.AVG:
            y = y.to(avg_dtype(row.dtype)) / self.world_size
        return y.to(row.dtype) if isinstance(op, _PremulSum) else y

    # -- collectives -------------------------------------------------------
    def allreduce(self, x, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        return self._work(self._reduced(x[0], op)[None], OpType.ALLREDUCE, "all_reduce")

    def broadcast(self, x, src: int) -> Tuple[Any, Work]:
        out = x.clone()
        with _count("broadcast", out):
            tdist.broadcast(wire(out), src=self._global(src), group=self.torch_group)
        return self._work(out, OpType.BROADCAST, "broadcast")

    def reduce(self, x, dst: int, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        r = self._reduced(x[0], op)
        out = r[None] if self.rank == dst else x.to(r.dtype, copy=True)
        return self._work(out, OpType.REDUCE, "reduce")

    def allgather(self, x) -> Tuple[Any, Work]:
        return self._work(self._gather_rows(x[0])[None], OpType.ALLGATHER, "all_gather")

    def gather(self, x, dst: int) -> Tuple[Any, Work]:
        g = self._gather_rows(x[0])[None]
        return self._work(g if self.rank == dst else torch.zeros_like(g), OpType.GATHER,
                          "gather")

    def scatter(self, x, src: int) -> Tuple[Any, Work]:
        # x: (1, W, *s), this rank's list of W chunks; src's list survives
        out = torch.empty_like(x[0, 0])
        chunks = [wire(c.contiguous()) for c in x[0].unbind(0)] if self.rank == src else None
        tdist.scatter(wire(out), chunks, src=self._global(src), group=self.torch_group)
        return self._work(out[None], OpType.SCATTER, "scatter")

    def reduce_scatter(self, x, op: Any = ReduceOp.SUM) -> Tuple[Any, Work]:
        check_scatter_op(op, x.dtype)
        r = self._reduced(x[0], op)
        return self._work(r[self.rank : self.rank + 1].clone(), OpType.REDUCE_SCATTER,
                          "reduce_scatter")

    def alltoall(self, x) -> Tuple[Any, Work]:
        # x: (1, W, *s); chunk j goes to rank j, chunk i of the output came from rank i
        out = torch.empty_like(x)
        with _count("all_to_all", x):
            tdist.all_to_all_single(wire(out[0]), wire(x[0].contiguous()),
                                    group=self.torch_group)
        return self._work(out, OpType.ALLTOALL, "all_to_all")

    def barrier(self) -> Work:
        dev = self.mesh.device
        out, _ = self.allreduce(torch.zeros((1, 1), device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return TensorWork(out, OpType.BARRIER, "process:barrier")

    def shutdown(self) -> None:
        super().shutdown()
        self.torch_group = None
