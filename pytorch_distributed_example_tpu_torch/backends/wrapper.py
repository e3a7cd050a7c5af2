"""ProcessGroupWrapper — debug interposer verifying collective consistency.

Parity surface: torch `ProcessGroupWrapper.hpp:3-13` + creation under
`TORCH_DISTRIBUTED_DEBUG=DETAIL` (`distributed_c10d.py:5440`), the
reference's `backends/wrapper.py`: before dispatching a collective, verify
that every rank is issuing the SAME op with consistent tensor metadata; on
mismatch, raise naming the offending ranks instead of deadlocking inside
the transport.

Mechanism here: each rank publishes `pgw/<seq>/<rank> = fingerprint`
through the group's store and waits for all ranks' keys; fingerprints are
compared before the underlying backend runs. In driver (single-controller)
mode all ranks share one caller, so the check degenerates to recording —
one caller cannot issue two ranks different collectives — but the
multiproc path is real.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

from ..store import Store
from ..types import DistError, ReduceOp, Work
from .base import Backend


class CollectiveMismatchError(RuntimeError):
    pass


class ProcessGroupWrapper(Backend):
    name = "wrapper"

    def __init__(
        self,
        inner: Backend,
        store: Optional[Store],
        my_rank: int,
        world_size: int,
        driver_mode: bool = True,
    ):
        super().__init__(inner.mesh, inner.rank, inner.world_size, inner.timeout)
        self.inner = inner
        self.store = store
        self.my_rank = my_rank
        self.world_size = world_size  # logical group size (super() set inner's)
        self.driver_mode = driver_mode
        self._check_seq = 0

    # -- NaN audit (torch NanCheck.hpp / TORCH_NCCL_NAN_CHECK parity) ------
    def _nan_check(self, op: str, x) -> None:
        """When TDX_NAN_CHECK=1, refuse to communicate non-finite data —
        the debug-mode input audit the NCCL backend runs before each
        collective (ProcessGroupNCCL.hpp:147). On the device for a CUDA
        tensor; the native scan, else torch, for a CPU one."""
        import os

        import torch

        if os.environ.get("TDX_NAN_CHECK", "0") != "1":
            return
        if not isinstance(x, torch.Tensor) or not x.dtype.is_floating_point:
            return  # barrier, integer and bool payloads cannot be non-finite
        bad = None
        if x.device.type == "cpu" and x.dtype != torch.float64:
            # f16/bf16 upcast losslessly into f32 (bf16 shares its exponent
            # range); float64 is scanned at full precision below, since a
            # downcast would overflow large finite values to inf
            from .. import _native

            bad = _native.count_nonfinite(x)
        if bad is None:
            bad = int((~torch.isfinite(x)).sum())
        if bad:
            raise FloatingPointError(
                f"nan check: {op} input contains {bad} non-finite value(s)"
            )

    # -- the consistency check --------------------------------------------
    def _fingerprint(self, op: str, x) -> str:
        shape = tuple(getattr(x, "shape", ()))
        dtype = str(getattr(x, "dtype", "")).removeprefix("torch.")
        return f"{op}|{shape}|{dtype}"

    def _verify(self, op: str, x) -> None:
        self._check_seq += 1
        self._nan_check(op, x)
        fp = self._fingerprint(op, x)
        if self.store is None:
            return
        seq = self._check_seq
        if self.driver_mode:
            # one caller acts for every rank: publish once, self-consistent
            self.store.set(f"pgw/{seq}/all", fp)
            if seq > 1 and hasattr(self.store, "delete_key"):
                try:
                    self.store.delete_key(f"pgw/{seq - 1}/all")
                except (DistError, OSError):
                    pass  # best-effort GC of the previous round's key
            return
        self.store.set(f"pgw/{seq}/{self.my_rank}", fp)
        keys = [f"pgw/{seq}/{r}" for r in range(self.world_size)]
        self.store.wait(keys, self.timeout)
        fps = {r: self.store.get(f"pgw/{seq}/{r}").decode() for r in range(self.world_size)}
        bad = {r: v for r, v in fps.items() if v != fp}
        if bad:
            raise CollectiveMismatchError(
                f"collective mismatch at seq {seq}: rank {self.my_rank} ran "
                f"{fp!r} but {bad}"
            )
        # bound store growth: drop the previous round's keys (every rank has
        # passed `wait` on round seq, so round seq-1 can no longer be read)
        if seq > 1 and hasattr(self.store, "delete_key"):
            try:
                self.store.delete_key(f"pgw/{seq - 1}/{self.my_rank}")
            except (DistError, OSError):
                pass  # best-effort GC of the previous round's key

    # -- delegated collectives --------------------------------------------
    def allreduce(self, x, op: Any = ReduceOp.SUM):
        self._verify(f"allreduce:{op}", x)
        return self.inner.allreduce(x, op)

    def broadcast(self, x, src: int):
        self._verify(f"broadcast:{src}", x)
        return self.inner.broadcast(x, src)

    def reduce(self, x, dst: int, op: Any = ReduceOp.SUM):
        self._verify(f"reduce:{dst}:{op}", x)
        return self.inner.reduce(x, dst, op)

    def allgather(self, x):
        self._verify("allgather", x)
        return self.inner.allgather(x)

    def gather(self, x, dst: int):
        self._verify(f"gather:{dst}", x)
        return self.inner.gather(x, dst)

    def scatter(self, x, src: int):
        self._verify(f"scatter:{src}", x)
        return self.inner.scatter(x, src)

    def reduce_scatter(self, x, op: Any = ReduceOp.SUM):
        self._verify(f"reduce_scatter:{op}", x)
        return self.inner.reduce_scatter(x, op)

    def alltoall(self, x):
        self._verify("alltoall", x)
        return self.inner.alltoall(x)

    def permute(self, x, perm: Sequence[Tuple[int, int]]):
        self._verify(f"permute:{tuple(perm)}", x)
        return self.inner.permute(x, perm)

    def barrier(self) -> Work:
        self._verify("barrier", None)
        return self.inner.barrier()

    # -- passthroughs ------------------------------------------------------
    def next_sequence_number(self) -> int:
        return self.inner.next_sequence_number()

    def get_sequence_number_for_group(self) -> int:
        return self.inner.get_sequence_number_for_group()

    def abort(self):
        self.inner.abort()

    def shutdown(self):
        self.inner.shutdown()
