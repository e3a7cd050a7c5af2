"""Core distributed types: ReduceOp, OpType, Work, the error family.

Parity surface (the reference's `types.py`):
  - `ReduceOp` algebra incl. PREMUL_SUM — torch c10d `Types.hpp:37-54`.
  - `OpType` enum — torch c10d `Work.hpp:15-37`.
  - `Work` async handle (`isCompleted`/`isSuccess`/`wait`/`synchronize`/
    `result`/`exception`) — torch c10d `Work.hpp:57-194`.

On the port a collective is a stream of kernels on the group's device. A
`TensorWork` records a `torch.cuda.Event` on the current stream after the
op: `is_completed` queries it and `wait` synchronizes on it. On the CPU
every op has finished when it returns, so its Work is complete at once.
"""

from __future__ import annotations

import enum
import functools
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch


class DistError(RuntimeError):
    """Base of the distributed error hierarchy — torch `DistError`
    (torch/csrc/distributed/c10d/exception.h)."""


class DistBackendError(DistError):
    """torch `DistBackendError` — backend resolution/dispatch failures."""


class DistStoreError(DistError):
    """torch `DistStoreError` — KV-store failures (timeouts subclass
    TimeoutError too, preserving existing except TimeoutError sites)."""


class DistNetworkError(DistError):
    """torch `DistNetworkError` — connection-level failures. Transient by
    taxonomy: the shared retry layer (`utils/retry.py`) backs off and
    retries these while its deadline allows."""


class DistTimeoutError(DistError, TimeoutError):
    """A retry/operation deadline expired. FATAL by taxonomy: the retry
    layer never retries one (a nested retry scope must not multiply the
    outer scope's budget), and raises it with the last transient error
    as `__cause__`."""


class ReduceOp(enum.Enum):
    """Reduction algebra for all_reduce / reduce / reduce_scatter.

    Same member set as torch c10d `Types.hpp:37-54`. `fold(op)` turns each
    into a reduction over the rank dim of a rank-stacked tensor; PREMUL_SUM
    scales by its factor, then sums (NCCL semantics).
    """

    SUM = "sum"
    AVG = "avg"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    BAND = "band"
    BOR = "bor"
    BXOR = "bxor"
    PREMUL_SUM = "premul_sum"

    def __call__(self, factor: float) -> "_PremulSum":
        if self is not ReduceOp.PREMUL_SUM:
            raise TypeError(f"{self} is not parameterizable")
        return _PremulSum(factor)


@dataclass(frozen=True)
class _PremulSum:
    """PREMUL_SUM with its scale factor (c10d `_make_nccl_premul_sum`)."""

    factor: float

    @property
    def base(self) -> ReduceOp:
        return ReduceOp.PREMUL_SUM


def _is_float(dtype: torch.dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a SUM yields: the reference's `psum` promotes bool to
    int32 and keeps every other dtype."""
    return torch.int32 if dtype == torch.bool else dtype


def avg_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype an AVG yields: the reference's `pmean` divides the SUM by
    the group size with true division, so integer and bool inputs come
    out float32 and floating inputs keep their dtype."""
    return dtype if _is_float(dtype) else torch.float32


def _sum(g: torch.Tensor) -> torch.Tensor:
    return g.sum(0).to(sum_dtype(g.dtype))


def _avg(g: torch.Tensor) -> torch.Tensor:
    s = _sum(g)
    return s.to(avg_dtype(g.dtype)) / g.shape[0]


def premul_operand(g: torch.Tensor, factor: float) -> torch.Tensor:
    """The operand of PREMUL_SUM's sum: `g` scaled by the factor in g's
    dtype (`x * asarray(f, x.dtype)`, so an integer tensor scales by int(f)
    and a bool one by bool(f)). Floating products stay float32: the
    reference's program fuses the scale into its sum without rounding
    them to a narrower dtype (bfloat16 products would each round)."""
    f = torch.tensor(factor, dtype=g.dtype, device=g.device)
    if _is_float(g.dtype):
        return g.float() * f.float()
    return g * f


def _premul(factor: float, g: torch.Tensor) -> torch.Tensor:
    return _sum(premul_operand(g, factor)).to(sum_dtype(g.dtype))


def _bitwise(binary, g: torch.Tensor) -> torch.Tensor:
    # torch has no bitwise reduction over a dim: fold the rows in rank order
    if _is_float(g.dtype):
        raise TypeError(f"bitwise reduction does not accept dtype {g.dtype}")
    return functools.reduce(binary, g.unbind(0)).clone()


_FOLDS = {
    ReduceOp.SUM: _sum,
    ReduceOp.PREMUL_SUM: _sum,  # bare PREMUL_SUM: factor 1
    ReduceOp.AVG: _avg,
    ReduceOp.MAX: lambda g: g.amax(0),
    ReduceOp.MIN: lambda g: g.amin(0),
    # prod of bool counts in int32, as the reference's `jnp.prod` does
    ReduceOp.PRODUCT: lambda g: g.prod(0).to(sum_dtype(g.dtype)),
    ReduceOp.BAND: functools.partial(_bitwise, torch.bitwise_and),
    ReduceOp.BOR: functools.partial(_bitwise, torch.bitwise_or),
    ReduceOp.BXOR: functools.partial(_bitwise, torch.bitwise_xor),
}


def fold(op) -> Callable[[torch.Tensor], torch.Tensor]:
    """ReduceOp -> f(g), which reduces dim 0 (the rank dim) of `g`.

    The single home of every op's arithmetic and result dtype, shared by
    the driver-mode backend (the whole rank-stacked tensor) and the
    multiproc backend (the gathered rows), so the two modes agree with
    each other and with the reference's `lower_reduce_op` and
    `_fold_op` (`types.py:88-111`, `backends/xla.py:30-58`)."""
    if isinstance(op, _PremulSum):
        return functools.partial(_premul, op.factor)
    try:
        return _FOLDS[op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r}") from None


class OpType(enum.Enum):
    """Collective op kinds — torch c10d `Work.hpp:15-37`."""

    BROADCAST = enum.auto()
    ALLREDUCE = enum.auto()
    ALLREDUCE_COALESCED = enum.auto()
    REDUCE = enum.auto()
    ALLGATHER = enum.auto()
    _ALLGATHER_BASE = enum.auto()
    ALLGATHER_COALESCED = enum.auto()
    GATHER = enum.auto()
    SCATTER = enum.auto()
    REDUCE_SCATTER = enum.auto()
    ALLTOALL_BASE = enum.auto()
    ALLTOALL = enum.auto()
    SEND = enum.auto()
    RECV = enum.auto()
    BARRIER = enum.auto()
    UNKNOWN = enum.auto()


class Work:
    """Async handle for a dispatched collective.

    Mirrors torch c10d `Work.hpp:57` (`isCompleted` `:69`, `wait`,
    `synchronize` `:100`, `result`, `exception`).
    """

    def __init__(self, op_type: OpType = OpType.UNKNOWN, profiling_title: str = ""):
        self._op_type = op_type
        self._profiling_title = profiling_title
        self._start = time.monotonic()

    # -- interface ---------------------------------------------------------
    def is_completed(self) -> bool:
        raise NotImplementedError

    def is_success(self) -> bool:
        return self.exception() is None

    def exception(self) -> Optional[BaseException]:
        return None

    def wait(self, timeout: Optional[float] = None) -> bool:
        raise NotImplementedError

    def synchronize(self) -> None:
        self.wait()

    def result(self) -> Any:
        raise NotImplementedError

    # torch-style aliases
    isCompleted = is_completed
    isSuccess = is_success

    @property
    def op_type(self) -> OpType:
        return self._op_type

    @property
    def profiling_title(self) -> str:
        return self._profiling_title


class TensorWork(Work):
    """Work over a result already enqueued on its device (the reference's
    `ArrayWork`). On a CUDA device it records an event on the current
    stream after the op; on the CPU the op has already run."""

    def __init__(
        self,
        result: Any,
        op_type: OpType = OpType.UNKNOWN,
        profiling_title: str = "",
        on_complete: Optional[Callable[[], None]] = None,
        device: Optional[torch.device] = None,
    ):
        super().__init__(op_type, profiling_title)
        self._result = result
        self._exception: Optional[BaseException] = None
        self._waited = False
        self._on_complete = on_complete
        self._event = None
        if device is not None and torch.device(device).type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def is_completed(self) -> bool:
        if self._waited or self._event is None:
            return True
        return self._event.query()

    def exception(self) -> Optional[BaseException]:
        return self._exception

    def wait(self, timeout: Optional[float] = None) -> bool:
        if self._waited:
            return True
        try:
            if self._event is not None:
                self._event.synchronize()
        except BaseException as e:  # a device fault surfaces here
            self._exception = e
            raise
        finally:
            self._waited = True
            if self._on_complete is not None:
                cb, self._on_complete = self._on_complete, None
                cb()
        return True

    def result(self) -> Any:
        self.wait()
        return self._result

    def release(self) -> None:
        """Drop the reference to the result (the event stays): for a Work
        that nobody will ask for its result."""
        self._result = None


class CompletedWork(Work):
    """Immediately-complete Work (barrier fast paths, fake backend)."""

    def __init__(self, result: Any = None, op_type: OpType = OpType.UNKNOWN):
        super().__init__(op_type)
        self._result = result

    def is_completed(self) -> bool:
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return True

    def result(self) -> Any:
        return self._result
