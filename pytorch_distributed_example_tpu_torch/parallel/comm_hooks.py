"""DDP communication hooks: the port of the reference's `parallel/comm_hooks.py`
(torch's builtin hooks, `default_hooks.py` and `powerSGD_hook.py`).

A hook replaces the train step's gradient reduction. Two shapes:

* **flat** hooks, `hook(grads, group) -> grads`, where `grads` is the
  DistTensor of this process's ranks' flat gradient buffers (n, N), every
  leaf packed in ZeRO's shard layout (`zero.ShardLayout`). Their work is
  elementwise, so the packing changes nothing: `allreduce_hook` (the
  default), `noop_hook`, `bf16_compress_hook` and `fp16_compress_hook`.
  Under ZeRO the step fuses the default hook into one reduce-scatter and
  takes each rank's shard from any other hook's output.
* **per-leaf** hooks (`per_leaf = True`), whose work restarts at every
  leaf: `hook(grads, group) -> grads` with `grads` a list of DistTensors,
  one a parameter, each (n, *shape), in the params' order. The
  block-quantized hook's blocks start at every leaf and tiny leaves take
  its exact path; PowerSGD reshapes each leaf to a matrix. A **stateful**
  hook (`init` and `apply`) is per-leaf: `apply(state, grads, group) ->
  (grads, state)`; `init(params)` builds one rank's state and the step
  carries it per rank, with a leading dim of this process's ranks
  (`step.init_hook_state`): each rank's error feedback grows from its own
  gradients.

The per-leaf hooks reduce every leaf as the reference does, leaf by leaf,
but send the leaves of one phase together: the collectives are elementwise
and the quantization blocks never straddle two leaves, so one collective
a phase gives the per-leaf results bit for bit.

The block-quantized hook also serves the eager bucketed `Reducer`
(`BlockwiseQuantHook.for_reducer`): a bucket's flat (n, total) buffer a
call, error feedback carried on the host side per bucket, staged during a
pass and committed when the whole pass has succeeded. The planner's hook
(`planner_hook`) comes with the collective planner (ROADMAP, Queue 1
item 4).
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import distributed as dist
from ..ops import quant as _q
from ..tensor import DistTensor
from ..types import ReduceOp

Hook = Callable


def allreduce_hook(grads: DistTensor, group) -> DistTensor:
    """Default: the mean over the group (all_reduce AVG)."""
    dist.all_reduce(grads, ReduceOp.AVG, group)
    return grads


def noop_hook(grads: DistTensor, group) -> DistTensor:
    """No reduction (single-rank groups, debugging)."""
    return grads


def _compress_hook(dtype):
    def hook(grads: DistTensor, group) -> DistTensor:
        orig = grads.dtype
        small = DistTensor.wrap(grads.tensor.to(dtype), group)
        dist.all_reduce(small, ReduceOp.AVG, group)
        return DistTensor.wrap(small.tensor.to(orig), group)

    return hook


bf16_compress_hook = _compress_hook(torch.bfloat16)
bf16_compress_hook.__name__ = "bf16_compress_hook"
bf16_compress_hook.__doc__ = """bfloat16-compressed mean all-reduce (torch
`bf16_compress_hook`): half the wire bytes, cast back after."""
fp16_compress_hook = _compress_hook(torch.float16)
fp16_compress_hook.__name__ = "fp16_compress_hook"
fp16_compress_hook.__doc__ = """float16-compressed mean all-reduce (torch
FP16_COMPRESS, `default_comm_hooks.hpp:9-34`)."""


def quantize_hook(bits: int = 8):
    """Deprecated alias of `blockwise_quant_hook(bits, error_feedback=False)`."""
    warnings.warn(
        "quantize_hook is deprecated: it is now an alias for "
        "blockwise_quant_hook(error_feedback=False); call that directly "
        "(error_feedback=True adds the bias-killing residual carry)",
        DeprecationWarning,
        stacklevel=2,
    )
    return blockwise_quant_hook(bits=bits, error_feedback=False)


def _mean_of_leaves(leaves: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Each (n, *shape) leaf's mean over the group, in one AVG all-reduce
    of the leaves packed side by side (elementwise: the per-leaf means)."""
    if not leaves:
        return []
    n = leaves[0].shape[0]
    flat = DistTensor.wrap(torch.cat([l.reshape(n, -1) for l in leaves], dim=1), group)
    dist.all_reduce(flat, ReduceOp.AVG, group)
    out, off = [], 0
    for l in leaves:
        k = l[0].numel()
        out.append(flat.tensor[:, off:off + k].reshape(l.shape))
        off += k
    return out


# ---------------------------------------------------------------------------
# PowerSGD: low-rank gradient compression with error feedback
# ---------------------------------------------------------------------------


class PowerSGDHook:
    """PowerSGD (Vogels et al., NeurIPS 2019), torch's `powerSGD_hook.py`.

    Per matrix-shaped gradient M (a leaf reshaped to (shape[0], rest)),
    with per-rank state:
      M' = M + error;  P = M' Q;  P <- mean(P);  P <- orthogonalize(P)
      Q = M'^T P;  Q <- mean(Q);  approx = P Q^T;  error = M' - approx
    Wire elements r (n + m) instead of n m. Leaves with fewer than 2 dims,
    or too small to win `min_compression_rate`, are mean-reduced whole.

    The initial Q comes from `np.random.default_rng(seed)`, drawn leaf by
    leaf in the order of the params given to `init`: the reference draws in
    its flax tree's flattened order, which `models.convert`'s `*_from_flax`
    dicts keep. `start_powerSGD_iter` is the caller's: switch step
    functions after the warm-up, as in the reference."""

    per_leaf = True

    def __init__(self, rank: int = 2, min_compression_rate: float = 2.0,
                 use_error_feedback: bool = True, warm_start: bool = True, seed: int = 0):
        self.rank = rank
        self.min_compression_rate = min_compression_rate
        self.use_error_feedback = use_error_feedback
        self.warm_start = warm_start
        self.seed = seed

    def _should_compress(self, shape) -> bool:
        if len(shape) < 2:
            return False
        n, m = int(shape[0]), int(np.prod(shape[1:]))
        r = min(self.rank, n, m)
        return n * m >= self.min_compression_rate * r * (n + m)

    def init(self, params):
        """One rank's state for a dict of params: {"error": [...], "q":
        [...]}, a leaf each, empty (0,) for leaves sent whole."""
        gen = np.random.default_rng(self.seed)
        errors, qs = [], []
        for leaf in params.values():
            dev = leaf.device
            if self._should_compress(leaf.shape):
                n, m = int(leaf.shape[0]), int(np.prod(leaf.shape[1:]))
                r = min(self.rank, n, m)
                errors.append(torch.zeros((n, m), dtype=torch.float32, device=dev))
                qs.append(torch.from_numpy(
                    gen.standard_normal((m, r)).astype(np.float32)).to(dev))
            else:
                errors.append(torch.zeros((0,), dtype=torch.float32, device=dev))
                qs.append(torch.zeros((0,), dtype=torch.float32, device=dev))
        return {"error": errors, "q": qs}

    def apply(self, state, grads: List[DistTensor], group):
        """(reduced grads, new state); every state leaf (n, ...)."""
        leaves = [g.tensor for g in grads]
        errors, qs = state["error"], state["q"]
        whole = [i for i, q in enumerate(qs) if q[0].numel() == 0]
        comp = [i for i, q in enumerate(qs) if q[0].numel() > 0]
        out: list = [None] * len(leaves)
        new_errors, new_qs = list(errors), list(qs)
        for i, o in zip(whole, _mean_of_leaves([leaves[i] for i in whole], group)):
            out[i] = o
        mats, ps = {}, []
        for i in comp:
            n_local, rows, m = errors[i].shape
            mat = leaves[i].reshape(n_local, rows, m).float()
            if self.use_error_feedback:
                mat = mat + errors[i]
            mats[i] = mat
            ps.append(torch.bmm(mat, qs[i]))
        ps = [torch.linalg.qr(p).Q for p in _mean_of_leaves(ps, group)]
        q_news = _mean_of_leaves(
            [torch.bmm(mats[i].transpose(1, 2), p) for i, p in zip(comp, ps)], group)
        for i, p, q_new in zip(comp, ps, q_news):
            approx = torch.bmm(p, q_new.transpose(1, 2))
            if self.use_error_feedback:
                new_errors[i] = mats[i] - approx
            if self.warm_start:
                new_qs[i] = q_new
            out[i] = approx.reshape(leaves[i].shape).to(leaves[i].dtype)
        return ([DistTensor.wrap(o, group) for o in out],
                {"error": new_errors, "q": new_qs})

    def compression_ratio(self, params) -> float:
        """Dense wire elements / PowerSGD's."""
        dense = comp = 0
        for leaf in params.values():
            size = int(np.prod(leaf.shape))
            dense += size
            if self._should_compress(leaf.shape):
                n = int(leaf.shape[0])
                m = size // n
                comp += min(self.rank, n, m) * (n + m)
            else:
                comp += size
        return dense / max(comp, 1)


def powerSGD_hook(rank: int = 2, **kw) -> PowerSGDHook:
    """torch-named constructor (`powerSGD_hook.py`)."""
    return PowerSGDHook(rank=rank, **kw)


# ---------------------------------------------------------------------------
# block-quantized wire all-reduce (EQuARX-style) with error feedback
# ---------------------------------------------------------------------------


class BlockwiseQuantHook:
    """Block-scaled wire-quantized gradient all-reduce with error feedback.

    Each leaf rides `ops.quant.quantized_all_reduce`: int8 (or the fp8
    grid in a bfloat16 container) on the wire in both phases, per-block
    float32 scales, a float32 combine. Error feedback carries the local
    phase-1 residual ``(g + e) - dequant(quant(g + e))`` per rank and adds
    it back next step. Stateful: `make_ddp_train_step` carries its state.
    `as_stateless()` is the form without the carry (the ZeRO-2 step's
    `comm_hook`)."""

    per_leaf = True

    def __init__(self, bits: int = 8, wire: Optional[str] = None, block_size: int = 256,
                 use_error_feedback: bool = True):
        if wire is None:
            if not 2 <= bits <= 8:
                raise ValueError(f"bits={bits} has no wire format; supported: 2..8 "
                                 f"(int8 container) and wire='fp8'")
            wire = "int8"
        if wire not in _q.WIRE_FORMATS:
            raise ValueError(f"unknown wire format {wire!r}; have {_q.WIRE_FORMATS}")
        if wire == "int8" and not 2 <= bits <= 8:
            raise ValueError(f"int8 wire carries 2..8 bit grids, got bits={bits}")
        if wire == "fp8" and bits != 8:
            raise ValueError(f"wire='fp8' has a fixed e4m3 value grid; bits={bits} "
                             "would be silently ignored (use the int8 wire for "
                             "narrower grids)")
        self.bits = bits
        self.wire = wire
        self.block_size = block_size
        self.use_error_feedback = use_error_feedback
        self.__name__ = f"blockwise_quant_hook_{wire}"

    def _reduce(self, leaves: List[torch.Tensor], group, with_residual: bool):
        return _q.quantized_all_reduce_many(
            leaves, group, wire=self.wire, block_size=self.block_size, bits=self.bits,
            mean=True, with_residual=with_residual)

    def init(self, params):
        """One rank's zero residual a leaf (float32, leaf-shaped)."""
        return {"error": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                          for p in params.values()]}

    def apply(self, state, grads: List[DistTensor], group):
        comp = [g.tensor.float() + e for g, e in zip(grads, state["error"])]
        outs, resid = self._reduce(comp, group, with_residual=True)
        errors = resid if self.use_error_feedback else state["error"]
        return ([DistTensor.wrap(o.to(g.dtype), group) for o, g in zip(outs, grads)],
                {"error": errors})

    def as_stateless(self) -> Hook:
        """A per-leaf `hook(grads, group)` without the residual carry."""
        def hook(grads: List[DistTensor], group) -> List[DistTensor]:
            outs = self._reduce([g.tensor for g in grads], group, with_residual=False)
            return [DistTensor.wrap(o.to(g.dtype), group) for o, g in zip(outs, grads)]

        hook.per_leaf = True
        hook.__name__ = f"blockwise_quant_hook_{self.wire}_stateless"
        return hook

    def for_reducer(self, group=None):
        """Adapter for `parallel.reducer.Reducer(comm_hook=...)`: the eager
        `(backend, flat, bucket_no) -> (out, work)` bucket contract over
        rank-stacked (n, total) buffers. Error feedback is carried per
        bucket index, staged during the pass and committed only when
        `Reducer.reduce` has finished the whole pass, so a `comm.quantize`
        fault at any bucket and a whole-pass retry replay exactly."""
        return _ReducerBlockwiseQuantHook(self, group)

    def compression_ratio(self, params=None) -> float:
        """Dense float32 wire bytes / this hook's: the wire format's alone."""
        return 4.0 / (_q.wire_itemsize(self.wire) + 4.0 / self.block_size)


class _ReducerBlockwiseQuantHook:
    """Eager bucket-path adapter: see `BlockwiseQuantHook.for_reducer`."""

    wants_bucket_index = True

    def __init__(self, hook: BlockwiseQuantHook, group=None):
        self.hook = hook
        self.group = dist._resolve(group)
        self.__name__ = f"{hook.__name__}_reducer"
        self._errors: dict = {}  # bucket_no -> (n, total) float32 residual
        self._pending: dict = {}  # staged this pass; committed at its end

    def __call__(self, backend, flat: torch.Tensor, bucket_no: int = 0):
        from .. import faults
        from ..types import OpType, TensorWork

        # the quantized dispatch is the injection seam, fired BEFORE any
        # state change: residuals are staged per bucket and committed only
        # by `on_reduce_complete`, so a transient fault at any bucket
        # leaves the carry untouched and a whole-pass retry replays exactly
        faults.fire("comm.quantize", bucket=bucket_no)
        err = self._errors.get(bucket_no)
        comp = flat.float()
        if err is not None and err.shape == flat.shape and self.hook.use_error_feedback:
            comp = comp + err
        (out,), (resid,) = self.hook._reduce([comp], self.group, with_residual=True)
        if self.hook.use_error_feedback:
            self._pending[bucket_no] = resid
        out = out.to(flat.dtype)
        return out, TensorWork(out, OpType.ALLREDUCE, "quant_bucket", device=out.device)

    def on_reduce_complete(self) -> None:
        """Pass-commit seam (called by `Reducer.reduce` after the finalize):
        this pass's staged residuals become the carried state."""
        self._errors.update(self._pending)
        self._pending.clear()


def blockwise_quant_hook(bits: int = 8, error_feedback: bool = True, wire: Optional[str] = None,
                         block_size: int = 256):
    """The block-quantized hook (`ops/quant.py`): the stateful
    `BlockwiseQuantHook` with `error_feedback`, else its stateless form.
    `wire="fp8"` takes the e4m3 grid in a bfloat16 container; int8 is the
    bandwidth row."""
    h = BlockwiseQuantHook(bits=bits, wire=wire, block_size=block_size,
                           use_error_feedback=error_feedback)
    return h if error_feedback else h.as_stateless()
