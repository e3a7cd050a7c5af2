"""Bucketed gradient Reducer — DDP's eager reduction path.

The port of the reference's `parallel/reducer.py`, after torch's C++
Reducer (`reducer.hpp:45-624`): size-capped bucket assignment
(`_compute_bucket_assignment_by_size`; a 25 MiB cap and a 1 MiB first
bucket, `nn/parallel/distributed.py:31`), buckets in reversed parameter
order (backward's production order, `distributed.py:1436-1438`), a flat
buffer a bucket, every bucket's mean all-reduce dispatched before any is
waited on, and the finalize that scatters each bucket back into its leaves
(`finalize_backward`, `reducer.hpp:289`).

Like the reference's, it works after the gradients exist, on a
rank-stacked tree (every leaf shaped (n, *param_shape): all W ranks' rows
in driver mode, this process's in multiproc mode). Each bucket's
all-reduce goes through `ProcessGroup._dispatch`, so it has a sequence
number, a flight-recorder entry and the watchdog's cover. The train step
(`ddp.make_ddp_train_step`) does not take this path: it reduces one flat
buffer per step.

`flatten_host_bucket` / `unflatten_host_bucket` are the host half of a
flat bucket (numpy in and out), and `Reducer.reduce_dist_tensors` reduces
`DistTensor`s in place. Bucket planning and the host buckets are Python
and numpy only: the reference's native paths for them
(`_native.compute_buckets`, `pack_f32`, `unpack_f32`) compute the same
results and are not ported.

A `comm_hook` replaces each bucket's all-reduce, in the reference's eager
contract `hook(backend, flat) -> (out, work)`, or `hook(backend, flat,
bucket_no)` for a hook that declares `wants_bucket_index` (the
block-quantized hook's `for_reducer`, whose error feedback is keyed by
bucket). A hook with `on_reduce_complete` has it called once a whole pass
has succeeded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..types import ReduceOp, Work

DEFAULT_BUCKET_CAP_MB = 25.0  # torch nn/parallel/distributed.py:31
DEFAULT_FIRST_BUCKET_BYTES = 1024 * 1024  # torch dist._DEFAULT_FIRST_BUCKET_BYTES


def compute_bucket_assignment_by_size(
    sizes_bytes: Sequence[int],
    bucket_cap_bytes: float = DEFAULT_BUCKET_CAP_MB * 1024 * 1024,
    first_bucket_bytes: float = DEFAULT_FIRST_BUCKET_BYTES,
) -> List[List[int]]:
    """Greedy size-capped bucketing — torch
    `_compute_bucket_assignment_by_size`. The first bucket gets a smaller
    cap so the first all-reduce launches early in backward."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0.0
    cap = first_bucket_bytes
    for i, sz in enumerate(sizes_bytes):
        if cur and cur_bytes + sz > cap:
            buckets.append(cur)
            cur = []
            cur_bytes = 0.0
            cap = bucket_cap_bytes
        cur.append(i)
        cur_bytes += sz
    if cur:
        buckets.append(cur)
    return buckets


def flatten_host_bucket(leaves: Sequence[np.ndarray]) -> np.ndarray:
    """Host (numpy) gradient leaves flattened into one fresh float32 buffer
    — the host half of torch's flat `Bucket.gradients` (`reducer.hpp:362`)."""
    return np.concatenate([np.asarray(l, np.float32).reshape(-1) for l in leaves])


def unflatten_host_bucket(flat: np.ndarray, shapes: Sequence[Tuple[int, ...]]) -> List[np.ndarray]:
    """The inverse of `flatten_host_bucket` (torch's bucket views scatter):
    fresh float32 arrays of `shapes`, `()` taking one element and a
    zero-size shape none."""
    res, off = [], 0
    flat = np.asarray(flat, np.float32).reshape(-1)
    for s in map(tuple, shapes):
        n = int(np.prod(s))
        res.append(flat[off:off + n].reshape(s).copy())
        off += n
    return res


@dataclass
class Bucket:
    """Flat bucket of gradient leaves — torch `Bucket` (reducer.hpp:356)."""

    leaf_indices: List[int]
    offsets: List[int]
    lengths: List[int]
    shapes: List[Tuple[int, ...]]
    pending_work: Optional[Work] = None
    flat: Any = None  # rank-stacked (n, total) tensor while in flight


class Reducer:
    """Post-grad bucketed mean all-reduce over a process group.

    `reduce(grads)` takes a rank-stacked gradient tree and returns the same
    tree with every rank's row holding the mean over the group."""

    def __init__(
        self,
        process_group=None,
        bucket_cap_mb: float = DEFAULT_BUCKET_CAP_MB,
        first_bucket_bytes: int = DEFAULT_FIRST_BUCKET_BYTES,
        comm_hook: Optional[Callable] = None,
        gradient_as_bucket_view: bool = False,
    ):
        from .. import distributed as dist

        self.group = dist._resolve(process_group)
        self.bucket_cap_bytes = bucket_cap_mb * 1024 * 1024
        self.first_bucket_bytes = first_bucket_bytes
        if gradient_as_bucket_view:
            # torch's flag makes the grads views of the buckets; the reduced
            # tree here is always a fresh one
            raise NotImplementedError("gradient_as_bucket_view=True: reduce() returns new tensors")
        self.comm_hook = comm_hook
        self._buckets_spec: Optional[List[List[int]]] = None
        # DDP Logger food (torch logger.hpp:42-90)
        self.stats = {
            "num_buckets": 0,
            "bucket_sizes": [],
            "reduce_calls": 0,
            "rebuilds": 0,
        }

    # -- bucket planning ---------------------------------------------------
    def build_buckets(self, leaves) -> List[List[int]]:
        """Plan buckets over rank-stacked gradient leaves in REVERSED order
        (torch reverses params to approximate backward's production order,
        distributed.py:1436-1438)."""
        sizes = [l[0].numel() * l.dtype.itemsize for l in leaves]
        order = list(range(len(leaves)))[::-1]
        assignment_rev = compute_bucket_assignment_by_size(
            [sizes[i] for i in order], self.bucket_cap_bytes, self.first_bucket_bytes
        )
        assignment = [[order[j] for j in b] for b in assignment_rev]
        self._buckets_spec = assignment
        self.stats["num_buckets"] = len(assignment)
        self.stats["bucket_sizes"] = [sum(sizes[i] for i in b) for b in assignment]
        self.stats["rebuilds"] += 1
        return assignment

    # -- the reduction -----------------------------------------------------
    def reduce(self, grads, require_sync: bool = True):
        """Bucketed mean all-reduce of a rank-stacked grad tree.

        With `require_sync=False` (the `no_sync()` context, torch
        `distributed.py:1659`) nothing is communicated and the local grads
        come back unchanged: accumulating them is the caller's business."""
        leaves, treedef = pytree.tree_flatten(grads)
        if not leaves or not require_sync:
            return grads
        self.stats["reduce_calls"] += 1
        if self._buckets_spec is None:
            self.build_buckets(leaves)

        backend = self.group.backend_impl
        in_flight: List[Bucket] = []
        # dispatch every bucket before waiting on any
        for bucket_no, idx_list in enumerate(self._buckets_spec):
            n = leaves[idx_list[0]].shape[0]
            shapes = [tuple(leaves[i].shape[1:]) for i in idx_list]
            lengths = [int(torch.Size(s).numel()) for s in shapes]
            offsets = [sum(lengths[:j]) for j in range(len(lengths))]
            flat = torch.cat([leaves[i].reshape(n, -1) for i in idx_list], dim=1)
            # `detail` feeds the schedule fingerprint: ranks disagreeing on
            # which hook runs must diverge even when bucket shapes match
            hook = self.comm_hook
            if hook is None:
                run, detail = (lambda flat=flat: backend.allreduce(flat, ReduceOp.AVG),
                               str(ReduceOp.AVG))
            elif getattr(hook, "wants_bucket_index", False):
                run = lambda flat=flat, bno=bucket_no: hook(backend, flat, bno)  # noqa: E731
                detail = getattr(hook, "__name__", "comm_hook")
            else:
                run = lambda flat=flat: hook(backend, flat)  # noqa: E731
                detail = getattr(hook, "__name__", "comm_hook")
            out, work = self.group._dispatch(f"reduce_bucket[{bucket_no}]", flat, run,
                                             detail=detail)
            in_flight.append(Bucket(idx_list, offsets, lengths, shapes, work, out))

        # finalize: wait, then scatter each bucket back (torch finalize_backward)
        new_leaves = list(leaves)
        for b in in_flight:
            b.pending_work.wait()
            n = b.flat.shape[0]
            for i, off, ln, shp in zip(b.leaf_indices, b.offsets, b.lengths, b.shapes):
                new_leaves[i] = b.flat[:, off:off + ln].reshape((n,) + shp)
        # a stateful hook stages per-bucket state and commits it only after
        # a whole pass: a fault at ANY bucket leaves the carry untouched
        if hasattr(self.comm_hook, "on_reduce_complete"):
            self.comm_hook.on_reduce_complete()
        return pytree.tree_unflatten(new_leaves, treedef)

    def reduce_dist_tensors(self, grads_dt: Sequence[Any], require_sync: bool = True) -> None:
        """`reduce` over `DistTensor`s, in place (torch-style mutation):
        each takes its reduced rank-stacked tensor."""
        red = self.reduce([dt.tensor for dt in grads_dt], require_sync)
        for dt, t in zip(grads_dt, red):
            dt._set(t)
