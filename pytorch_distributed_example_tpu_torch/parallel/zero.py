"""ZeRO weight-update sharding — the cross-replica update layout.

The port of the reference's `parallel/zero.py` ("Automatic Cross-Replica
Sharding of Weight Update", arxiv 2004.13336; DeepSpeed ZeRO-1). In data
parallelism every replica holds the whole optimizer state and runs the
whole update. Sharding the update means each rank owns 1/W of every
parameter: gradients are reduce-scattered to their owner, the optimizer
runs on the owned shard only (so its state is 1/W), and the updated shards
are all-gathered back into the replicated params. The wire cost equals
DDP's all-reduce; optimizer memory and update work drop to 1/W.

The layout is the reference's: a sharded leaf is its flat value zero-padded
to ``W * ceil(size/W)`` elements, so every leaf divides exactly and rank r
owns elements ``[r*k, (r+1)*k)``. (For the MNIST ConvNet at W 8, the 250
elements of the first conv's kernel become 256, 32 a rank.)

Where the reference reduces and gathers leaf by leaf inside its compiled
step, the port packs every leaf into one buffer (`ShardLayout`): each rank's
gradients as (W, K) — chunk r holds rank r's shard of every leaf, K the sum
of the leaves' chunks — so the step is ONE AVG reduce-scatter
(`reduce_scatter_mean`) and ONE all-gather (`unshard`) through the port's
c10d core, in driver and multiproc mode alike. A process holds its ranks'
rows: all W in driver mode, its own one in multiproc mode.

The sharded update is EXACT for elementwise optimizers (sgd, momentum):
each element's update depends only on its own history, so slicing commutes
with the update and the gathered params equal the unsharded step's bit for
bit, given the same reduced gradients.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from .. import distributed as dist
from ..tensor import DistTensor
from ..types import ReduceOp

__all__ = [
    "shard_chunk",
    "padded_flat",
    "shard_of",
    "to_shard_layout",
    "from_shard_layout",
    "ShardLayout",
    "reduce_scatter_mean",
    "unshard",
]


def shard_chunk(size: int, world: int) -> int:
    """Per-rank element count for a leaf of ``size`` elements."""
    return -(-int(size) // max(int(world), 1))


def padded_flat(leaf: torch.Tensor, world: int) -> torch.Tensor:
    """Flat (W*k,) copy of a leaf, zero-padded to the shard grid."""
    flat = leaf.reshape(-1)
    pad = world * shard_chunk(flat.numel(), world) - flat.numel()
    return F.pad(flat, (0, pad)) if pad else flat


def shard_of(leaf: torch.Tensor, index: int, world: int) -> torch.Tensor:
    """Rank ``index``'s (k,) shard of a full leaf."""
    k = shard_chunk(leaf.numel(), world)
    return padded_flat(leaf, world)[index * k:(index + 1) * k]


def to_shard_layout(tree, world: int):
    """Value-preserving conversion of a tree of tensors (an optimizer
    state, params) into the sharded layout: every leaf of rank >= 1
    becomes its padded flat (W*k,) vector, keyed by its own size, so
    param-shaped leaves land on the grid the step shards on. Scalar
    leaves stay replicated."""
    return pytree.tree_map(lambda l: padded_flat(l, world) if l.dim() else l, tree)


def from_shard_layout(tree, template):
    """Inverse of `to_shard_layout`: each flat leaf back to the shape and
    dtype of its ``template`` leaf."""
    def one(flat, ref):
        if not ref.dim():
            return flat
        return flat.reshape(-1)[:ref.numel()].reshape(ref.shape).to(ref.dtype)

    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(
        [one(f, r) for f, r in zip(leaves, pytree.tree_leaves(template))], spec)


class ShardLayout:
    """Where each leaf's shard sits in one flat buffer of K elements.

    Leaf i (``shapes[i]``, n_i elements) takes ``chunks[i] = ceil(n_i/W)``
    columns from ``offsets[i]``. `pack` turns leaves into (..., W, K) —
    row r of the W holds rank r's shard of every leaf — and `unpack` turns
    a (W, K) buffer back into the leaves."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], world: int):
        self.world = int(world)
        self.shapes = [tuple(s) for s in shapes]
        self.numels = [int(torch.Size(s).numel()) for s in self.shapes]
        self.chunks = [shard_chunk(n, self.world) for n in self.numels]
        self.offsets = [sum(self.chunks[:i]) for i in range(len(self.chunks))]
        self.size = sum(self.chunks)

    def pack(self, leaves: Sequence[torch.Tensor], lead: int = 0) -> torch.Tensor:
        """Leaves shaped (*L, *shapes[i]), with `lead` leading dims L, ->
        (*L, W, K)."""
        W, cols = self.world, []
        for leaf, n, k in zip(leaves, self.numels, self.chunks):
            lead_shape = tuple(leaf.shape[:lead])
            flat = leaf.reshape(lead_shape + (n,))
            if W * k != n:
                flat = F.pad(flat, (0, W * k - n))
            cols.append(flat.reshape(lead_shape + (W, k)))
        return torch.cat(cols, dim=-1)

    def columns(self, rows: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's columns of a (..., K) buffer."""
        return rows[..., self.offsets[i]:self.offsets[i] + self.chunks[i]]

    def unpack(self, full: torch.Tensor) -> List[torch.Tensor]:
        """A (W, K) buffer -> the leaves, in their shapes."""
        return [self.columns(full, i).reshape(-1)[:n].reshape(s)
                for i, (n, s) in enumerate(zip(self.numels, self.shapes))]


def local_rows(group) -> slice:
    """The rows of the (W, ...) shard grid this process holds, as a slice:
    all of them in driver mode, its own rank's in multiproc mode."""
    ranks = dist._local_rows(group)
    return slice(ranks[0], ranks[-1] + 1)


def reduce_scatter_mean(packed: torch.Tensor, group) -> torch.Tensor:
    """Gradients straight to their owners: ``packed`` is this process's
    ranks' (n, W, K) buffers; one AVG reduce-scatter returns their (n, K)
    owned shards, averaged over the group."""
    return dist.reduce_scatter(DistTensor.wrap(packed, group), ReduceOp.AVG, group).tensor


def unshard(shards: torch.Tensor, group) -> torch.Tensor:
    """All-gather this process's ranks' (n, K) shards back into the whole
    (W, K) buffer — the weight update's single collective. Every rank's
    gathered row is the same; the first local one is returned."""
    return dist.all_gather(DistTensor.wrap(shards, group), group).tensor[0]
