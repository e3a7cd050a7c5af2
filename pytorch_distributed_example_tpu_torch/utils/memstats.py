"""Per-rank memory accounting for train state.

The port of the reference's `utils/memstats.py`: how many bytes ONE rank
holds for its params, gradients and optimizer state, honouring their
layouts. A `DTensor` costs a rank its local shard (a replicated dim its
whole extent), a plain tensor its full size. Host arithmetic only, no
device sync.

A torch optimizer as `opt_state` is read through its params: each state
tensor shaped like its param's local stack is laid out as that param (a
sharded moment costs a rank its shard), any other (AdamW's step count)
counts whole. `train_memory_report` is the bench-JSON shape.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch

from ..dtensor import DTensor

__all__ = ["leaf_device_bytes", "tree_bytes", "tree_device_bytes", "train_memory_report"]


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, (torch.Tensor, DTensor)):
        yield tree


def _itemsize(leaf) -> int:
    return torch.empty((), dtype=leaf.dtype).element_size()


def leaf_device_bytes(leaf) -> int:
    """Bytes one rank holds for this leaf."""
    shape = leaf.local_shape if isinstance(leaf, DTensor) else tuple(leaf.shape)
    return math.prod(shape) * _itemsize(leaf)


def tree_bytes(tree) -> int:
    """Global logical bytes of every tensor leaf (layout-agnostic)."""
    return sum(math.prod(leaf.shape) * _itemsize(leaf) for leaf in _leaves(tree))


def tree_device_bytes(tree) -> int:
    """Bytes one rank holds for the whole tree (its per-rank footprint)."""
    return sum(leaf_device_bytes(leaf) for leaf in _leaves(tree))


def optimizer_tree(optimizer: torch.optim.Optimizer, owners: Mapping[int, DTensor]):
    """A torch optimizer's state as a tree of DTensors and tensors: a state
    tensor shaped like its param takes the layout of the param's DTensor
    (`owners`: id of the optimizer's param -> the DTensor it holds)."""
    out = {}
    for i, (param, state) in enumerate(optimizer.state.items()):
        dt = owners.get(id(param))
        row = {}
        for k, v in state.items():
            if isinstance(v, torch.Tensor) and dt is not None and v.shape == param.shape:
                row[k] = DTensor(v.reshape(dt._local.shape), dt.device_mesh, dt.placements)
            elif isinstance(v, torch.Tensor):
                row[k] = v
        out[i] = row
    return out


def train_memory_report(params, opt_state, grads: Optional[Any] = None) -> Dict[str, Any]:
    """Global and per-rank bytes of params, optimizer state and (given)
    gradients. ``opt_state_reduction_x`` is global / per-rank for the
    optimizer state: about the world size when it is sharded, 1.0
    replicated. `opt_state` may be a tree or a torch optimizer (or an
    object holding one as `.optimizer`, with the layout of its own
    params as `.layout`: id -> DTensor)."""
    opt = getattr(opt_state, "optimizer", opt_state)
    if isinstance(opt, torch.optim.Optimizer):
        owners = {id(p._local): p for p in _leaves(params) if isinstance(p, DTensor)}
        owners.update(getattr(opt_state, "layout", {}))
        opt_state = optimizer_tree(opt, owners)
    out: Dict[str, Any] = {
        "param_bytes": tree_bytes(params),
        "param_bytes_per_device": tree_device_bytes(params),
        "opt_state_bytes": tree_bytes(opt_state),
        "opt_state_bytes_per_device": tree_device_bytes(opt_state),
    }
    if grads is not None:
        out["grad_bytes"] = tree_bytes(grads)
        out["grad_bytes_per_device"] = tree_device_bytes(grads)
    per_dev = out["opt_state_bytes_per_device"]
    out["opt_state_reduction_x"] = round(out["opt_state_bytes"] / per_dev, 3) if per_dev else 0.0
    return out
