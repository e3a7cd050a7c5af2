"""Gradient utilities, `torch.nn.utils` parity: the port of the reference's
`nn/utils.py`.

`clip_grad_norm_` / `clip_grad_value_` over grad TREES, returning new
trees as the reference does. For grads sharded across ranks the norm must
be global: pass `axis_name` (leaves rank-stacked, rank dim first: the
per-rank sums are added over that dim, the reference's psum) or `group`
(each leaf this process's ranks' rows: one SUM, or MAX for inf, all-reduce
over the group through the c10d core).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.utils import _pytree as pytree


def _global(total: torch.Tensor, group, op) -> torch.Tensor:
    """Per-row values (n,) -> their reduction over the group's ranks."""
    from .. import distributed as dist
    from ..tensor import DistTensor

    t = DistTensor.wrap(total, group)
    dist.all_reduce(t, op, group)
    return t.tensor[0]


def clip_grad_norm_(
    grads,
    max_norm: float,
    norm_type: float = 2.0,
    axis_name: Optional[str] = None,
    group=None,
) -> Tuple[Any, Any]:
    """Scale `grads` so the total norm is at most `max_norm`.

    Returns (clipped_grads, total_norm), the norm before clipping (torch
    returns it too). `norm_type` is any p >= 1, or inf."""
    from ..types import ReduceOp

    leaves = pytree.tree_leaves(grads)
    if not leaves:
        return grads, torch.tensor(0.0)
    per_rank = axis_name is not None or group is not None

    def reduce(x, fn):
        return fn(x.reshape(x.shape[0], -1), 1) if per_rank else fn(x)

    if norm_type == float("inf"):
        per = [reduce(l.abs(), lambda a, *d: a.amax(*d)).to(torch.float32) for l in leaves]
        total = torch.stack(per).amax(0)
        if group is not None:
            total = _global(total, group, ReduceOp.MAX)
        elif axis_name is not None:
            total = total.amax()
    else:
        acc = sum(reduce(l.abs().to(torch.float32) ** norm_type, lambda a, *d: a.sum(*d))
                  for l in leaves)
        if group is not None:
            acc = _global(acc, group, ReduceOp.SUM)
        elif axis_name is not None:
            acc = acc.sum()
        total = acc ** (1.0 / norm_type)

    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    clipped = pytree.tree_map(lambda l: (l * scale).to(l.dtype), grads)
    return clipped, total


def clip_grad_value_(grads, clip_value: float):
    """Clamp every gradient element into [-clip_value, clip_value]."""
    v = abs(clip_value)
    return pytree.tree_map(lambda l: torch.clamp(l, -v, v), grads)
