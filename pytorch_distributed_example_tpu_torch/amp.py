"""Mixed precision: `torch.amp` parity in the reference's functional shape,
the port of its `amp.py`.

* **Policy**: precision as a policy applied to trees (the jmp convention,
  and what `TransformerConfig(dtype=...)` does model-side): params kept in
  `param_dtype`, cast to `compute_dtype` for the forward, outputs to
  `output_dtype`. Only floating tensors are cast.
* **GradScaler**: functional dynamic loss scaling. The state is a small
  tree (scale, growth counter) of device tensors threaded through the
  step; `scale` multiplies the loss, `unscale` divides the grads and
  reports finiteness, `update` applies torch's growth/backoff schedule
  (`torch/amp/grad_scaler.py`: growth 2.0, backoff 0.5, interval 2000)
  with `torch.where` instead of host branches, and `where_finite` skips
  the optimizer step (params AND state) on overflow, as
  `GradScaler.step` does.

The reference's `unscale(..., axis_name=)` agrees on finiteness across the
ranks of a `shard_map`. The port's forms: with `axis_name`, the grads are
rank-stacked (the step's rank dim first, driver mode) and the verdict is
the min over that dim; with `group=`, each process's rows take one MIN
all-reduce over the group through the c10d core (multiproc mode, or
driver mode's rows). Either way one rank's inf makes every rank skip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree


@dataclass(frozen=True)
class Policy:
    """Dtype policy (jmp-shaped): where params live, where math runs."""

    param_dtype: Any = None  # None = leave as is
    compute_dtype: Any = None
    output_dtype: Any = None

    def cast_to_param(self, tree):
        return _cast_floating(tree, self.param_dtype)

    def cast_to_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)

    def cast_to_output(self, tree):
        return _cast_floating(tree, self.output_dtype)


def _cast_floating(tree, dtype):
    if dtype is None:
        return tree

    def one(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return pytree.tree_map(one, tree)


def get_policy(name: str) -> Policy:
    """'bf16' / 'f32' / 'fp16' shorthand (jmp's `get_policy` shape)."""
    table = {
        "bf16": Policy(torch.float32, torch.bfloat16, torch.float32),
        "fp16": Policy(torch.float32, torch.float16, torch.float32),
        "f32": Policy(torch.float32, torch.float32, torch.float32),
    }
    if name not in table:
        raise ValueError(f"unknown policy {name!r}; one of {sorted(table)}")
    return table[name]


class ScalerState(NamedTuple):
    scale: Any  # float32 0-d tensor
    growth_tracker: Any  # int32 0-d tensor: consecutive finite steps


def _all_finite(leaves, rank_dim: bool) -> torch.Tensor:
    """All-finite verdict of the leaves: one bool, or (n,) per rank row."""
    out = None
    for leaf in leaves:
        ok = torch.isfinite(leaf)
        ok = ok.reshape(ok.shape[0], -1).all(1) if rank_dim else ok.all()
        out = ok if out is None else out & ok
    return out


class GradScaler:
    """Functional dynamic loss scaler (torch `torch/amp/grad_scaler.py`).

    Usage (gate BOTH params and optimizer state on `finite`: torch's
    `GradScaler.step` skips `optimizer.step()` entirely on overflow, so the
    poisoned grads must not reach a stateful optimizer such as Adam)::

        state = scaler.init(device)
        scaled_loss = scaler.scale(loss, state)
        grads = ...                                   # of the SCALED loss
        grads, finite = scaler.unscale(grads, state)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = optim.apply_updates(params, updates)
        params = scaler.where_finite(finite, new_params, params)
        opt_state = scaler.where_finite(finite, new_opt, opt_state)
        state = scaler.update(state, finite)
    """

    def __init__(
        self,
        init_scale: float = 2.0**16,
        growth_factor: float = 2.0,
        backoff_factor: float = 0.5,
        growth_interval: int = 2000,
    ):
        if growth_factor <= 1.0 or not (0.0 < backoff_factor < 1.0):
            raise ValueError("growth_factor > 1 and 0 < backoff_factor < 1")
        self.init_scale = init_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval

    def init(self, device=None) -> ScalerState:
        return ScalerState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32, device=device),
            growth_tracker=torch.tensor(0, dtype=torch.int32, device=device),
        )

    def scale(self, loss, state: ScalerState):
        # promote, never cast the scale into the loss dtype: the torch
        # default 2**16 rounds to inf in fp16 and every step would overflow
        dtype = torch.promote_types(loss.dtype, state.scale.dtype)
        return loss.to(dtype) * state.scale

    def unscale(self, grads, state: ScalerState, axis_name: Optional[str] = None,
                group=None) -> Tuple[Any, Any]:
        """Divide grads by the scale; returns (grads in float32, all_finite,
        a 0-d bool tensor).

        With per-rank grads pass `axis_name` (leaves rank-stacked, rank dim
        first: the min over it) or `group` (each leaf this process's
        ranks' rows: a MIN all-reduce over the group). Finiteness is then
        agreed ACROSS ranks (torch's ShardedGradScaler all-reduces
        found_inf for the same reason); otherwise one rank can skip the
        step while another applies it, and replicated state diverges."""
        inv = 1.0 / state.scale
        grads = pytree.tree_map(lambda g: g.to(torch.float32) * inv, grads)
        leaves = pytree.tree_leaves(grads)
        if not leaves:
            return grads, torch.ones((), dtype=torch.bool, device=state.scale.device)
        per_rank = axis_name is not None or group is not None
        finite = _all_finite(leaves, per_rank)
        if group is not None:
            from . import distributed as dist
            from .tensor import DistTensor
            from .types import ReduceOp

            verdict = DistTensor.wrap(finite.to(torch.int32), group)
            dist.all_reduce(verdict, ReduceOp.MIN, group)
            finite = verdict.tensor[0] == 1
        elif axis_name is not None:
            finite = finite.to(torch.int32).min() == 1
        return grads, finite

    def update(self, state: ScalerState, finite) -> ScalerState:
        """torch's schedule: overflow -> scale *= backoff, tracker reset;
        `growth_interval` consecutive finite steps -> scale *= growth."""
        finite = torch.as_tensor(finite, device=state.scale.device)
        tracker = torch.where(finite, state.growth_tracker + 1, torch.zeros_like(
            state.growth_tracker))
        grow = tracker >= self.growth_interval
        scale = torch.where(
            finite,
            torch.where(grow, state.scale * self.growth_factor, state.scale),
            state.scale * self.backoff_factor,
        )
        tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
        return ScalerState(scale=scale, growth_tracker=tracker.to(torch.int32))

    def where_finite(self, finite, new_tree, old_tree):
        """`new_tree` where the grads were finite, else `old_tree`: gate BOTH
        params and optimizer state through this (`GradScaler.step`'s
        skip-on-overflow covers the optimizer's state too)."""
        leaves, spec = pytree.tree_flatten(new_tree)
        olds = pytree.tree_leaves(old_tree)
        out = []
        for n, o in zip(leaves, olds):
            if isinstance(n, torch.Tensor):
                out.append(torch.where(torch.as_tensor(finite, device=n.device), n, o))
            else:
                out.append(n if bool(finite) else o)
        return pytree.tree_unflatten(out, spec)
