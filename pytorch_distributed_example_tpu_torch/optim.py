"""Optimizers of the port, functional and in optax's shape.

The reference's trainers take optax transformations: `init(params) -> state`,
`update(grads, state, params) -> (updates, state)`, then
`apply_updates(params, updates)`. The port's DDP step takes the same shape,
so that one optimizer updates the whole params or, under ZeRO weight-update
sharding, each rank's 1/W shard of them (`parallel/ddp.py`). Params, grads
and states are dicts of tensors keyed by parameter name.

`sgd` is `optax.sgd(learning_rate, momentum)`: m <- g + momentum * m, then
p <- p + m * -learning_rate, in the params' dtype and in that order of
roundings; dampening 0, no Nesterov. Its state is the trace m, one tensor
per parameter. The reference's own `optim.py` (ZeroRedundancyOptimizer and
the rest) is still to port (ROADMAP, Queue 1 item 2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class SGD:
    learning_rate: float
    momentum: Optional[float] = None

    def init(self, params: Tree) -> Tree:
        if not self.momentum:
            return {}
        return {n: torch.zeros_like(p) for n, p in params.items()}

    def update(self, grads: Tree, state: Tree, params: Optional[Tree] = None
               ) -> Tuple[Tree, Tree]:
        if self.momentum:
            state = {n: g + state[n] * self.momentum for n, g in grads.items()}
            grads = state
        return {n: g * -self.learning_rate for n, g in grads.items()}, state


def sgd(learning_rate: float, momentum: Optional[float] = None) -> SGD:
    return SGD(learning_rate, momentum)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {n: p + updates[n] for n, p in params.items()}
