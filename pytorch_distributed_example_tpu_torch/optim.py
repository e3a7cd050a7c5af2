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
per parameter.

`adam` and `adamw` are optax's (`scale_by_adam`, then for adamw
`add_decayed_weights`, then the -learning_rate scale): mu <- (1 - b1) g +
b1 mu, nu <- (1 - b2) g^2 + b2 nu, count <- count + 1 (an int32 scalar),
u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count) + eps_root) + eps),
then u + weight_decay * p for adamw (weight_decay 1e-4 by default, as
optax's), then u * -learning_rate. Every op is elementwise, so the ZeRO
sharded update is the replicated one bit for bit; the scalar `count` stays
out of the shard layout (`parallel/ddp.py`).

`ZeroRedundancyOptimizer` is the reference's torch-shaped ZeRO-1 wrapper
(`optim.py:31-84`). The DDP step unwraps it and shards the state itself,
as the reference's does (`parallel/ddp.py:434-441`). `PostLocalSGDOptimizer`
(`optim.py:86-140`) runs local steps and periodic parameter averaging over
`parallel/localsgd.py`'s replica-stacked params.
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


@dataclass(frozen=True)
class Adam:
    """optax's adam, and adamw when `weight_decay` is not None. The state is
    {"count": int32 scalar, "mu": {name: tensor}, "nu": {name: tensor}}."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: Optional[float] = None

    def init(self, params: Tree) -> dict:
        device = next(iter(params.values())).device if params else None
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads: Tree, state: dict, params: Optional[Tree] = None
               ) -> Tuple[Tree, dict]:
        b1, b2 = self.b1, self.b2
        mu = {n: (1 - b1) * g + b1 * state["mu"][n] for n, g in grads.items()}
        nu = {n: (1 - b2) * (g * g) + b2 * state["nu"][n] for n, g in grads.items()}
        count = state["count"] + 1
        c = count.float()
        # 1 - b^count in float32, as optax's `bias_correction`
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
        updates = {}
        for n in grads:
            m_hat = mu[n] / bc1.to(mu[n].dtype)
            v_hat = nu[n] / bc2.to(nu[n].dtype)
            u = m_hat / (torch.sqrt(v_hat + self.eps_root) + self.eps)
            if self.weight_decay is not None:
                if params is None:
                    raise ValueError("adamw's weight decay needs the params")
                u = u + self.weight_decay * params[n]
            updates[n] = -self.learning_rate * u
        return updates, {"count": count.to(torch.int32), "mu": mu, "nu": nu}


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Adam:
    return Adam(learning_rate, b1, b2, eps, eps_root)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> Adam:
    return Adam(learning_rate, b1, b2, eps, eps_root, weight_decay)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {n: p + updates[n] for n, p in params.items()}


class ZeroRedundancyOptimizer:
    """torch's ZeRO-1 wrapper (`zero_redundancy_optimizer.py`), the
    reference's `optim.py:31-84`, in the port's driver mode: the state of
    `optimizer` lives as this process's ranks' 1/W shards of every
    parameter-shaped leaf, rows (n, ceil(size/W)) of the padded flat leaf
    (`parallel/zero.py`); scalar leaves (adam's `count`) stay whole.

        zopt = ZeroRedundancyOptimizer(optim.adamw(1e-3), group)
        state = zopt.init(params)                  # sharded
        full = zopt.consolidate_state_dict(state)  # leaves in param shapes

    `make_ddp_train_step` unwraps it to `zopt.optimizer` and shards the
    update itself (ZeRO "auto"), so a state from `zopt.init` is already in
    that step's layout. `update` runs the wrapped optimizer on whatever
    layout its inputs share."""

    def __init__(self, optimizer, group=None):
        from . import distributed as dist

        self.optimizer = optimizer
        self.group = dist._resolve(group)

    def init(self, params: Tree):
        from .parallel import zero

        return self.optimizer.init(zero.shard_rows(params, self.group))

    def update(self, grads, state, params=None):
        return self.optimizer.update(grads, state, params)

    def consolidate_state_dict(self, state, params: Tree):
        """The full state on the host, leaves back in `params`' shapes (an
        all-gather a leaf: a collective in multiproc mode)."""
        from torch.utils import _pytree as pytree

        from .parallel import zero

        template = self.optimizer.init({n: p.to("meta") for n, p in params.items()})
        leaves, spec = pytree.tree_flatten(state)
        refs = pytree.tree_leaves(template)
        return pytree.tree_unflatten(
            [zero.from_shard_layout(zero.unshard(l, self.group), r).cpu() if r.dim()
             else l.cpu() for l, r in zip(leaves, refs)], spec)


class PostLocalSGDOptimizer:
    """torch `PostLocalSGDOptimizer`: wraps an optimizer so that `step()`
    runs the local (collective-free) update and periodically averages the
    params, over `parallel/localsgd.py`::

        opt = PostLocalSGDOptimizer(optim.sgd(0.1), apply_fn, loss_fn,
                                    period=4, warmup_steps=2)
        params, opt_state = opt.init(params)      # replica-stacked
        params, opt_state, losses = opt.step(params, opt_state, x, y)
    """

    def __init__(self, optimizer, apply_fn, loss_fn, group=None, period: int = 4,
                 warmup_steps: int = 0, has_rng: bool = False, rng_fn=None, averager=None):
        from .parallel.localsgd import PeriodicModelAverager, make_localsgd_train_step

        self.optimizer = optimizer
        self._step = make_localsgd_train_step(apply_fn, loss_fn, optimizer, group=group,
                                              has_rng=has_rng, rng_fn=rng_fn)
        # torch's PostLocalSGDOptimizer takes the averager instance: pass a
        # HierarchicalModelAverager here for tiered averaging
        self.averager = averager or PeriodicModelAverager(
            group=group, period=period, warmup_steps=warmup_steps)

    def init(self, params: Tree):
        """A replica of the params for each of this process's ranks, and
        each replica's optimizer state."""
        from . import distributed as dist
        from .parallel.localsgd import init_stacked_opt_state, stack_replicas

        stacked = stack_replicas(params, len(dist._local_rows(self._step.group)))
        return stacked, init_stacked_opt_state(self.optimizer, stacked)

    def step(self, params, opt_state, x, y, *seed):
        """One local step; averages the params when the period is due."""
        params, opt_state, loss = self._step(params, opt_state, x, y, *seed)
        params, _ = self.averager.average_parameters(params)
        return params, opt_state, loss
