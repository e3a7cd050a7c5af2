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

`chain`, `clip_by_global_norm`, `lamb` and `adafactor` are optax's (0.2.6,
at its defaults), made of the same transforms in the same order: `lamb`
is `scale_by_adam`, `add_decayed_weights`, `scale_by_trust_ratio`, then
the -learning_rate scale; `adafactor` is `scale_by_factored_rms`,
`clip_by_block_rms`, the learning-rate scale, `scale_by_param_block_rms`,
then `scale(-1)`. A chain's state is the tuple of its parts' states (an
empty part's is `()`). These couple elements across a leaf or the tree
(a factored moment, a block rms, a trust ratio, a global norm), so the
ZeRO sharded update is not exact for them: every optimizer records the
optax factory names it is made of in `transform_names`, which
`parallel/ddp.py`'s `classify_update_coupling` reads.

`ZeroRedundancyOptimizer` is the reference's torch-shaped ZeRO-1 wrapper
(`optim.py:31-84`). The DDP step unwraps it and shards the state itself,
as the reference's does (`parallel/ddp.py:434-441`). `PostLocalSGDOptimizer`
(`optim.py:86-140`) runs local steps and periodic parameter averaging over
`parallel/localsgd.py`'s replica-stacked params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class SGD:
    learning_rate: float
    momentum: Optional[float] = None

    @property
    def transform_names(self) -> Tuple[str, ...]:
        return (("trace",) if self.momentum else ()) + ("scale_by_learning_rate",)

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


def _scale_by_adam(b1: float, b2: float, eps: float, eps_root: float, grads: Tree,
                   state: dict) -> Tuple[Tree, dict]:
    """optax's `scale_by_adam`: the bias-corrected moment ratio and the new
    {"count", "mu", "nu"} state."""
    mu = {n: (1 - b1) * g + b1 * state["mu"][n] for n, g in grads.items()}
    nu = {n: (1 - b2) * (g * g) + b2 * state["nu"][n] for n, g in grads.items()}
    count = state["count"] + 1
    c = count.float()
    # 1 - b^count in float32, as optax's `bias_correction`
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
    u = {}
    for n in grads:
        m_hat = mu[n] / bc1.to(mu[n].dtype)
        v_hat = nu[n] / bc2.to(nu[n].dtype)
        u[n] = m_hat / (torch.sqrt(v_hat + eps_root) + eps)
    return u, {"count": count.to(torch.int32), "mu": mu, "nu": nu}


def _adam_state(params: Tree) -> dict:
    device = next(iter(params.values())).device if params else None
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()}}


def _need_params(params, name: str) -> Tree:
    if params is None:
        raise ValueError(f"{name} needs the params: pass them to update()")
    return params


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

    @property
    def transform_names(self) -> Tuple[str, ...]:
        wd = ("add_decayed_weights",) if self.weight_decay is not None else ()
        return ("scale_by_adam",) + wd + ("scale_by_learning_rate",)

    def init(self, params: Tree) -> dict:
        return _adam_state(params)

    def update(self, grads: Tree, state: dict, params: Optional[Tree] = None
               ) -> Tuple[Tree, dict]:
        u, state = _scale_by_adam(self.b1, self.b2, self.eps, self.eps_root, grads, state)
        if self.weight_decay is not None:
            params = _need_params(params, "adamw's weight decay")
            u = {n: v + self.weight_decay * params[n] for n, v in u.items()}
        return {n: -self.learning_rate * v for n, v in u.items()}, state


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Adam:
    return Adam(learning_rate, b1, b2, eps, eps_root)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> Adam:
    return Adam(learning_rate, b1, b2, eps, eps_root, weight_decay)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {n: p + updates[n] for n, p in params.items()}


class Chain:
    """optax's `chain`: the transforms applied in order, each to the
    previous one's updates; the state is the tuple of their states."""

    def __init__(self, *transforms):
        self.transforms = tuple(transforms)
        self.transform_names = tuple(
            n for t in self.transforms for n in getattr(t, "transform_names", ()))

    def init(self, params: Tree) -> tuple:
        return tuple(t.init(params) for t in self.transforms)

    def update(self, grads: Tree, state: tuple, params: Optional[Tree] = None
               ) -> Tuple[Tree, tuple]:
        new = []
        for t, s in zip(self.transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)


def chain(*transforms) -> Chain:
    return Chain(*transforms)


@dataclass(frozen=True)
class _Stateless:
    """A transform without state: `fn(updates, params) -> updates`, named
    after the optax factory it ports."""

    name: str
    fn: Callable

    @property
    def transform_names(self) -> Tuple[str, ...]:
        return (self.name,)

    def init(self, params: Tree) -> tuple:
        return ()

    def update(self, grads: Tree, state: tuple, params: Optional[Tree] = None
               ) -> Tuple[Tree, tuple]:
        return self.fn(grads, params), state


def _scale(step_size: float, name: str = "scale") -> _Stateless:
    return _Stateless(name, lambda u, p: {n: step_size * g for n, g in u.items()})


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(t * t))


def clip_by_global_norm(max_norm: float) -> _Stateless:
    """optax's `clip_by_global_norm`: every update times max_norm / norm
    when the norm over the whole tree reaches max_norm."""

    def fn(updates, params):
        if not updates:
            return updates
        g_norm = torch.sqrt(sum(torch.sum(u * u) for u in updates.values()))
        keep = g_norm < max_norm
        return {n: torch.where(keep, u, (u / g_norm.to(u.dtype)) * max_norm)
                for n, u in updates.items()}

    return _Stateless("clip_by_global_norm", fn)


def _clip_by_block_rms(threshold: float) -> _Stateless:
    def fn(updates, params):
        return {n: u / torch.clamp(_rms(u) / threshold, min=1.0) for n, u in updates.items()}

    return _Stateless("clip_by_block_rms", fn)


def _add_decayed_weights(weight_decay: float) -> _Stateless:
    def fn(updates, params):
        params = _need_params(params, "add_decayed_weights")
        return {n: u + weight_decay * params[n] for n, u in updates.items()}

    return _Stateless("add_decayed_weights", fn)


def _scale_by_trust_ratio() -> _Stateless:
    """optax's `scale_by_trust_ratio` at its defaults (min_norm 0,
    trust_coefficient 1, eps 0): u * ||p|| / ||u||, or u where either
    norm is 0."""

    def fn(updates, params):
        params = _need_params(params, "scale_by_trust_ratio")
        out = {}
        for n, u in updates.items():
            p_norm = torch.sqrt(torch.sum(params[n] * params[n]))
            u_norm = torch.sqrt(torch.sum(u * u))
            ratio = torch.where((p_norm == 0.0) | (u_norm == 0.0),
                                torch.ones((), dtype=params[n].dtype, device=u.device),
                                p_norm / u_norm)
            out[n] = u * ratio
        return out

    return _Stateless("scale_by_trust_ratio", fn)


def _scale_by_param_block_rms() -> _Stateless:
    def fn(updates, params):
        params = _need_params(params, "scale_by_param_block_rms")
        return {n: u * torch.clamp(_rms(params[n]), min=1e-3) for n, u in updates.items()}

    return _Stateless("scale_by_param_block_rms", fn)


@dataclass(frozen=True)
class _ScaleByAdam:
    b1: float
    b2: float
    eps: float
    eps_root: float
    transform_names = ("scale_by_adam",)

    def init(self, params: Tree) -> dict:
        return _adam_state(params)

    def update(self, grads: Tree, state: dict, params: Optional[Tree] = None
               ) -> Tuple[Tree, dict]:
        return _scale_by_adam(self.b1, self.b2, self.eps, self.eps_root, grads, state)


def lamb(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         eps_root: float = 0.0, weight_decay: float = 0.0) -> Chain:
    return Chain(_ScaleByAdam(b1, b2, eps, eps_root), _add_decayed_weights(weight_decay),
                 _scale_by_trust_ratio(), _scale(-learning_rate, "scale_by_learning_rate"))


def _factored_dims(shape, min_dim_size_to_factor: int) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims`: the two largest dims (the second largest,
    then the largest), or None below two dims or the size to factor."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class _ScaleByFactoredRms:
    """optax's `scale_by_factored_rms` at adafactor's defaults (factored,
    decay 0.8, no step offset, epsilon 1e-30). A leaf with two dims of at
    least 128 keeps a row and a column moment (its shape without the
    largest dim, and without the second largest); any other leaf keeps a
    full one. The state is {"count": int32 scalar, "v_row", "v_col", "v":
    {name: tensor}}, unused moments shaped (1,)."""

    DECAY_RATE = 0.8
    MIN_DIM_SIZE_TO_FACTOR = 128
    EPSILON = 1e-30
    transform_names = ("scale_by_factored_rms",)

    def init(self, params: Tree) -> dict:
        state = {"v_row": {}, "v_col": {}, "v": {}}
        for n, p in params.items():
            dims = _factored_dims(tuple(p.shape), self.MIN_DIM_SIZE_TO_FACTOR)
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                state["v_row"][n], state["v_col"][n], state["v"][n] = one, one.clone(), torch.zeros_like(p)
                continue
            d1, d0 = dims
            state["v_row"][n] = torch.zeros([s for i, s in enumerate(p.shape) if i != d0],
                                            dtype=p.dtype, device=p.device)
            state["v_col"][n] = torch.zeros([s for i, s in enumerate(p.shape) if i != d1],
                                            dtype=p.dtype, device=p.device)
            state["v"][n] = one
        device = next(iter(params.values())).device if params else None
        return {"count": torch.zeros((), dtype=torch.int32, device=device), **state}

    def update(self, grads: Tree, state: dict, params: Optional[Tree] = None
               ) -> Tuple[Tree, dict]:
        params = _need_params(params, "scale_by_factored_rms")
        count = state["count"]
        decay = 1.0 - (count + 1).to(torch.float32) ** (-self.DECAY_RATE)
        updates, new = {}, {"v_row": {}, "v_col": {}, "v": {}}
        for n, g in grads.items():
            p = params[n]
            dims = _factored_dims(tuple(p.shape), self.MIN_DIM_SIZE_TO_FACTOR)
            g_sqr = g * g + self.EPSILON
            one = torch.zeros((1,), dtype=p.dtype, device=g.device)
            if dims is None:
                v = (decay * state["v"][n] + (1.0 - decay) * g_sqr).to(p.dtype)
                updates[n] = g * v ** -0.5
                new["v_row"][n], new["v_col"][n], new["v"][n] = one, one.clone(), v
                continue
            d1, d0 = dims
            v_row = (decay * state["v_row"][n] + (1.0 - decay) * g_sqr.mean(d0)).to(p.dtype)
            v_col = (decay * state["v_col"][n] + (1.0 - decay) * g_sqr.mean(d1)).to(p.dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
            col_factor = v_col ** -0.5
            updates[n] = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            new["v_row"][n], new["v_col"][n], new["v"][n] = v_row, v_col, one
        limit = torch.iinfo(torch.int32).max
        count = torch.where(count < limit, count + 1, count).to(torch.int32)
        return updates, {"count": count, **new}


def adafactor(learning_rate: float) -> Chain:
    """optax's `adafactor(learning_rate)` at its defaults."""
    return Chain(_ScaleByFactoredRms(), _clip_by_block_rms(1.0),
                 _scale(learning_rate, "scale_by_learning_rate"),
                 _scale_by_param_block_rms(), _scale(-1))


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
