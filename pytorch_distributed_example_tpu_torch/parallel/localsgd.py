"""Post-local SGD: local steps with periodic model averaging, the port of the
reference's `parallel/localsgd.py` (torch `ddp_comm_hooks/
post_localSGD_hook.py` and `model_averaging/averagers.py`).

Torch's hook stops reducing gradients after `start_localSGD_iter`, and a
PeriodicModelAverager all-reduces the *parameters* every `period` steps.
The replicas must be free to drift apart, so local SGD holds
REPLICA-STACKED params, as the reference does: every leaf (n, *shape),
one row a rank this process holds (all W in driver mode, its own in
multiproc mode), and two programs:

* `local_step`: each replica's forward, backward and update, a `vmap`
  over the replica dim, with NO collective;
* `average`: the mean of the stacked params over the ranks, one AVG
  all-reduce through the c10d core.

The caller averages every `period` steps (`PeriodicModelAverager`), so
grads stay local, models drift, and parameter averaging reconciles them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch.func import grad_and_value, vmap
from torch.utils import _pytree as pytree

from .. import distributed as dist
from ..tensor import DistTensor
from ..types import ReduceOp, fold


def stack_replicas(tree, world: int):
    """Tile a param tree to (world, *shape) leaves: one replica a rank."""
    return pytree.tree_map(
        lambda leaf: leaf.unsqueeze(0).expand((world,) + tuple(leaf.shape)).clone(), tree)


def unstack_replicas(tree, rank: int = 0):
    """One replica out of a stacked tree (after averaging they agree)."""
    return pytree.tree_map(lambda leaf: leaf[rank], tree)


def _average(stacked, group):
    """Every leaf's mean over the group's ranks, leaves of one dtype in one
    AVG all-reduce (elementwise: each leaf's own mean)."""
    leaves, spec = pytree.tree_flatten(stacked)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for idxs in by_dtype.values():
        n = leaves[idxs[0]].shape[0]
        flat = DistTensor.wrap(torch.cat([leaves[i].reshape(n, -1) for i in idxs], 1), group)
        dist.all_reduce(flat, ReduceOp.AVG, group)
        off = 0
        for i in idxs:
            k = leaves[i][0].numel()
            out[i] = flat.tensor[:, off:off + k].reshape(leaves[i].shape)
            off += k
    return pytree.tree_unflatten(out, spec)


class PeriodicModelAverager:
    """torch `PeriodicModelAverager` (`model_averaging/averagers.py`):
    `average_parameters` every `period` steps after `warmup_steps`."""

    def __init__(self, group=None, period: int = 4, warmup_steps: int = 0):
        self.period = period
        self.warmup_steps = warmup_steps
        self.step = 0
        self.group = dist._resolve(group)

    def average_parameters(self, stacked_params):
        """Counts a step; averages when due. Returns (params, did_average)."""
        self.step += 1
        if self.step <= self.warmup_steps or self.step % self.period != 0:
            return stacked_params, False
        return _average(stacked_params, self.group), True


class HierarchicalModelAverager:
    """torch `HierarchicalModelAverager` (`model_averaging/
    hierarchical_model_averager.py`): a hierarchy of periods, small
    contiguous groups of ranks averaging often and wider groups rarely. At
    each due step the averager with the LARGEST period dividing the step
    wins (torch picks the same way), and the mean runs over contiguous
    rank groups of its size, the intra-node/inter-node shape.

    `period_group_size_dict`: {period: group_size}, both strictly
    increasing; the largest group size must equal the world size (torch
    asserts this too). Driver mode: a group's mean is the c10d AVG fold
    over its rows, as the reference's `pmean` with `axis_index_groups`
    runs inside one program over the group's mesh."""

    def __init__(self, period_group_size_dict, warmup_steps: int = 0, group=None):
        if not period_group_size_dict:
            raise ValueError("period_group_size_dict must be non-empty")
        items = sorted(period_group_size_dict.items())
        sizes = [s for _, s in items]
        if sizes != sorted(sizes) or len(set(sizes)) != len(sizes):
            raise ValueError(f"group sizes must strictly increase with period: {items}")
        g = dist._resolve(group)
        self.group = g
        world = g.size()
        if sizes[-1] != world:
            raise ValueError(f"largest group size {sizes[-1]} must equal world size {world}")
        for _, size in items:
            if world % size != 0:
                raise ValueError(f"group size {size} does not divide {world}")
        if len(dist._local_rows(g)) != world:
            raise NotImplementedError(
                "HierarchicalModelAverager runs in driver mode (every rank's replica in "
                "this process), as the reference's single program over the group's mesh")
        self.warmup_steps = warmup_steps
        self.step = 0
        self._periods = [p for p, _ in items][::-1]  # largest first: first divisor wins
        self._period_to_size = dict(items)

    def _group_mean(self, stacked, size: int):
        avg = fold(ReduceOp.AVG)

        def one(leaf):
            W = leaf.shape[0]
            groups = leaf.reshape((W // size, size) + tuple(leaf.shape[1:]))
            means = avg(groups.movedim(1, 0))  # (W/size, ...)
            return means.unsqueeze(1).expand(groups.shape).reshape(leaf.shape).clone()

        return pytree.tree_map(one, stacked)

    def average_parameters(self, stacked_params):
        """Counts a step; averages at the widest due tier. Returns (params,
        the group size averaged over, or 0)."""
        self.step += 1
        if self.step <= self.warmup_steps:
            return stacked_params, 0
        for period in self._periods:
            if self.step % period == 0:
                size = self._period_to_size[period]
                return self._group_mean(stacked_params, size), size
        return stacked_params, 0


def make_localsgd_train_step(
    apply_fn: Callable,
    loss_fn: Callable,
    optimizer,
    group=None,
    has_rng: bool = False,
    rng_fn: Optional[Callable] = None,
):
    """The collective-free per-replica train step.

    `step(stacked_params, stacked_opt_state, x, y[, seed]) ->
    (stacked_params, stacked_opt_state, losses)`: params and optimizer
    state leaves carry a leading replica dim (this process's ranks); x and
    y are this process's ranks' batches, rank-major; `losses` is each
    replica's loss, stacked. `optimizer` is optax-shaped (`optim.py`),
    vmapped over the replicas. With `has_rng`, `apply_fn(params, x, masks)`
    takes `masks = rng_fn(generator, batch)`, drawn for rank r from a
    stream seeded with `seed * 1_000_003 + r`, as the DDP step's. Combine
    with `PeriodicModelAverager` for the post-local-SGD schedule; build the
    state with `init_stacked_opt_state`."""
    from ..optim import apply_updates
    from .ddp import _SEED_MIX, _stack_trees

    if has_rng and rng_fn is None:
        raise ValueError("has_rng=True needs rng_fn(generator, batch) for the random inputs")
    g = dist._resolve(group)
    local_ranks = dist._local_rows(g)
    n_local = len(local_ranks)
    generators: Dict[int, torch.Generator] = {}

    def objective(params, x, y, masks):
        logits = apply_fn(params, x, masks) if has_rng else apply_fn(params, x)
        return loss_fn(logits, y)

    def local(params, opt_state, x, y, masks):
        grads, loss = grad_and_value(objective)(params, x, y, masks)
        updates, new_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), new_state, loss

    mapped = vmap(local, in_dims=(0, 0, 0, 0, 0 if has_rng else None))

    def masks_for(seed, batch):
        per = []
        for r in local_ranks:
            gen = generators.get(r)
            if gen is None:
                gen = generators[r] = torch.Generator(device=g.device)
            gen.manual_seed(int(seed) * _SEED_MIX + r)
            per.append(rng_fn(gen, batch))
        return _stack_trees(per)

    def run(params, opt_state, x, y, seed):
        def split(a):
            return a.reshape((n_local, -1) + tuple(a.shape[1:]))

        xs, ys = split(x), pytree.tree_map(split, y)
        masks = masks_for(seed, xs.shape[1]) if has_rng else None
        return mapped(params, opt_state, xs, ys, masks)

    if has_rng:
        def step(params, opt_state, x, y, seed):
            return run(params, opt_state, x, y, seed)
    else:
        def step(params, opt_state, x, y):
            return run(params, opt_state, x, y, None)

    step.group = g
    return step


def init_stacked_opt_state(optimizer, stacked_params):
    """Per-replica optimizer state for stacked params (`optimizer.init`
    vmapped over the replica dim)."""
    return vmap(optimizer.init)(stacked_params)
