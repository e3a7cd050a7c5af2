"""DistributedDataParallel — replicated-model data parallelism.

The port of the reference's `parallel/ddp.py` (after torch's
`nn/parallel/distributed.py` and its C++ Reducer). The reference compiles
forward, backward, gradient reduction and update into one XLA program over
the group's mesh. The port runs the same step eagerly, with every
collective going through its c10d core (`distributed.py`), in both modes:

* **driver mode** — one process acts for all W ranks. The params stay
  replicated as one copy on the device. The global batch is split
  rank-major into (W, B, ...), and the per-rank gradients come from
  `torch.func`: `vmap` over `grad` of a `functional_call`, which gives
  every gradient stacked (W, *shape). Dropout masks are drawn outside
  `vmap`, one generator stream per (rank, step), and go in as inputs.
* **multiproc mode** — one process a rank, each holding its own replica
  and its (1, B, ...) share of the batch; the same code runs with one row,
  and the collectives go through torch.distributed (gloo on the CPU, nccl
  on the card).

Each rank's gradients are packed into one flat buffer in ZeRO's shard
layout (`zero.ShardLayout`). A step then makes three collectives under
ZeRO weight-update sharding (the default at world > 1): the loss's AVG
all-reduce, the gradients' AVG reduce-scatter, and the all-gather of the
updated shards; and two with the update replicated ("off"): the loss's and
the gradients' AVG all-reduce. The reduce-scatter and the all-reduce fold
the same (W, W*K) buffer over the rank dim, so ZeRO "auto" and "off" give
the same params bit for bit (the reference's bitwise contract).

Construction keeps the reference's checks: per-param shape verification
across ranks that names the offending param
(`_verify_param_shape_across_processes`, torch `distributed.py:1064`), the
rank-0 broadcast of every param in coalesced buckets (`_sync_module_states`,
`:1066`), `no_sync()` over the eager Reducer (`:1659`).

The step's options are the reference's `local_step` (`parallel/ddp.py:478-
575`): gradient accumulation, `remat`, `with_aux`, unused-parameter
detection (`find_unused_parameters`, `on_unused`) and every hook of
`comm_hooks.py`, stateful ones with their state carried per rank. The
planner's hook is still to port (ROADMAP).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.func import functional_call, grad_and_value, vmap
from torch.utils import _pytree as pytree

from .. import distributed as dist
from ..mesh import DeviceMesh
from ..nn.functional import RANKS
from ..numerics import numerics_contract
from ..optim import apply_updates
from ..tensor import DistTensor
from ..types import ReduceOp
from ..utils import remat as remat_lib
from . import comm_hooks, zero

_SEED_MIX = 1_000_003  # the step's seed times this, plus the rank: one stream each


def _named_leaves(params) -> Tuple[List[str], List[torch.Tensor]]:
    """(names, tensors) of a dict of params or of a module's parameters."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return list(params), list(params.values())


def _verify_params_across_ranks(names, leaves, group) -> None:
    """Per-param shape/dtype verification that NAMES the offending param.

    Parity: torch `_verify_param_shape_across_processes`
    (`torch/distributed/utils.py:281` → `reducer.hpp:616`). (1) MIN == MAX
    all-reduces of the param count; (2) the same of a per-param 48-bit hash
    of (name, shape, dtype): a mismatch at position i names `names[i]`."""
    cnt = torch.tensor([len(leaves)], dtype=torch.int64)
    lo = DistTensor.from_process_local(cnt, group)
    hi = DistTensor.from_process_local(cnt, group)
    dist.all_reduce(lo, ReduceOp.MIN, group)
    dist.all_reduce(hi, ReduceOp.MAX, group)
    nlo, nhi = int(lo.tensor[0, 0]), int(hi.tensor[0, 0])
    if nlo != nhi:
        raise RuntimeError(
            f"DDP: parameter count differs across ranks (min {nlo}, max {nhi}); "
            f"this rank has {len(leaves)}"
        )
    hashes = torch.tensor(
        [int.from_bytes(hashlib.sha256(
            f"{n}|{tuple(l.shape)}|{l.dtype}".encode()).digest()[:6], "big")
         for n, l in zip(names, leaves)],
        dtype=torch.int64,
    )
    lo = DistTensor.from_process_local(hashes, group)
    hi = DistTensor.from_process_local(hashes, group)
    dist.all_reduce(lo, ReduceOp.MIN, group)
    dist.all_reduce(hi, ReduceOp.MAX, group)
    mism = torch.nonzero(lo.tensor[0] != hi.tensor[0]).flatten().tolist()
    if mism:
        i = mism[0]
        raise RuntimeError(
            f"DDP: parameter {names[i]} (index {i}) differs across ranks in "
            f"shape/dtype/order; this rank has shape {tuple(leaves[i].shape)} "
            f"dtype {leaves[i].dtype}. {len(mism)} mismatching parameter(s) total."
        )


def _sync_module_states(params: Dict[str, torch.Tensor], group,
                        bucket_mb: float = 250.0) -> Dict[str, torch.Tensor]:
    """Rank-0 broadcast of every param, coalesced, on the device.

    Parity: torch `_sync_module_states` → `_broadcast_coalesced` with 250
    MiB buckets (`torch/distributed/utils.py:289`). Leaves are bucketed per
    dtype under the size cap; each bucket is flattened into one tensor,
    broadcast from rank 0 through the c10d core, and split back. In driver
    mode the ranks share one copy, so this preserves the values; in
    multiproc mode it makes divergently initialized replicas identical.
    Returns fresh tensors."""
    names, leaves = _named_leaves(params)
    cap = bucket_mb * (1 << 20)
    new: list = [None] * len(leaves)

    def flush(bucket):
        flat = torch.cat([leaves[j].reshape(-1) for j in bucket])
        t = DistTensor.from_process_local(flat, group)
        dist.broadcast(t, 0, group)
        row, off = t.tensor[0], 0
        for j in bucket:
            n = leaves[j].numel()
            new[j] = row[off:off + n].reshape(leaves[j].shape).clone()
            off += n

    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for idxs in by_dtype.values():
        bucket, bucket_bytes = [], 0
        for i in idxs:
            nb = leaves[i].numel() * leaves[i].element_size()
            if bucket and bucket_bytes + nb > cap:
                flush(bucket)
                bucket, bucket_bytes = [], 0
            bucket.append(i)
            bucket_bytes += nb
        if bucket:
            flush(bucket)
    return dict(zip(names, new))


def _stack_trees(trees):
    """Trees of tensors with one structure -> one tree of stacked tensors."""
    flat = [pytree.tree_flatten(t) for t in trees]
    stacked = [torch.stack(ls) for ls in zip(*(leaves for leaves, _ in flat))]
    return pytree.tree_unflatten(stacked, flat[0][1])


def _tree_bytes(tree) -> int:
    return sum(l.numel() * l.element_size() for l in pytree.tree_leaves(tree))


def _shapes(tree):
    return [tuple(l.shape) for l in pytree.tree_leaves(tree)]


def _permuted(t: torch.Tensor, perm) -> torch.Tensor:
    """A rank-stacked (n, *shape) leaf with its own dims permuted by `perm`."""
    return t if perm is None else t.permute((0,) + tuple(p + 1 for p in perm))


def _unpermuted(t: torch.Tensor, perm) -> torch.Tensor:
    """Inverse of `_permuted`."""
    if perm is None:
        return t
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return t.permute((0,) + tuple(p + 1 for p in inv))


def _unused_params(apply_fn, params, x, masks) -> List[str]:
    """The params that take no gradient from one forward (autograd
    reachability): the eager counterpart of the reference's jaxpr walk
    (`_live_param_names`) and of torch's `search_unused_parameters`
    (`reducer.hpp:534`)."""
    live = {n: p.detach().requires_grad_(p.is_floating_point()) for n, p in params.items()}
    with torch.enable_grad():
        out = apply_fn(live, x, masks) if masks is not None else apply_fn(live, x)
        total = sum(o.float().sum() for o in pytree.tree_leaves(out)
                    if isinstance(o, torch.Tensor) and o.is_floating_point())
        names = [n for n, p in live.items() if p.requires_grad]
        grads = torch.autograd.grad(total, [live[n] for n in names], allow_unused=True)
    return [n for n, gr in zip(names, grads) if gr is None]


@numerics_contract(
    "bitwise",
    note="ZeRO sharded weight update is bit-identical to the unsharded update "
    "for elementwise optimizers, given the same gradients: on the card that "
    "takes cudnn.deterministic, as cuDNN's default weight-gradient algorithms "
    "need not repeat their sums (tests/test_torch_ddp.py, test_torch_cuda.py)",
)
def make_ddp_train_step(
    apply_fn: Callable,
    loss_fn: Callable,
    optimizer,
    group=None,
    comm_hook: Optional[Callable] = None,
    has_rng: bool = False,
    rng_fn: Optional[Callable] = None,
    with_aux: bool = False,
    remat: bool = False,
    grad_accum_steps: int = 1,
    steps_per_call: int = 1,
    unroll_steps: bool = False,
    find_unused_parameters: bool = False,
    on_unused: Optional[Callable] = None,
    logger=None,
    shard_weight_update: str = "auto",
    hook_views: Optional[Dict[str, Optional[Tuple[int, ...]]]] = None,
):
    """A data-parallel train step over the group.

    `apply_fn(params, x) -> logits`, or `apply_fn(params, x, masks)` with
    `has_rng`, where `masks = rng_fn(generator, batch)` are one rank's random
    inputs (its dropout masks) for a local batch of `batch`;
    `loss_fn(logits, y) -> scalar`, or `(scalar, aux)` with `with_aux`;
    `optimizer` is optax-shaped (`optim.py`; a `ZeroRedundancyOptimizer` is
    unwrapped). Returns `step(params, opt_state, x, y[, seed]) -> (params,
    opt_state, loss[, aux])`: params a dict of tensors on the group's device,
    replicated; x and y this process's ranks' batches, rank-major (the
    global batch in driver mode); `seed` an int from which rank r draws its
    masks, one stream per (rank, seed); `loss` the mean over ranks, a 0-d
    tensor on the device; `aux` every local rank's, stacked (n, ...).

    `grad_accum_steps` A > 1 splits each rank's batch into A microbatches
    (rows [a*B/A, (a+1)*B/A)), sums their gradients locally and reduces
    once, then divides the loss and the gradients by A, as the reference's
    scan; aux comes back (n, A, ...). `remat` reruns the forward in the
    backward (`utils/remat.py`); the masks are inputs, so the rerun sees
    the same ones. On its first call the step finds the params that take
    no gradient: with `find_unused_parameters` it hands their names to
    `on_unused`, without it it raises, as torch's DDP and the reference do.

    A comm hook replaces the gradient reduction (`comm_hooks.py`). A
    per-leaf hook sees the leaves in `hook_views`' order, each leaf's dims
    permuted as its view says (None: as it is), so that it reduces the
    matrices and blocks the reference's layout gives (`models/convert.py`'s
    `*_hook_views`); without views, in the params' order and shapes. A
    stateful hook (`init`/`apply`) makes the step `step(params, opt_state,
    hook_state, x, y[, seed]) -> (params, opt_state, hook_state, loss[,
    aux])`, its state per rank with a leading dim of this process's ranks
    (`step.init_hook_state(params)`).

    `steps_per_call > 1` takes K stacked batches, `xs.shape == (K,
    batch, ...)`, and K seeds, runs K full steps (each with its own
    reductions and update) and returns the K losses: the same values as K
    sequential calls. `unroll_steps` is accepted for the reference's
    signature; the eager step has no loop to unroll. As in the reference,
    it does not carry `with_aux`.

    `y` may be a tree of tensors split as `x` is (a join weight beside the
    labels: `parallel/join.py`).

    `shard_weight_update` ("auto", the default, "off", "force") is ZeRO
    weight-update sharding (`parallel/zero.py`): under "auto" at world > 1
    and under "force", gradients are reduce-scattered to their owning 1/W
    shard (the default hook fused into that one collective; another hook's
    output is sliced to the shard), the optimizer updates the owned shard
    only, with its state held shard-only, and an all-gather rebuilds the
    params. The step accepts a plain `optimizer.init(params)` state and
    converts it; `step.init_opt_state(params)` builds the sharded state,
    `step.unshard_opt_state(params, state)` the full one, and
    `step.checkpoint_opt_state(params, state)` the reference's checkpoint
    form (per-leaf padded flats), which `step.shard_opt_state` takes
    back. EXACT for elementwise optimizers (`optim.sgd`, `adam`, `adamw`); scalar state
    leaves (adam's `count`) stay whole."""
    from ..optim import ZeroRedundancyOptimizer

    if shard_weight_update not in ("auto", "off", "force"):
        raise ValueError(
            f"shard_weight_update={shard_weight_update!r}; expected 'auto', 'off', or 'force'"
        )
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    if steps_per_call > 1 and with_aux:
        raise NotImplementedError(
            "steps_per_call > 1 does not carry per-step aux; use with_aux=False or "
            "steps_per_call=1 (as the reference)")
    if has_rng and rng_fn is None:
        raise ValueError("has_rng=True needs rng_fn(generator, batch) for the random inputs")
    if isinstance(optimizer, ZeroRedundancyOptimizer):
        optimizer = optimizer.optimizer
    g = dist._resolve(group)
    W = g.size()
    hook = comm_hook
    if hook is None:
        # planner-aware default: when the collective planner is active for
        # this group, each gradient leaf takes the agreed schedule for its
        # size bucket (plan.ddp_comm_hook); otherwise the stock mean
        from ..plan import ddp_comm_hook

        hook = ddp_comm_hook(g) or comm_hooks.allreduce_hook
    stateful = hasattr(hook, "init") and hasattr(hook, "apply")
    per_leaf = stateful or getattr(hook, "per_leaf", False)

    zero_update = shard_weight_update == "force" or (shard_weight_update == "auto" and W > 1)
    fused_rs = zero_update and hook is comm_hooks.allreduce_hook
    local_ranks = dist._local_rows(g)
    n_local = len(local_ranks)
    rows = zero.local_rows(g)
    A = grad_accum_steps

    def objective(params, x, y, masks):
        logits = apply_fn(params, x, masks) if has_rng else apply_fn(params, x)
        out = loss_fn(logits, y)
        return out if with_aux else (out, ())

    obj = remat_lib.checkpoint_wrapper(objective) if remat else objective
    per_rank_vmap = vmap(grad_and_value(obj, has_aux=True),
                         in_dims=(None, 0, 0, 0 if has_rng else None))
    # the rank vmap's reductions (`nn.functional.rank_all_reduce`) resolve
    # their ranks to this group in multiproc mode
    ranks_mesh = DeviceMesh.from_group(g, RANKS)

    def per_rank(*args):
        with ranks_mesh:
            return per_rank_vmap(*args)
    generators: Dict[int, torch.Generator] = {}
    layouts: Dict[tuple, zero.ShardLayout] = {}

    def layout_for(params) -> zero.ShardLayout:
        key = tuple((n, tuple(p.shape)) for n, p in params.items())
        if key not in layouts:
            layouts[key] = zero.ShardLayout([s for _, s in key], W)
        return layouts[key]

    def masks_for(seed: int, batch: int):
        """A list of A mask trees, one a microbatch of `batch`, each
        stacked over this process's ranks: rank r's stream is seeded once
        a step and drawn microbatch by microbatch."""
        per = []
        for r in local_ranks:
            gen = generators.get(r)
            if gen is None:
                gen = generators[r] = torch.Generator(device=g.device)
            gen.manual_seed(int(seed) * _SEED_MIX + r)
            per.append([rng_fn(gen, batch) for _ in range(A)])
        return [_stack_trees([p[a] for p in per]) for a in range(A)]

    def views_for(params):
        order = list(hook_views) if hook_views is not None else list(params)
        if sorted(order) != sorted(params):
            raise ValueError("hook_views must name every param once: "
                             f"{sorted(set(order) ^ set(params))[:5]} differ")
        return order, (hook_views or {})

    def local_grads(params, x, y, seed):
        """Each local rank's gradients (n, *shape), losses (n,) and aux."""
        xs = x.reshape((n_local, -1) + tuple(x.shape[1:]))
        ys = pytree.tree_map(lambda a: a.reshape((n_local, -1) + tuple(a.shape[1:])), y)
        B = xs.shape[1]
        if B % A:
            raise ValueError(f"a rank's batch of {B} does not split into {A} microbatches")
        masks = masks_for(seed, B // A) if has_rng else [None] * A
        if A == 1:
            grads, (losses, aux) = per_rank(params, xs, ys, masks[0])
            return grads, losses, aux
        xa = xs.reshape((n_local, A, B // A) + tuple(xs.shape[2:]))
        ya = pytree.tree_map(lambda t: t.reshape((n_local, A, B // A) + tuple(t.shape[2:])), ys)
        gsum = lsum = None
        auxs = []
        for a in range(A):
            gr, (l, aux) = per_rank(params, xa[:, a], pytree.tree_map(lambda t: t[:, a], ya),
                                    masks[a])
            gsum = gr if gsum is None else {n: gsum[n] + gr[n] for n in gsum}
            lsum = l if lsum is None else lsum + l
            auxs.append(aux)
        aux = pytree.tree_map(lambda *ls: torch.stack(ls, 1), *auxs) if with_aux else ()
        return {n: v / A for n, v in gsum.items()}, lsum / A, aux

    def reduce_leaves(grads, hook_state):
        """A per-leaf hook's reduction: {name: (n, *shape)} and the state."""
        order, perms = views_for(grads)
        leaves = [DistTensor.wrap(_permuted(grads[n], perms.get(n)), g) for n in order]
        if stateful:
            out, hook_state = hook.apply(hook_state, leaves, g)
        else:
            out = hook(leaves, g)
        return {n: _unpermuted(o.tensor, perms.get(n)) for n, o in zip(order, out)}, hook_state

    def own_chunks(packed):
        """Each local rank's own chunk of (n, W, K) buffers: (n, K)."""
        return packed[torch.arange(n_local, device=packed.device),
                      torch.tensor(local_ranks, device=packed.device)]

    def single(params, opt_state, hook_state, x, y, seed):
        grads, losses, aux = local_grads(params, x, y, seed)
        loss = DistTensor.wrap(losses, g)
        dist.all_reduce(loss, ReduceOp.AVG, g)

        names = list(params)
        layout = layout_for(params)
        if per_leaf:
            red, hook_state = reduce_leaves(grads, hook_state)
            reduced = (own_chunks(layout.pack([red[n] for n in names], lead=1))
                       if zero_update else None)
        else:
            packed = layout.pack([grads[n] for n in names], lead=1)  # (n, W, K)
            if fused_rs:
                reduced = zero.reduce_scatter_mean(packed, g)  # (n, K): the owned shards
            else:
                reduced = hook(DistTensor.wrap(packed.reshape(n_local, -1), g), g).tensor
                if zero_update:
                    reduced = own_chunks(reduced.reshape(n_local, W, -1))
                else:
                    red = dict(zip(names, layout.unpack(reduced[0].reshape(W, -1))))
        if zero_update:
            gshards = {n: layout.columns(reduced, i) for i, n in enumerate(names)}
            pshards = zero.shard_rows(params, g)
            updates, opt_state = optimizer.update(gshards, opt_state, pshards)
            new = apply_updates(pshards, updates)
            full = zero.unshard(torch.cat([new[n] for n in names], dim=1), g)  # (W, K)
            params = dict(zip(names, layout.unpack(full)))
        else:
            one = {n: (red[n][0] if per_leaf else red[n]) for n in names}
            updates, opt_state = optimizer.update(one, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, hook_state, loss.tensor[0], (aux if with_aux else None)

    def templates(params):
        """(unsharded, sharded) optimizer states built on the meta device:
        their shapes tell the layouts apart."""
        meta = {n: p.to("meta") for n, p in params.items()}
        return optimizer.init(meta), optimizer.init(zero.shard_rows(meta, g))

    def init_opt_state(params):
        """The optimizer state in the step's layout (under ZeRO each leaf
        is this process's ranks' (n, k) shard rows)."""
        return optimizer.init(zero.shard_rows(params, g) if zero_update else params)

    def shard_opt_state(params, opt_state):
        """An unsharded state (`optimizer.init(params)`, a restored one) or
        one of per-leaf padded flats (`checkpoint_opt_state`'s, the
        reference's checkpoint form at this world) in the sharded layout;
        a sharded one as it is."""
        if not zero_update:
            return opt_state
        unsharded, sharded = templates(params)
        shapes = _shapes(opt_state)
        if shapes == _shapes(sharded):
            return opt_state
        if shapes not in (_shapes(unsharded), _shapes(zero.to_shard_layout(unsharded, W))):
            raise ValueError(
                "shard_weight_update: the optimizer state matches neither the sharded "
                "nor the unsharded layout of these params; build it with "
                "step.init_opt_state() or optimizer.init(params)")
        return pytree.tree_map(
            lambda l: zero.padded_flat(l, W).view(W, -1)[rows].clone() if l.dim() else l,
            opt_state)

    def checkpoint_opt_state(params, opt_state):
        """The state as the reference checkpoints its ZeRO state: every
        param-shaped leaf as its padded flat (W*k,) (`zero.to_shard_layout`),
        which `checkpoint.load_checkpoint` strips back into an unsharded
        template at any world (a collective in multiproc mode)."""
        if not zero_update:
            return zero.to_shard_layout(opt_state, W)
        opt_state = shard_opt_state(params, opt_state)
        return pytree.tree_map(
            lambda l: (l if n_local == W else zero.unshard(l, g)).reshape(-1) if l.dim() else l,
            opt_state)

    def unshard_opt_state(params, opt_state):
        """The full state, leaves in param shapes (one all-gather a leaf;
        a collective in multiproc mode)."""
        if not zero_update:
            return opt_state
        unsharded, sharded = templates(params)
        if _shapes(opt_state) == _shapes(unsharded):
            return opt_state
        leaves, spec = pytree.tree_flatten(opt_state)
        refs = pytree.tree_leaves(unsharded)
        return pytree.tree_unflatten(
            [zero.from_shard_layout(zero.unshard(l, g), ref) if ref.dim() else l
             for l, ref in zip(leaves, refs)], spec)

    def init_hook_state(params):
        """The hook's state for every local rank: one rank's `hook.init`
        (of the params as the hook sees them) stacked n times, so that
        every rank starts alike and then carries its own."""
        order, perms = views_for(params)
        local = hook.init({n: _permuted(params[n][None], perms.get(n))[0] for n in order})
        return pytree.tree_map(
            lambda l: l.unsqueeze(0).expand((n_local,) + tuple(l.shape)).clone(), local)

    last_state = [None]
    unused_checked = [False]

    def check_unused(params, x, seeds):
        if unused_checked[0]:
            return
        unused_checked[0] = True
        if steps_per_call > 1:
            x, seeds = x[0], seeds[0] if seeds is not None else None
        xs = x.reshape((n_local, -1) + tuple(x.shape[1:]))[0]
        masks = None
        if has_rng:
            gen = torch.Generator(device=g.device)
            gen.manual_seed(int(seeds) * _SEED_MIX + local_ranks[0])
            masks = rng_fn(gen, xs.shape[0])
        unused = _unused_params(apply_fn, params, xs, masks)
        if not unused:
            return
        if not find_unused_parameters:
            raise RuntimeError(
                f"DDP: {len(unused)} parameter(s) never used by the forward pass: "
                f"{unused[:5]}{'...' if len(unused) > 5 else ''}. Pass "
                "find_unused_parameters=True to accept this (their gradients stay zero "
                "and are still reduced), matching torch DDP's contract.")
        if on_unused is not None:
            on_unused(unused)

    planner_prepared = [False]

    def maybe_prepare_planner(params):
        """Probe + agree the step's collective schedules on the host, once,
        before the first step: per-leaf all-reduce buckets for the hook
        plus ZeRO's reduce-scatter/all-gather halves. In a multiproc gang
        each entry rides a sequence-keyed store agreement round, so a
        skewed TDX_PLANNER_FORCE fails HERE, naming the first divergent
        eqn, not as a hang in the first collective."""
        if planner_prepared[0]:
            return
        planner_prepared[0] = True
        from ..plan import active_for_group, traced

        if active_for_group(g) and W > 1:
            traced.prepare_for_params(g, params, zero_update=zero_update)

    def run(params, opt_state, hook_state, x, y, seeds):
        maybe_prepare_planner(params)
        check_unused(params, x, seeds)
        if zero_update and opt_state is not last_state[0]:
            opt_state = shard_opt_state(params, opt_state)
        if steps_per_call == 1:
            out = single(params, opt_state, hook_state, x, y, seeds)
        else:
            losses = []
            for i in range(steps_per_call):
                params, opt_state, hook_state, loss, _ = single(
                    params, opt_state, hook_state, x[i], y[i],
                    None if seeds is None else seeds[i])
                losses.append(loss)
            out = params, opt_state, hook_state, torch.stack(losses), None
        last_state[0] = out[1]
        return out

    def timed(params, opt_state, hook_state, x, y, seeds):
        if logger is not None and logger.timing_enabled:
            logger.step_begin()
            out = run(params, opt_state, hook_state, x, y, seeds)
            if g.device.type == "cuda":
                torch.cuda.synchronize(g.device)  # true wall time, not enqueue time
            logger.step_end()
        else:
            out = run(params, opt_state, hook_state, x, y, seeds)
        p, o, hs, loss, aux = out
        head = (p, o, hs) if stateful else (p, o)
        return head + ((loss, aux) if with_aux else (loss,))

    if stateful:
        if has_rng:
            def step(params, opt_state, hook_state, x, y, seed):
                return timed(params, opt_state, hook_state, x, y, seed)
        else:
            def step(params, opt_state, hook_state, x, y):
                return timed(params, opt_state, hook_state, x, y, None)
        step.init_hook_state = init_hook_state
    elif has_rng:
        def step(params, opt_state, x, y, seed):
            return timed(params, opt_state, None, x, y, seed)
    else:
        def step(params, opt_state, x, y):
            return timed(params, opt_state, None, x, y, None)

    def memory_report(params, opt_state, grads=None):
        """Bytes of params / optimizer state (/ grads) for the whole world
        and for one rank: ZeRO holds 1/W of the state a rank."""
        sharded = zero_update and _shapes(opt_state) != _shapes(templates(params)[0])
        opt_rank = _tree_bytes(opt_state) // (n_local if sharded else 1)
        out = {
            "param_bytes": _tree_bytes(params),
            "param_bytes_per_device": _tree_bytes(params),
            "opt_state_bytes": opt_rank * (W if sharded else 1),
            "opt_state_bytes_per_device": opt_rank,
        }
        if grads is not None:
            out["grad_bytes"] = out["grad_bytes_per_device"] = _tree_bytes(grads)
        out["opt_state_reduction_x"] = round(
            out["opt_state_bytes"] / opt_rank, 3) if opt_rank else 0.0
        return out

    if os.environ.get("TDX_PROGLINT", "0") == "1":
        # register-on-first-call (tools/proglint.py): the first step
        # fingerprints the collectives it issues and agrees them across
        # ranks before they dispatch; ZeRO's reduce-scatter/all-gather
        # halves are exactly what the source plane cannot see
        from ..tools import proglint

        step = proglint.instrument(
            "ddp.train_step." + ("zero" if zero_update else "replicated"),
            step,
            path="pytorch_distributed_example_tpu_torch/parallel/ddp.py",
            mesh_axes=tuple(g.mesh.axis_names),
            world=W,
        )
    step.group = g
    step.comm_hook = hook
    step.weight_update_sharded = zero_update
    step.init_opt_state = init_opt_state
    step.shard_opt_state = shard_opt_state
    step.checkpoint_opt_state = checkpoint_opt_state
    step.unshard_opt_state = unshard_opt_state
    step.memory_report = memory_report
    return step


def make_eval_step(apply_fn: Callable, metric_fn: Callable, group=None):
    """A data-parallel eval step: the reference's metric sums all-reduced
    for the global average.

    `metric_fn(logits, y, w) -> vector of weighted SUMS`, `w` a per-sample
    weight (0 for padding). Each rank computes its sums over its share of
    the batch; one SUM all-reduce adds them. Summing with explicit weights
    makes padded tail batches exact: pad, zero the pad weights, divide by
    the true count at the end."""
    g = dist._resolve(group)
    n_local = len(dist._local_rows(g))
    per_rank = vmap(lambda p, x, y, w: metric_fn(apply_fn(p, x), y, w), in_dims=(None, 0, 0, 0))

    def eval_step(params, x, y, w):
        def split(a):
            return a.reshape((n_local, -1) + tuple(a.shape[1:]))

        with torch.no_grad():
            sums = DistTensor.wrap(per_rank(params, split(x), split(y), split(w)), g)
        dist.all_reduce(sums, ReduceOp.SUM, g)
        return sums.tensor[0]

    return eval_step


class DistributedDataParallel:
    """Module wrapper with torch-DDP construction semantics.

    Wraps a module and its params (by default the module's own): verifies
    the params across ranks, broadcasts rank 0's, keeps them as
    `self.params` (a dict of tensors on the group's device) and hands out
    train and eval steps over `torch.func.functional_call` of the module.
    `no_sync()` and `register_comm_hook` follow torch
    (`distributed.py:1659,2178`)."""

    def __init__(
        self,
        module: torch.nn.Module,
        params: Optional[Dict[str, torch.Tensor]] = None,
        process_group=None,
        broadcast_params: bool = True,
        find_unused_parameters: bool = False,
        bucket_cap_mb: float = 25.0,
    ):
        from ..utils.logger import DDPLogger
        from .reducer import Reducer

        self.module = module
        self.process_group = g = dist._resolve(process_group)
        self.find_unused_parameters = find_unused_parameters
        self.unused_parameter_names: List[str] = []  # filled on a step's first call
        self.bucket_cap_mb = bucket_cap_mb
        self._comm_hook: Optional[Callable] = None
        self._require_grad_sync = True
        if params is None:
            params = {n: p.detach() for n, p in module.named_parameters()}
        params = {n: p.detach().to(g.device) for n, p in params.items()}

        # (a) verify params across ranks, naming a mismatch (torch
        # distributed.py:1064 -> reducer.hpp:616)
        names, leaves = _named_leaves(params)
        _verify_params_across_ranks(names, leaves, g)
        # (b) rank-0 broadcast of every param in coalesced <=250 MiB buckets
        # (torch distributed.py:1066 -> utils.py:289); fresh tensors either way
        self.params = (_sync_module_states(params, g) if broadcast_params
                       else {n: p.clone() for n, p in params.items()})
        # (c) the eager bucketed Reducer (torch reducer.hpp; 25 MiB cap)
        self.reducer = Reducer(process_group=g, bucket_cap_mb=bucket_cap_mb)
        # (d) logger — torch `dist.Logger(reducer)` (distributed.py:1462)
        self.logger = DDPLogger(self)

    # -- torch surface -----------------------------------------------------
    def __call__(self, x, *args, **kwargs):
        return functional_call(self.module, self.params, (x,) + args, kwargs)

    def register_comm_hook(self, state, hook: Callable) -> None:
        """torch `register_comm_hook` (`distributed.py:2178`): a stateless
        `hook(grads, group) -> grads` (`comm_hooks.py`), with `state`, if
        given, bound in front; or a stateful hook object (`init`/`apply`),
        whose state the train step carries."""
        if hasattr(hook, "init") and hasattr(hook, "apply"):
            self._comm_hook = hook
            return
        if state is not None:
            per_leaf = getattr(hook, "per_leaf", False)
            hook = functools.partial(hook, state)
            hook.per_leaf = per_leaf
        self._comm_hook = hook

    @contextlib.contextmanager
    def no_sync(self):
        """torch `no_sync` (`distributed.py:1659`): `reduce_gradients`
        inside this context skips the Reducer's collectives, so grads
        accumulate locally."""
        old = self._require_grad_sync
        self._require_grad_sync = False
        try:
            yield
        finally:
            self._require_grad_sync = old

    def reduce_gradients(self, grads):
        """Eager bucketed mean all-reduce of a rank-stacked grad tree
        (leaves shaped (n, *param_shape)); honors `no_sync()`."""
        return self.reducer.reduce(grads, require_sync=self._require_grad_sync)

    @property
    def require_backward_grad_sync(self) -> bool:
        return self._require_grad_sync

    def make_train_step(self, optimizer, loss_fn, has_rng: bool = False, **kw):
        """`make_ddp_train_step` over the module. With `has_rng` the module
        takes its dropout masks as `masks` and draws them with
        `dropout_masks(batch, generator)`. A module with `hook_views()`
        (the reference's layout of its params, `models/convert.py`) hands
        them to per-leaf hooks."""
        module = self.module
        if has_rng:
            def apply(p, x, masks):
                return functional_call(module, p, (x,), {"masks": masks})

            kw.setdefault("rng_fn", lambda gen, batch: module.dropout_masks(batch, gen))
        else:
            def apply(p, x):
                return functional_call(module, p, (x,))
        kw.setdefault("logger", self.logger)
        kw.setdefault("find_unused_parameters", self.find_unused_parameters)
        kw.setdefault("on_unused", self.unused_parameter_names.extend)
        if hasattr(module, "hook_views"):
            kw.setdefault("hook_views", module.hook_views())
        return make_ddp_train_step(apply, loss_fn, optimizer, group=self.process_group,
                                   comm_hook=self._comm_hook, has_rng=has_rng, **kw)

    def make_eval_step(self, metric_fn):
        module = self.module
        return make_eval_step(lambda p, x: functional_call(module, p, (x,)), metric_fn,
                              group=self.process_group)

    def get_ddp_logging_data(self):
        """torch `_get_ddp_logging_data` (`distributed.py:2552`)."""
        return self.logger.get_ddp_logging_data()

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Host copies of the params."""
        return {n: p.detach().cpu() for n, p in self.params.items()}
