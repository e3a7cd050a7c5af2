"""FSDP: fully sharded data parallelism (ZeRO-3), and ZeRO-2 / ZeRO-1.

The port of the reference's `parallel/fsdp.py`. There the parameters live
sharded over the mesh (`NamedSharding`) and the train step is one GSPMD
program: it computes the loss and gradients of the GLOBAL batch, and the
sharding only places them, XLA inserting the gathers and reduce-scatters
that torch FSDP schedules by hand. The port keeps that contract in driver
mode: every parameter is a `DTensor` whose stacked local shards are one
`nn.Parameter` on the mesh's device; the step runs every rank's forward in
one autograd graph, the loss is the mean of the data ranks' local means,
and one `backward()` leaves each shard the gradient of the global mean.
The forward gathers each layer's weights over the ``fsdp`` ranks with the
differentiable all_gather of `nn.functional`, whose backward is FSDP's
reduce_scatter, and the optimizer (torch's, elementwise, so a stacked
AdamW equals a per-rank one) steps the shards where they lie.

A module that can run over the mesh itself (`TransformerLM.
sharded_forward`: the reference's Megatron + ZeRO layout over ("fsdp",
"tp") or ("dp", "fsdp", "tp")) does so; any other module runs on the
gathered parameters (`DTensor.full_tensor`, differentiable) over the
global batch.

ZeRO stages: `make_fsdp_train_step` (params, grads and optimizer state
sharded; ZeRO-3), `make_zero2_train_step` (params replicated, gradients
reduce-scattered, optimizer state sharded; a stateless `comm_hook`
reduces them in its place), `shard_optimizer_only` (ZeRO-1: the
optimizer state's layout).

Over a multiproc mesh (`mesh.py`: one process a rank) the same steps run
each process's rank: the global batch is split by this process's data
coordinate, the parameters are this process's shards, the collectives
those of the mesh's axis groups (`nn.functional`'s multiproc mode). A
process backpropagates its data rank's share of the global mean (its
loss / the data ranks); the gathers over the data axes sum the
processes' cotangents back into each shard (reduce_scatter, or all_reduce
for a weight the data axes replicate), and the loss returned is the
data ranks' mean, all-reduced.

Dropout (`has_rng=True`) takes the DDP step's form (`parallel/ddp.py`):
`rng_fn(generator, batch)` draws one data rank's random inputs (its
masks) from the `torch.Generator` the step takes as its fifth argument,
rank after rank, so each data rank gets its own draws, where the
reference folds its key with the axis index; the masks go into the
forward as inputs.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
from torch.func import functional_call
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..dtensor import DTensor, Replicate, Shard, distribute_tensor, spec_to_placements
from ..mesh import DeviceMesh
from ..nn import functional as nnf
from ..tensor import DistTensor
from ..types import ReduceOp
from ..utils import memstats
from . import sharding as shd
from .ddp import _stack_trees


def _as_parameters(params: Mapping[str, DTensor]) -> Dict[str, DTensor]:
    """Make each DTensor's local stack a leaf the optimizer can step."""
    for dt in params.values():
        if not isinstance(dt._local, torch.nn.Parameter):
            dt._local = torch.nn.Parameter(dt._local.detach(),
                                           requires_grad=dt._local.is_floating_point())
    return dict(params)


def _data_ranks(mesh: DeviceMesh, data_axes: Sequence[str]):
    present = tuple(a for a in data_axes if a in mesh.axis_names)
    if not present:
        raise ValueError(
            f"none of data_axes present in mesh axes {tuple(mesh.axis_names)}; pass data_axes "
            "matching your mesh (e.g. data_axes=('fsdp',))")
    return present, math.prod(mesh.axis_size(a) for a in present)


def _split(x, n: int):
    """A global batch (B, ...) as n data ranks' rows (n, B/n, ...)."""
    if x.shape[0] % n:
        raise ValueError(f"global batch of {x.shape[0]} does not split over {n} data ranks")
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def _data_rows(mesh: DeviceMesh, present: Sequence[str], n: int) -> range:
    """The data ranks whose rows this process holds: all n in driver mode,
    its own (flat over `present`, dp-major) over a multiproc mesh."""
    if not mesh.multiproc:
        return range(n)
    d = mesh.flat_index(present)
    return range(d, d + 1)


def _take(x, rows: range):
    return x if len(rows) == x.shape[0] else x[rows.start:rows.stop]


def _data_mean(values, mesh: DeviceMesh, present: Sequence[str]):
    """The mean of the data ranks' values (n_local,): over a multiproc mesh
    this process's value, AVG all-reduced over each data axis in turn."""
    if not mesh.multiproc:
        return values.mean()
    v = values.reshape((1,) * len(present))
    with mesh:
        for a in present:
            v = nnf.all_reduce(v, ReduceOp.AVG, a, axes=tuple(present))
    return v.reshape(())


def gathered_apply(module: torch.nn.Module, data_axes: Sequence[str] = ("dp", "fsdp")):
    """apply(params, xs[, masks]): `module` on its gathered parameters,
    over the data ranks' rows xs (n, b, ...) -> (n, b, ...); `masks` (n,
    b, ...), the ranks' random inputs, go in as the module's second
    argument. Over a multiproc mesh the rows are this process's data
    rank's, and the gathers sum the cotangents over `data_axes`."""
    def full_of(v):
        return v.full_tensor(data_axes) if isinstance(v, DTensor) else v

    def apply(params, xs, *masks):
        full = {k: full_of(v) for k, v in params.items()}
        args = (xs, *masks)
        out = functional_call(module, full, tuple(a.flatten(0, 1) for a in args))
        return out.unflatten(0, xs.shape[:2])

    return apply


def _draw_masks(rng_fn, generator, n: int, batch: int):
    """Each of the n data ranks' random inputs for a local batch of
    `batch`, drawn rank after rank from `generator`, stacked (n, ...)."""
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"has_rng=True: the step's fifth argument is a torch.Generator, got "
                        f"{type(generator).__name__}")
    return _stack_trees([rng_fn(generator, batch) for _ in range(n)])


class FSDPModule:
    """A model whose params are fully sharded over a mesh axis.

    Usage::

        mod = fully_shard(model, None, mesh, axis="fsdp")
        step = mod.make_train_step(torch.optim.AdamW, loss_fn)
        opt_state = step.init_opt_state(mod.params)
        params, opt_state, loss = step(mod.params, opt_state, x, y)
    """

    def __init__(self, module, params, mesh: DeviceMesh, axis: str, specs, data_axes):
        self.module = module
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.param_specs = specs
        self.data_axes = tuple(data_axes)
        names = tuple(mesh.axis_names)
        data = tuple(a for a in ("dp", axis) if a in names)
        stacked = (hasattr(module, "sharded_forward") and len(names) in (2, 3)
                   and names[:-1] == data and self.data_axes == data)
        if stacked:
            self.apply = lambda p, xs: module.sharded_forward(p, xs, mesh, axis, names[-1])
        else:
            self.apply = gathered_apply(module, self.data_axes)

    def __call__(self, x):
        present, n = _data_ranks(self.mesh, self.data_axes)
        out = self.apply(self.params, _take(_split(x, n), _data_rows(self.mesh, present, n)))
        return out.flatten(0, 1)

    def make_train_step(self, optimizer, loss_fn: Callable, has_rng: bool = False,
                        rng_fn: Optional[Callable] = None, remat: bool = False,
                        donate: bool = True, shard_weight_update: str = "auto"):
        return make_fsdp_train_step(self.apply, loss_fn, optimizer, self.mesh, self.param_specs,
                                    data_axes=self.data_axes, has_rng=has_rng, rng_fn=rng_fn,
                                    remat=remat, donate=donate,
                                    shard_weight_update=shard_weight_update)

    def gather_params(self) -> Dict[str, torch.Tensor]:
        """Full (unsharded) params on the host: the rank-0 checkpoint's (a
        collective over a multiproc mesh: every process calls it)."""
        return {k: v.full_tensor().detach().cpu() for k, v in self.params.items()}

    def state_dict(self, optimizer=None) -> dict:
        """The sharded train state, as `checkpoint_sharded.dcp_save` takes
        it: {"params": name -> DTensor} and, given the step's (sharded)
        torch optimizer, {"optim": name -> {state key -> DTensor or tensor}}
        with each param-shaped state (AdamW's moments) in its param's
        layout. Views of the live tensors, no copies."""
        out = {"params": {k: DTensor(v._local.detach(), v.device_mesh, v.placements)
                          for k, v in self.params.items()}}
        if optimizer is not None:
            optim = {}
            for k, v in self.params.items():
                st = optimizer.state.get(v._local, {})
                optim[k] = {key: (DTensor(t, v.device_mesh, v.placements)
                                  if isinstance(t, torch.Tensor) and t.shape == v._local.shape
                                  else t) for key, t in st.items()}
            out["optim"] = optim
        return out

    def load_state_dict(self, state: dict, optimizer=None) -> None:
        """Copy a `state_dict`-shaped tree (e.g. `dcp_load`'s, into this
        module's layout) into the live shards and optimizer state, in place."""
        with torch.no_grad():
            for k, v in self.params.items():
                v._local.copy_(state["params"][k]._local)
        if optimizer is None:
            return
        for k, v in self.params.items():
            saved = state["optim"][k]
            st = optimizer.state[v._local]
            for key, t in saved.items():
                t = t._local if isinstance(t, DTensor) else t
                if isinstance(st.get(key), torch.Tensor):
                    st[key].copy_(t)
                else:
                    st[key] = t.clone() if isinstance(t, torch.Tensor) else t


def fully_shard(module, params=None, mesh: Optional[DeviceMesh] = None, axis: str = "fsdp",
                rules: Optional[Sequence[shd.Rule]] = None,
                data_axes: Sequence[str] = ("dp", "fsdp")) -> FSDPModule:
    """Shard ``params`` (default: the module's state_dict) dim 0 over
    ``mesh[axis]``, or by ``rules`` (e.g. the transformer's fsdp x tp
    table). Leaves whose dims the axes do not divide stay replicated
    (FSDP's small-param behaviour)."""
    if mesh is None or axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {getattr(mesh, 'axis_names', None)}")
    if params is None:
        params = module.state_dict()
    sharded, specs = shd.shard_params(params, mesh, rules or shd.fsdp_rules(axis))
    present = [a for a in data_axes if a in mesh.axis_names]
    return FSDPModule(module, _as_parameters(sharded), mesh, axis, specs, present or (axis,))


def _check_swu(shard_weight_update: str) -> bool:
    if shard_weight_update not in ("auto", "off", "force"):
        raise ValueError(f"shard_weight_update={shard_weight_update!r}; expected 'auto', "
                         "'off', or 'force'")
    return shard_weight_update != "off"


def _check_rng(has_rng: bool, rng_fn) -> None:
    if has_rng and rng_fn is None:
        raise ValueError("has_rng=True needs rng_fn(generator, batch) for the random inputs")


def _mean_loss(loss_fn, out, ys):
    """The mean of the data ranks' local losses: the global batch's mean
    when the ranks hold equal rows."""
    return torch.stack([loss_fn(out[d], ys[d]) for d in range(ys.shape[0])]).mean()


class ReplicatedUpdate:
    """The optimizer of `shard_weight_update="off"`: every rank's full copy
    of the params and their state (held once), the baseline the sharded
    update is measured against."""

    def __init__(self, optimizer, params: Mapping[str, DTensor]):
        self.replicas = {k: torch.nn.Parameter(v.full_tensor().detach().clone())
                         for k, v in params.items() if v._local.requires_grad}
        self.optimizer = optimizer(list(self.replicas.values()))

    def step(self, params: Mapping[str, DTensor]) -> None:
        for k, rep in self.replicas.items():
            dt = params[k]
            rep.grad = DTensor(dt._local.grad, dt.device_mesh, dt.placements).full_tensor()
        self.optimizer.step()
        with torch.no_grad():
            for k, rep in self.replicas.items():
                dt = params[k]
                dt._local.copy_(distribute_tensor(rep, dt.device_mesh, dt.placements)._local)


def make_fsdp_train_step(apply_fn: Callable, loss_fn: Callable, optimizer, mesh: DeviceMesh,
                         param_specs, data_axes: Sequence[str] = ("dp", "fsdp"),
                         has_rng: bool = False, rng_fn: Optional[Callable] = None,
                         remat: bool = False, donate: bool = True,
                         shard_weight_update: str = "auto"):
    """The FSDP (ZeRO-3) train step: the batch split over the data axes,
    params sharded per ``param_specs``.

    ``apply_fn(params, xs)`` runs the model over the data ranks' rows xs
    (n, b, ...); ``loss_fn(out, y)`` is one rank's loss; ``optimizer`` is
    a callable taking a list of parameters (e.g. `torch.optim.AdamW` or a
    `functools.partial` of it). `step(params, opt_state, x, y)` takes the
    global batch and returns (params, opt_state, loss), updating in place.
    `step.init_opt_state(params)` builds the optimizer: under "auto" it
    steps the shards where they lie (its state mirrors the param layout);
    "off" keeps a replicated copy of params and state (the
    world-x-redundant baseline). ``donate`` is accepted (the update is in
    place). With `has_rng` the step is `step(params, opt_state, x, y,
    generator)` and the forward `apply_fn(params, xs, masks)`, the data
    ranks' masks (n, ...) drawn by `rng_fn` (the module docstring)."""
    _check_rng(has_rng, rng_fn)
    sharded_update = _check_swu(shard_weight_update)
    present, n = _data_ranks(mesh, data_axes)
    rows = _data_rows(mesh, present, n)

    def step(params, opt_state, x, y, *generator):
        if len(generator) != has_rng:
            raise TypeError("the step takes a torch.Generator fifth exactly when has_rng=True")
        xs, ys = _take(_split(x, n), rows), _take(_split(y, n), rows)
        masks = ((pytree.tree_map(lambda m: _take(m, rows),
                                  _draw_masks(rng_fn, generator[0], n, xs.shape[1])),)
                 if has_rng else ())
        for dt in params.values():
            dt._local.grad = None
        with mesh:
            out = checkpoint(apply_fn, params, xs, *masks, use_reentrant=False) if remat else \
                apply_fn(params, xs, *masks)
            loss = _mean_loss(loss_fn, out, ys)
            # a process backpropagates its data ranks' share of the global mean
            (loss * (len(rows) / n)).backward()
        if isinstance(opt_state, ReplicatedUpdate):
            opt_state.step(params)
        else:
            opt_state.step()
        return params, opt_state, _data_mean(loss.detach().reshape(1), mesh, present)

    def init_opt_state(params):
        if sharded_update:
            return optimizer([dt._local for dt in params.values() if dt._local.requires_grad])
        return ReplicatedUpdate(optimizer, params)

    step.init_opt_state = init_opt_state
    step.weight_update_sharded = sharded_update
    step.memory_report = memstats.train_memory_report
    return step


class Zero2State:
    """ZeRO-2's optimizer state: the optimizer over each param's update
    shards, `shards[name]` (W, n/W, ...) where dim 0 splits over the axis
    (the names in `sharded`; over a multiproc mesh (1, n/W, ...), this
    process's shard), else the whole param (1, ...)."""

    def __init__(self, optimizer, params: Mapping[str, torch.Tensor], mesh: DeviceMesh,
                 axis: str, sharded: bool):
        W = mesh.axis_size(axis)
        self.shards, self.sharded = {}, set()
        for k, p in params.items():
            if not p.is_floating_point():
                continue
            spec = shd.spec_for("zero", tuple(p.shape), shd.fsdp_rules(axis), mesh)
            if sharded and spec and W > 1:
                chunks = p.detach().chunk(W, 0)
                if mesh.multiproc:
                    chunks = chunks[mesh.axis_index(axis):mesh.axis_index(axis) + 1]
                self.shards[k] = torch.nn.Parameter(torch.stack(chunks).clone())
                self.sharded.add(k)
            else:
                self.shards[k] = torch.nn.Parameter(p.detach().clone().unsqueeze(0))
        self.optimizer = optimizer(list(self.shards.values()))
        # each shard stack as the DTensor it is, for memstats
        self.layout = {}
        for k, shard in self.shards.items():
            placements = [Shard(0) if a == axis and k in self.sharded else Replicate()
                          for a in mesh.axis_names]
            stack = [shard.shape[0] if a == axis else 1 for a in mesh.axis_names]
            local = shard.view(*stack, *shard.shape[1:])
            self.layout[id(shard)] = DTensor(local, mesh, placements)


def _full(p):
    if isinstance(p, DTensor):
        if not all(isinstance(q, Replicate) for q in p.placements):
            raise ValueError("make_zero2_train_step keeps params replicated")
        return p.full_tensor()
    return p


def _axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the c10d core over the ranks of `axis`, what a
    comm hook reduces over: the multiproc mesh's own, else a driver-mode
    group on the mesh's device."""
    from ..backends.stacked import StackedBackend
    from ..distributed import ProcessGroup

    if mesh.multiproc:
        return mesh.get_group(axis)
    W = mesh.axis_size(axis)
    flat = DeviceMesh([mesh.device] * W, (W,), (axis,))
    return ProcessGroup(flat, list(range(W)), "xla", StackedBackend(flat, 0, W), None,
                        f"zero2_{axis}", 1800.0)


def _hook_reduce(hook, grads, group):
    """A stateless comm hook's mean of the ranks' gradients {name: (W,
    *shape)}: a per-leaf hook takes the leaves in order, a flat one their
    (W, N) concatenation."""
    names = list(grads)
    if getattr(hook, "per_leaf", False):
        out = hook([DistTensor.wrap(grads[k], group) for k in names], group)
        return {k: o.tensor for k, o in zip(names, out)}
    W = next(iter(grads.values())).shape[0]
    flat = hook(DistTensor.wrap(torch.cat([grads[k].reshape(W, -1) for k in names], 1), group),
                group).tensor
    out, off = {}, 0
    for k in names:
        size = grads[k][0].numel()
        out[k] = flat[:, off:off + size].reshape(grads[k].shape)
        off += size
    return out


def make_zero2_train_step(apply_fn: Callable, loss_fn: Callable, optimizer, mesh: DeviceMesh,
                          axis: str = "fsdp", data_axes: Sequence[str] = ("dp", "fsdp"),
                          has_rng: bool = False, rng_fn: Optional[Callable] = None,
                          remat: bool = False, donate: bool = True,
                          comm_hook: Optional[Callable] = None,
                          shard_weight_update: str = "auto"):
    """ZeRO-2: params REPLICATED, gradients and optimizer state SHARDED.

    ``apply_fn(params, x)`` is one rank's forward on its rows (params a
    mapping of name -> full tensor, e.g. through `functional_call`). The
    batch splits over the data axes present in the mesh (dp-major). Each
    data rank's gradient comes from its own rows; they are AVG-reduced
    over the data axes other than ``axis`` (dp) and meet in an AVG
    reduce_scatter over ``axis`` (dim 0 of each leaf it divides; the
    others all-reduce), the optimizer steps the 1/W shards, and one
    all_gather over ``axis`` of the updated shards refreshes the
    replicated params. The per-step collectives equal DDP's all-reduce,
    the optimizer's work and state are 1/W a rank. "off" all-reduces the
    gradients and updates the replica. ``axis`` must be a data axis.

    `comm_hook` replaces the gradient reduction with a STATELESS hook of
    `comm_hooks.py` (e.g. `blockwise_quant_hook(error_feedback=False)`)
    over the one data axis: it reduces the ranks' gradients over a
    driver-mode group of that axis, and each rank keeps its shard of the
    result; the update all-gather stays full precision. A stateful hook
    raises NotImplementedError (this step carries no hook state), more
    than one data axis ValueError, as in the reference. With `has_rng` the
    step takes a `torch.Generator` fifth and the forward is
    `apply_fn(params, x, masks)` (the module docstring)."""
    _check_rng(has_rng, rng_fn)
    sharded_update = _check_swu(shard_weight_update)
    present, n = _data_ranks(mesh, data_axes)
    if axis not in present:
        raise ValueError(f"ZeRO-2 shards over {axis!r}, which is not one of the data axes "
                         f"{present} in the mesh")
    group = None
    if comm_hook is None:
        # planner-aware default: with the traced planner on, the grad
        # reduction takes the agreed schedule table's per-bucket winner
        # (plan/traced.py — probed and agreed on the host at the first
        # call, below); planner off keeps the stock reduction exactly
        from ..plan import traced

        if traced.enabled() and len(present) == 1:
            from . import comm_hooks

            comm_hook = comm_hooks.planner_hook()
    if comm_hook is not None:
        if hasattr(comm_hook, "init") and hasattr(comm_hook, "apply"):
            raise NotImplementedError(
                "stateful comm hooks (error feedback / PowerSGD) carry a state the ZeRO-2 "
                "step's (params, opt_state, x, y) signature cannot: pass a stateless hook "
                "(e.g. blockwise_quant_hook(error_feedback=False)) or use make_ddp_train_step")
        if len(present) != 1:
            raise ValueError(f"comm_hook needs exactly one data axis in the mesh; data_axes "
                             f"{tuple(data_axes)} resolve to {list(present)} on mesh axes "
                             f"{tuple(mesh.axis_names)}")
        group = _axis_group(mesh, axis)
    W = mesh.axis_size(axis)
    sizes = [mesh.local_size(a) for a in present]
    others = [a for a in present if a != axis]
    rows = _data_rows(mesh, present, n)

    def reduced(g, sharded: bool):
        """(n, *shape) data ranks' gradients -> each rank's shard of their
        mean (W, *shard), or the mean (1, *shape) of a leaf kept whole."""
        g = g.reshape(*sizes, *g.shape[1:])
        axes = list(present)
        for a in others:  # AVG over dp: one replica left
            g = nnf.all_reduce(g, ReduceOp.AVG, a, axes=tuple(axes), replica=True)
            axes.remove(a)
        if sharded:  # reduce_scatter(AVG) over the axis
            return nnf.reduce_scatter(g, axis, 0) / W
        return nnf.all_reduce(g, ReduceOp.AVG, axis, replica=True).unsqueeze(0)

    def step(params, opt_state, x, y, *generator):
        if len(generator) != has_rng:
            raise TypeError("the step takes a torch.Generator fifth exactly when has_rng=True")
        xs, ys = _split(x, n), _split(y, n)
        masks = _draw_masks(rng_fn, generator[0], n, xs.shape[1]) if has_rng else None
        full = {k: _full(v) for k, v in params.items()}
        names = list(opt_state.shards)
        fwd = (lambda *a: checkpoint(apply_fn, *a, use_reentrant=False)) if remat else apply_fn
        losses, grads = [], []
        for d in rows:  # each data rank's own gradient
            leaves = {k: v.detach().requires_grad_(k in opt_state.shards)
                      for k, v in full.items()}
            rank_masks = (pytree.tree_map(lambda m: m[d], masks),) if has_rng else ()
            loss = loss_fn(fwd(leaves, xs[d], *rank_masks), ys[d])
            grads.append(torch.autograd.grad(loss, [leaves[k] for k in names]))
            losses.append(loss.detach())
        with torch.no_grad(), mesh:
            stacked = {k: torch.stack([gd[i] for gd in grads]) for i, k in enumerate(names)}
            if comm_hook is not None:
                means = _hook_reduce(comm_hook, stacked, group)  # (W, *shape), each the mean
            for k in names:
                shard = opt_state.shards[k]
                sharded = k in opt_state.sharded
                if comm_hook is None:
                    shard.grad = reduced(stacked[k], sharded)
                elif sharded:  # each rank keeps its own shard of the mean
                    shard.grad = torch.stack([means[k][i].chunk(W, 0)[r] for i, r in
                                              enumerate(nnf.rank_ids(axis, W).tolist())])
                else:
                    shard.grad = means[k][:1]
        opt_state.optimizer.step()
        with torch.no_grad(), mesh:
            for k, shard in opt_state.shards.items():
                new = (nnf.all_gather(shard, axis, 0, replica=True) if k in opt_state.sharded
                       else shard[0])
                target = params[k]
                if isinstance(target, DTensor):
                    target = target._local.view(target.local_shape)
                target.copy_(new)
        return params, opt_state, _data_mean(torch.stack(losses), mesh, present)

    def init_opt_state(params):
        return Zero2State(optimizer, {k: _full(v) for k, v in params.items()}, mesh, axis,
                          sharded_update)

    if comm_hook is not None:
        # with the planner on, probe + agree the hook's per-leaf schedule
        # buckets on the host before the first step (plan/traced.py: the
        # step then reads the agreed table purely)
        inner_step, prepared = step, [False]

        def step(params, opt_state, x, y, *generator):
            if not prepared[0]:
                prepared[0] = True
                from ..plan import traced

                if traced.enabled(group):
                    traced.prepare_for_params(group, {k: _full(v) for k, v in params.items()})
            return inner_step(params, opt_state, x, y, *generator)

    step.init_opt_state = init_opt_state
    step.weight_update_sharded = sharded_update
    return step


def shard_optimizer_only(opt_state, mesh: DeviceMesh, axis: str = "fsdp"):
    """ZeRO-1 layout for an optimizer state (a nest of dicts, lists and
    tensors, e.g. `optimizer.state_dict()["state"]`): every tensor leaf
    with a dim 0 the axis divides is sharded there, the rest replicated.
    Returns the same nest of `DTensor`s."""
    rules = shd.fsdp_rules(axis)

    def place(x):
        if isinstance(x, Mapping):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        if isinstance(x, torch.Tensor):
            spec = shd.spec_for("opt", tuple(x.shape), rules, mesh) if x.dim() else ()
            return distribute_tensor(x, mesh, spec_to_placements(spec, mesh))
        return x

    return place(opt_state)
