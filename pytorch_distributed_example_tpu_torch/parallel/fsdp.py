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
sharded_forward`: the reference's 2-D Megatron + ZeRO layout) does so;
any other module runs on the gathered parameters (`DTensor.full_tensor`,
differentiable) over the global batch.

ZeRO stages: `make_fsdp_train_step` (params, grads and optimizer state
sharded; ZeRO-3), `make_zero2_train_step` (params replicated, gradients
reduce-scattered, optimizer state sharded), `shard_optimizer_only`
(ZeRO-1: the optimizer state's layout). Not ported: `comm_hook` (the
compression and planner hooks, ROADMAP Queue 1 item 2) and dropout in
these steps (`has_rng=True`): both raise NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..dtensor import DTensor, Replicate, Shard, distribute_tensor, spec_to_placements
from ..mesh import DeviceMesh
from ..nn import functional as nnf
from ..types import ReduceOp
from ..utils import memstats
from . import sharding as shd


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


def gathered_apply(module: torch.nn.Module):
    """apply(params, xs): `module` on its gathered parameters, over the
    data ranks' rows xs (n, b, ...) -> (n, b, ...)."""
    def apply(params, xs):
        full = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in params.items()}
        out = functional_call(module, full, (xs.flatten(0, 1),))
        return out.unflatten(0, xs.shape[:2])

    return apply


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
        other = [a for a in mesh.axis_names if a != axis]
        stacked = (hasattr(module, "sharded_forward") and len(mesh.shape) == 2
                   and mesh.axis_names[0] == axis and self.data_axes == (axis,))
        if stacked:
            tp = other[0]
            self.apply = lambda p, xs: module.sharded_forward(p, xs, mesh, axis, tp)
        else:
            self.apply = gathered_apply(module)

    def __call__(self, x):
        _, n = _data_ranks(self.mesh, self.data_axes)
        out = self.apply(self.params, _split(x, n))
        return out.flatten(0, 1)

    def make_train_step(self, optimizer, loss_fn: Callable, has_rng: bool = False,
                        remat: bool = False, donate: bool = True,
                        shard_weight_update: str = "auto"):
        return make_fsdp_train_step(self.apply, loss_fn, optimizer, self.mesh, self.param_specs,
                                    data_axes=self.data_axes, has_rng=has_rng, remat=remat,
                                    donate=donate, shard_weight_update=shard_weight_update)

    def gather_params(self) -> Dict[str, torch.Tensor]:
        """Full (unsharded) params on the host: the rank-0 checkpoint's."""
        return {k: v.full_tensor().detach().cpu() for k, v in self.params.items()}


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


def _refuse(has_rng: bool, comm_hook=None) -> None:
    if has_rng:
        raise NotImplementedError("dropout in the sharded train steps (has_rng=True) is not "
                                  "ported yet: ROADMAP.md, Queue 1, 'Sharded training'")
    if comm_hook is not None:
        raise NotImplementedError("comm_hook on the ZeRO-2 step is not ported yet: ROADMAP.md, "
                                  "Queue 1, 'Sharded training'")


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
                         has_rng: bool = False, remat: bool = False, donate: bool = True,
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
    place)."""
    _refuse(has_rng)
    sharded_update = _check_swu(shard_weight_update)
    _, n = _data_ranks(mesh, data_axes)

    def step(params, opt_state, x, y):
        xs, ys = _split(x, n), _split(y, n)
        for dt in params.values():
            dt._local.grad = None
        out = checkpoint(apply_fn, params, xs, use_reentrant=False) if remat else apply_fn(
            params, xs)
        loss = _mean_loss(loss_fn, out, ys)
        loss.backward()
        if isinstance(opt_state, ReplicatedUpdate):
            opt_state.step(params)
        else:
            opt_state.step()
        return params, opt_state, loss.detach()

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
    shards, `shards[name]` (W, n/W, ...) where dim 0 splits over the axis,
    else the whole param (1, ...)."""

    def __init__(self, optimizer, params: Mapping[str, torch.Tensor], mesh: DeviceMesh,
                 axis: str, sharded: bool):
        W = mesh.axis_size(axis)
        self.shards = {}
        for k, p in params.items():
            if not p.is_floating_point():
                continue
            spec = shd.spec_for("zero", tuple(p.shape), shd.fsdp_rules(axis), mesh)
            if sharded and spec:
                self.shards[k] = torch.nn.Parameter(
                    torch.stack(p.detach().chunk(W, 0)).clone())
            else:
                self.shards[k] = torch.nn.Parameter(p.detach().clone().unsqueeze(0))
        self.optimizer = optimizer(list(self.shards.values()))
        # each shard stack as the DTensor it is, for memstats
        self.layout = {}
        for k, shard in self.shards.items():
            placements = [Shard(0) if a == axis and shard.shape[0] > 1 else Replicate()
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


def make_zero2_train_step(apply_fn: Callable, loss_fn: Callable, optimizer, mesh: DeviceMesh,
                          axis: str = "fsdp", data_axes: Sequence[str] = ("dp", "fsdp"),
                          has_rng: bool = False, remat: bool = False, donate: bool = True,
                          comm_hook: Optional[Callable] = None,
                          shard_weight_update: str = "auto"):
    """ZeRO-2: params REPLICATED, gradients and optimizer state SHARDED.

    ``apply_fn(params, x)`` is one rank's forward on its rows (params a
    mapping of name -> full tensor, e.g. through `functional_call`).
    Each data rank's gradient comes from its own rows; they meet in an
    AVG reduce_scatter over ``axis`` (dim 0 of each leaf it divides; the
    others all-reduce), the optimizer steps the 1/W shards, and one
    all_gather of the updated shards refreshes the replicated params. The
    per-step collectives equal DDP's all-reduce, the optimizer's work and
    state are 1/W a rank. "off" all-reduces the gradients and updates the
    replica. The single data axis must be ``axis``."""
    _refuse(has_rng, comm_hook)
    sharded_update = _check_swu(shard_weight_update)
    present, n = _data_ranks(mesh, data_axes)
    if present != (axis,):
        raise NotImplementedError(f"ZeRO-2 over data axes {present}: the port shards over the "
                                  f"one data axis {axis!r}")

    def step(params, opt_state, x, y):
        xs, ys = _split(x, n), _split(y, n)
        full = {k: _full(v) for k, v in params.items()}
        names = list(opt_state.shards)
        fwd = (lambda p, xx: checkpoint(apply_fn, p, xx, use_reentrant=False)) if remat \
            else apply_fn
        losses, grads = [], []
        for d in range(n):  # each data rank's own gradient
            leaves = {k: v.detach().requires_grad_(k in opt_state.shards)
                      for k, v in full.items()}
            loss = loss_fn(fwd(leaves, xs[d]), ys[d])
            grads.append(torch.autograd.grad(loss, [leaves[k] for k in names]))
            losses.append(loss.detach())
        with torch.no_grad():
            for i, k in enumerate(names):
                g = torch.stack([gd[i] for gd in grads])  # (n, *shape)
                shard = opt_state.shards[k]
                if shard.shape[0] == n and n > 1:  # reduce_scatter(AVG) over the axis
                    shard.grad = nnf.reduce_scatter(g, axis, 0) / n
                else:
                    shard.grad = nnf.all_reduce(g, ReduceOp.AVG, axis, replica=True).unsqueeze(0)
        opt_state.optimizer.step()
        with torch.no_grad():
            for k, shard in opt_state.shards.items():
                new = (nnf.all_gather(shard, axis, 0, replica=True) if shard.shape[0] == n
                       and n > 1 else shard[0])
                target = params[k]
                if isinstance(target, DTensor):
                    target = target._local.view(target.local_shape)
                target.copy_(new)
        return params, opt_state, torch.stack(losses).mean()

    def init_opt_state(params):
        return Zero2State(optimizer, {k: _full(v) for k, v in params.items()}, mesh, axis,
                          sharded_update)

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
