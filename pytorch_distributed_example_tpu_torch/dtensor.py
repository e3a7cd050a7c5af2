"""DTensor: `torch.distributed.tensor` parity over the port's `DeviceMesh`.

The port of the reference's `dtensor.py`. There a DTensor wraps a global
`jax.Array` with a `NamedSharding`, and redistribution is a `device_put`.
Here, in driver mode, a DTensor holds its ranks' local tensors stacked on
the mesh's device: one leading dim per mesh axis, in mesh-axis order, of
the axis's size where the placement is `Shard` (the shards, in rank order)
or `Partial` (the unreduced addends), and of size 1 where it is
`Replicate` (one copy serves every rank of that axis). So a (V, D) weight
with placements (Replicate(), Shard(1)) on a ("fsdp", "tp") mesh of (2, 2)
is stored (1, 2, V, D/2).

`from_local` takes the reference's convention: one leading stack dim per
non-Replicate placement, in mesh-axis order. `full_tensor`,
`redistribute` and the arithmetic are torch ops on those stacks, so they
are differentiable. The placement algebra is torch's: `Shard(dim)`,
`Replicate()`, `Partial(reduce_op)`, one placement per mesh axis, and one
tensor dim sharded by at most one axis.

Arithmetic applies the op to the global values; where the reference reads
the result's sharding back from XLA's propagation, the port keeps the
left operand's placements when the result has its shape and replicates it
otherwise. `redistribute_for_serving`/`redistribute_tree` wait for the
serving slice (ROADMAP).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from .mesh import DeviceMesh
from .types import ReduceOp, fold


@dataclass(frozen=True)
class Shard:
    """Tensor dim `dim` is split over the corresponding mesh axis."""

    dim: int

    def __repr__(self):
        return f"Shard(dim={self.dim})"


@dataclass(frozen=True)
class Replicate:
    """Tensor is replicated along the corresponding mesh axis."""

    def __repr__(self):
        return "Replicate()"


@dataclass(frozen=True)
class Partial:
    """Each position along the mesh axis holds an unreduced addend."""

    reduce_op: Any = ReduceOp.SUM

    def __repr__(self):
        name = getattr(self.reduce_op, "name", None) or repr(self.reduce_op)
        return f"Partial({name})"


Placement = Any  # Shard | Replicate | Partial


def _normalize(placements, mesh: DeviceMesh, ndim: Optional[int] = None) -> Tuple:
    """Validate placements; canonicalize negative Shard dims."""
    axes = mesh.axis_names
    placements = tuple(placements)
    if len(placements) != len(axes):
        raise ValueError(f"need one placement per mesh axis {tuple(axes)}, got {placements}")
    out, seen = [], {}
    for ax, p in zip(axes, placements):
        if isinstance(p, Shard):
            dim = p.dim
            if dim < 0:
                if ndim is None:
                    raise ValueError(f"negative Shard dim {dim} needs a known tensor rank")
                dim %= ndim
                p = Shard(dim)
            if ndim is not None and not 0 <= dim < ndim:
                raise ValueError(f"Shard dim {p.dim} out of range for rank {ndim}")
            if dim in seen:
                raise NotImplementedError(
                    f"tensor dim {dim} sharded by both {seen[dim]!r} and {ax!r}; multi-axis "
                    "sharding of one dim is unsupported")
            seen[dim] = ax
        elif not isinstance(p, (Replicate, Partial)):
            raise TypeError(f"unknown placement {p!r}")
        out.append(p)
    return tuple(out)


def stack_shape(mesh: DeviceMesh, placements) -> Tuple[int, ...]:
    """The leading dims a DTensor's local stack has for these placements."""
    return tuple(1 if isinstance(p, Replicate) else n for p, n in zip(placements, mesh.shape))


def spec_to_placements(spec, mesh: DeviceMesh) -> Tuple:
    """A spec (tuple of mesh-axis names or None per tensor dim, as
    `parallel.sharding.spec_for` returns) -> one placement per mesh axis."""
    by_axis = {}
    for d, entry in enumerate(tuple(spec or ())):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                by_axis[ax] = Shard(d)
    return tuple(by_axis.get(ax, Replicate()) for ax in mesh.axis_names)


class DTensor:
    """A tensor laid out over a mesh as its ranks' stacked local tensors.

    `_local` is (*stack_shape(mesh, placements), *local_shape); see the
    module docstring."""

    def __init__(self, local: torch.Tensor, mesh: DeviceMesh, placements):
        self._mesh = mesh
        self._placements = _normalize(placements, mesh, ndim=local.dim() - len(mesh.shape))
        want = stack_shape(mesh, self._placements)
        if tuple(local.shape[:len(want)]) != want:
            raise ValueError(f"local stack dims {tuple(local.shape[:len(want)])} != {want} "
                             f"for placements {self._placements}")
        self._local = local

    # -- introspection -----------------------------------------------------
    @property
    def device_mesh(self) -> DeviceMesh:
        return self._mesh

    @property
    def placements(self) -> Tuple:
        return self._placements

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The shape of one rank's local tensor."""
        return tuple(self._local.shape[len(self._mesh.shape):])

    @property
    def shape(self) -> Tuple[int, ...]:
        shape = list(self.local_shape)
        for p, n in zip(self._placements, self._mesh.shape):
            if isinstance(p, Shard):
                shape[p.dim] *= n
        return tuple(shape)

    @property
    def dtype(self):
        return self._local.dtype

    @property
    def device(self):
        return self._local.device

    def __repr__(self):
        return (f"DTensor(shape={self.shape}, placements={self._placements}, "
                f"mesh={self._mesh.axis_names}x{self._mesh.shape})")

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_local(local, mesh: DeviceMesh, placements) -> "DTensor":
        """Driver-mode `DTensor.from_local`: `local` carries one leading stack
        dim per non-Replicate placement, in mesh-axis order (the
        reference's convention): e.g. mesh ("dp",) of 8 with (Shard(0),) on
        a global (32, d) tensor: local is (8, 4, d)."""
        local = torch.as_tensor(local)
        n_stacks = sum(not isinstance(p, Replicate) for p in placements)
        placements = _normalize(placements, mesh, ndim=local.dim() - n_stacks)
        i = 0
        for p, n in zip(placements, mesh.shape):
            if isinstance(p, Replicate):
                local = local.unsqueeze(i)
            elif local.shape[i] != n:
                raise ValueError(f"stack dim {i} has size {local.shape[i]}, expected {n}")
            i += 1
        return DTensor(local, mesh, placements)

    # -- materialization ---------------------------------------------------
    def rank_local(self, index: Sequence[int]) -> torch.Tensor:
        """The local tensor of the rank at mesh position `index`."""
        idx = tuple(0 if isinstance(p, Replicate) else i
                    for p, i in zip(self._placements, index))
        return self._local[idx]

    def to_local(self):
        """The reference's driver-mode `to_local`: the pending addends (one
        leading dim per Partial axis) when some placement is Partial; the
        global value when all are Replicate; else every rank's shard, in
        flat mesh order (c10d rank order)."""
        partial = any(isinstance(p, Partial) for p in self._placements)
        if partial:
            if any(isinstance(p, Shard) for p in self._placements):
                raise ValueError("to_local() with mixed Shard + pending Partial placements is "
                                 "ambiguous; redistribute() first")
            keep = [i for i, p in enumerate(self._placements) if isinstance(p, Partial)]
            drop = [i for i in range(len(self._placements)) if i not in keep]
            return self._local.squeeze(drop) if drop else self._local
        if all(isinstance(p, Replicate) for p in self._placements):
            return self._local.reshape(self.local_shape)
        return [self.rank_local(idx) for idx in _positions(self._mesh.shape)]

    def full_tensor(self) -> torch.Tensor:
        """The global value (torch `full_tensor`): Partial addends reduced,
        shards concatenated. Differentiable."""
        a = self._local
        nstack = len(self._mesh.shape)
        # reduce the Partial axes, then join the Shard axes, last axis first
        for i in reversed(range(nstack)):
            p = self._placements[i]
            if isinstance(p, Partial):
                a = fold(p.reduce_op)(a.movedim(i, 0)).unsqueeze(i)
        for i in reversed(range(nstack)):
            p = self._placements[i]
            if isinstance(p, Shard):
                a = torch.cat(a.unbind(i), dim=nstack - 1 + p.dim).unsqueeze(i)
        return a.reshape(self.shape)

    def to_global(self) -> torch.Tensor:
        """The global value; refuses pending Partial reductions."""
        if any(isinstance(p, Partial) for p in self._placements):
            raise ValueError("DTensor has pending Partial reductions; redistribute first")
        return self.full_tensor()

    def redistribute(self, placements) -> "DTensor":
        """Change placements (the value is kept)."""
        placements = _normalize(placements, self._mesh, ndim=len(self.shape))
        if any(isinstance(p, Partial) for p in placements):
            raise NotImplementedError("redistribute TO Partial is not supported (torch keeps "
                                      "this internal to op dispatch as well)")
        return distribute_tensor(self.full_tensor(), self._mesh, placements)

    # -- arithmetic on the global values -----------------------------------
    def _binop(self, other, fn):
        if isinstance(other, DTensor):
            if other._mesh != self._mesh:
                raise ValueError("cross-mesh DTensor ops are not defined")
            other = other.to_global()
        out = fn(self.to_global(), other)
        keep = tuple(out.shape) == self.shape and not any(
            isinstance(p, Partial) for p in self._placements)
        placements = self._placements if keep else [Replicate()] * len(self._mesh.shape)
        return distribute_tensor(out, self._mesh, placements)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __matmul__(self, o):
        return self._binop(o, lambda a, b: a @ b)

    def sum(self, axis=None):
        return self._binop(None, lambda a, _: a.sum() if axis is None else a.sum(axis))


def _positions(shape):
    """Every mesh position in row-major (flat rank) order."""
    for r in range(math.prod(shape)):
        idx = []
        for n in reversed(shape):
            idx.append(r % n)
            r //= n
        yield tuple(reversed(idx))


def distribute_tensor(tensor, device_mesh: DeviceMesh, placements) -> DTensor:
    """torch `distribute_tensor`: lay a full tensor out over the mesh.
    Differentiable; the result lives on the tensor's device."""
    mesh = device_mesh
    t = torch.as_tensor(tensor)
    placements = _normalize(placements, mesh, ndim=t.dim())
    if any(isinstance(p, Partial) for p in placements):
        raise ValueError("distribute_tensor cannot create Partial placements from a full "
                         "tensor (torch raises here too); use DTensor.from_local")
    a = t
    for ax, p, n in zip(mesh.axis_names, placements, mesh.shape):
        if isinstance(p, Shard) and t.shape[p.dim] % n:
            raise ValueError(f"dim {p.dim} of size {t.shape[p.dim]} not divisible by mesh "
                             f"axis {ax!r} size {n}")
    nstack = len(mesh.shape)
    a = a.reshape((1,) * nstack + tuple(t.shape))
    for i, (p, n) in enumerate(zip(placements, mesh.shape)):
        if isinstance(p, Shard):
            a = torch.stack(a.squeeze(i).chunk(n, dim=nstack - 1 + p.dim), dim=i)
    # a copy of its own, as torch's: a replicated layout would otherwise
    # alias `tensor`, and an update of the DTensor would write through
    if not any(isinstance(p, Shard) for p in placements):
        a = a.clone()
    return DTensor(a.contiguous(), mesh, placements)


def distribute_module(params, device_mesh: DeviceMesh,
                      partition_fn: Optional[Callable[[str, Any], Sequence[Placement]]] = None
                      ) -> Dict[str, DTensor]:
    """torch `distribute_module` over named params (a module's, or a
    mapping of name -> tensor): `partition_fn(name, tensor) -> placements`
    for each (None: Replicate everywhere). Returns name -> DTensor;
    `unwrap_module` gives back the global tensors."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    mesh = device_mesh
    out = {}
    for name, leaf in params.items():
        placements = (partition_fn(name, leaf) if partition_fn is not None
                      else [Replicate()] * len(mesh.shape))
        out[name] = distribute_tensor(leaf.detach(), mesh, placements)
    return out


def unwrap_module(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """name -> DTensor (or tensor) -> name -> global tensor."""
    return {k: v.to_global() if isinstance(v, DTensor) else v for k, v in tree.items()}
