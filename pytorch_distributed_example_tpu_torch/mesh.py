"""DeviceMesh — the framework's device topology object.

Parity surface: torch `torch/distributed/device_mesh.py` (the reference's
`mesh.py`): an N-D arrangement of devices with named axes, rank
bookkeeping (global rank = flat index), sub-mesh slicing for `new_group`,
and the flattened 1-D view a process group runs over.

The port's devices are `torch.device`s. torch has no virtual devices, so
one device may fill several slots: in driver mode the W ranks of a group
are stacked in one tensor on one device, and the mesh holds that device W
times (W ranks on `cuda:0`, or on the CPU in tests). In multiproc mode
each process holds its own device in every slot it knows of.

A multiproc mesh (`init_device_mesh` once the process group is up in
multiproc mode, or `DeviceMesh.from_group`) also knows this process's
coordinate along each axis and holds one process group per axis: the
ranks that differ from this process in that coordinate alone. Code that
runs over a mesh enters it (`with mesh:`), as a `shard_map` body runs
over its mesh: inside, `axis_binding(name)` resolves an axis name to
(group, this process's index, axis size), and the rank-stacked programs
hold one row (a dim of size 1) where driver mode holds the axis's W.
"""

from __future__ import annotations

import itertools
import math
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

# the meshes entered (`with mesh:`), innermost last. One list for the
# process, not a thread's: autograd runs a CUDA backward on its own
# thread, and a recomputed forward there resolves the same axes
_ACTIVE: List["DeviceMesh"] = []


class AxisBinding(NamedTuple):
    """A mesh axis as multiproc code sees it: the axis's process group,
    this process's index along it and the axis's size."""

    name: str
    group: Any
    index: int
    size: int


def visible_devices() -> List[torch.device]:
    """One entry per visible CUDA card; empty without a card."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeviceMesh:
    """Named N-D mesh of `torch.device`s, stored flat in row-major order."""

    def __init__(self, devices: Sequence, shape: Sequence[int], axis_names: Tuple[str, ...],
                 *, coordinate: Optional[Sequence[int]] = None,
                 groups: Optional[Dict[str, Any]] = None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(
                f"mesh ndim {len(shape)} != len(axis_names) {len(axis_names)}"
            )
        devices = [torch.device(d) for d in devices]
        if math.prod(shape) != len(devices):
            raise ValueError(f"mesh_shape {shape} does not cover {len(devices)} devices")
        self._devices = devices
        self._shape = shape
        self._axis_names = tuple(axis_names)
        self._coordinate = None if coordinate is None else tuple(int(c) for c in coordinate)
        self._groups = dict(groups or {})
        if self._coordinate is not None and (
                len(self._coordinate) != len(shape) or set(self._groups) != set(axis_names)):
            raise ValueError("a multiproc mesh needs a coordinate and a group per axis")

    # -- basic topology ----------------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self._axis_names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def size(self) -> int:
        return len(self._devices)

    def axis_size(self, name: str) -> int:
        return self._shape[self._axis_names.index(name)]

    # -- multiproc ---------------------------------------------------------
    @property
    def multiproc(self) -> bool:
        """One process a rank: this process holds one coordinate."""
        return self._coordinate is not None

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The rank dims this process's stacked tensors hold: the mesh's
        shape in driver mode, all 1 in multiproc mode."""
        return (1,) * len(self._shape) if self.multiproc else self._shape

    def local_size(self, name: str) -> int:
        return self.local_shape[self._axis_names.index(name)]

    def get_coordinate(self) -> Optional[Tuple[int, ...]]:
        """This process's position in the mesh (torch's); None in driver
        mode, where the process holds every position."""
        return self._coordinate

    def axis_index(self, name: str) -> Optional[int]:
        return None if self._coordinate is None else self._coordinate[
            self._axis_names.index(name)]

    def flat_index(self, names: Sequence[str]) -> int:
        """This process's coordinate over the axes `names` as one index,
        the first axis major (multiproc)."""
        d = 0
        for name in names:
            d = d * self.axis_size(name) + self.axis_index(name)
        return d

    def get_group(self, name: str):
        """The process group over axis `name` (multiproc), else None."""
        return self._groups.get(name)

    def binding(self, name: str) -> Optional[AxisBinding]:
        if not self.multiproc or name not in self._axis_names:
            return None
        return AxisBinding(name, self._groups[name], self.axis_index(name),
                           self.axis_size(name))

    def __enter__(self) -> "DeviceMesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        for i in reversed(range(len(_ACTIVE))):
            if _ACTIVE[i] is self:
                del _ACTIVE[i]
                return

    @staticmethod
    def from_group(group, axis_name: str = "_ranks") -> "DeviceMesh":
        """The 1-D mesh over a process group's ranks (torch's
        `DeviceMesh.from_group`): multiproc when the group is."""
        n, dev = group.size(), group.device
        if getattr(group, "torch_group", None) is None:
            return DeviceMesh([dev] * n, (n,), (axis_name,))
        return DeviceMesh([dev] * n, (n,), (axis_name,), coordinate=(group.rank(),),
                          groups={axis_name: group})

    def device_list(self) -> List[torch.device]:
        return list(self._devices)

    @property
    def device(self) -> torch.device:
        """The device a rank-stacked tensor of this mesh lives on: its first
        slot (driver mode fills every slot with it)."""
        return self._devices[0]

    def __eq__(self, other):
        return (
            isinstance(other, DeviceMesh)
            and self._axis_names == other._axis_names
            and self._devices == other._devices
            and self._shape == other._shape
            and self._coordinate == other._coordinate
        )

    def __hash__(self):
        return hash((self._axis_names, tuple(str(d) for d in self._devices), self._shape,
                     self._coordinate))

    def __repr__(self):
        where = "" if self._coordinate is None else f", coordinate={self._coordinate}"
        return (f"DeviceMesh(shape={dict(zip(self._axis_names, self._shape))}, "
                f"device={self.device}{where})")

    # -- slicing (new_group substrate) -------------------------------------
    def submesh(self, indices: Sequence[int], axis_name: Optional[str] = None) -> "DeviceMesh":
        """1-D sub-mesh over the given flat ranks (device order preserved)."""
        sel = [self._devices[i] for i in indices]
        return DeviceMesh(sel, (len(sel),), (axis_name or "_ranks",))

    def flattened(self, axis_name: str = "_ranks") -> "DeviceMesh":
        """All devices as one 1-D axis (the default world group's layout)."""
        if len(self._shape) == 1 and self._axis_names == (axis_name,):
            return self
        return DeviceMesh(self._devices, (self.size,), (axis_name,))


def axis_binding(name: str) -> Optional[AxisBinding]:
    """Axis `name` of the innermost entered mesh that has it, when that
    mesh is multiproc; None otherwise (driver mode: the fold)."""
    for mesh in reversed(_ACTIVE):
        if name in mesh.axis_names:
            return mesh.binding(name)
    return None


def scope() -> Tuple["DeviceMesh", ...]:
    """The entered meshes, for `restored` to re-enter them later (an
    autograd backward, which runs after the forward's `with` has ended)."""
    return tuple(_ACTIVE)


@contextmanager
def restored(meshes: Sequence["DeviceMesh"]):
    """Enter `meshes` (a `scope()`), innermost last, for the block."""
    n = len(_ACTIVE)
    _ACTIVE.extend(meshes)
    try:
        yield
    finally:
        del _ACTIVE[n:]


def _multiproc_mesh(axis_names: Tuple[str, ...], shape: Tuple[int, ...]) -> DeviceMesh:
    """The mesh over this gang's processes: global rank = flat index. Every
    process builds every axis's groups, in the same order (`new_group` is
    collective)."""
    from . import distributed as dist

    world = dist._get_default_group()
    if math.prod(shape) != world.size():
        raise ValueError(f"mesh_shape {shape} does not cover the gang's {world.size()} ranks")
    me = dist.get_rank()
    coord, r = [], me
    for n in reversed(shape):
        coord.append(r % n)
        r //= n
    coord = tuple(reversed(coord))
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups = {}
    for a, (name, n) in enumerate(zip(axis_names, shape)):
        others = [range(m) for m in shape[:a] + shape[a + 1:]]
        for rest in itertools.product(*others):
            pos = list(rest[:a]) + [0] + list(rest[a:])
            base = sum(p * s for p, s in zip(pos, strides))
            ranks = [base + i * strides[a] for i in range(n)]
            g = dist.new_group(ranks)
            if me in ranks:
                groups[name] = g
    return DeviceMesh([world.device] * world.size(), shape, axis_names, coordinate=coord,
                      groups=groups)


def init_device_mesh(
    axis_names: Sequence[str] = ("dp",),
    mesh_shape: Optional[Sequence[int]] = None,
    *,
    devices=None,
) -> DeviceMesh:
    """Build a DeviceMesh, by default over every visible card (one rank per
    card; the shape the reference's DDP world corresponds to). Raises
    without a card unless `devices` is given.

    Once the process group is up in multiproc mode, a call without
    `devices` builds the multiproc mesh over the gang (every process calls
    it, as torch's): `mesh_shape` must cover the world, each process holds
    its own coordinate, and each axis gets its process group."""
    if devices is None:
        from . import distributed as dist

        if dist.is_initialized() and dist._world.mode == "multiproc":
            shape = tuple(mesh_shape) if mesh_shape is not None else (
                (dist.get_world_size(),) + (1,) * (len(axis_names) - 1))
            return _multiproc_mesh(tuple(axis_names), tuple(int(n) for n in shape))
    devs = list(devices) if devices is not None else visible_devices()
    if not devs:
        raise RuntimeError("no CUDA device: pass devices= (e.g. ['cpu'] * world) to run on the CPU")
    if mesh_shape is None:
        mesh_shape = [len(devs)] + [1] * (len(axis_names) - 1)
    return DeviceMesh(devs, mesh_shape, tuple(axis_names))
