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
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch


def visible_devices() -> List[torch.device]:
    """One entry per visible CUDA card; empty without a card."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class DeviceMesh:
    """Named N-D mesh of `torch.device`s, stored flat in row-major order."""

    def __init__(self, devices: Sequence, shape: Sequence[int], axis_names: Tuple[str, ...]):
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
        )

    def __hash__(self):
        return hash((self._axis_names, tuple(str(d) for d in self._devices), self._shape))

    def __repr__(self):
        return f"DeviceMesh(shape={dict(zip(self._axis_names, self._shape))}, device={self.device})"

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


def init_device_mesh(
    axis_names: Sequence[str] = ("dp",),
    mesh_shape: Optional[Sequence[int]] = None,
    *,
    devices=None,
) -> DeviceMesh:
    """Build a DeviceMesh, by default over every visible card (one rank per
    card; the shape the reference's DDP world corresponds to). Raises
    without a card unless `devices` is given."""
    devs = list(devices) if devices is not None else visible_devices()
    if not devs:
        raise RuntimeError("no CUDA device: pass devices= (e.g. ['cpu'] * world) to run on the CPU")
    if mesh_shape is None:
        mesh_shape = [len(devs)] + [1] * (len(axis_names) - 1)
    return DeviceMesh(devs, mesh_shape, tuple(axis_names))
