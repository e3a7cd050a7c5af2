"""Backend registry.

Parity surface: torch c10d `Backend` registry + third-party plugin seam
`Backend.register_backend(name, creator_fn, devices)` — torch
`distributed_c10d.py:270,341-407` and unknown-backend dispatch `:2240-2262`
(the reference's `backends/__init__.py`).

The reference's names stay, so its launch recipes run unchanged: `"xla"`
(the default), `"gloo"` and `"nccl"` all name the port's collective
backend, and `"fake"` the no-communication one. In driver mode that
backend is `StackedBackend` (collectives over a rank-stacked tensor). In
multiproc mode `create_backend` swaps in `ProcessBackend` over the
group's torch.distributed group, whose transport follows the group's
device: gloo for the CPU, nccl for CUDA.
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import Backend, BackendError
from .fake import FakeBackend
from .process import ProcessBackend
from .stacked import StackedBackend

_registry: Dict[str, Callable] = {}

default_device_backend_map: Dict[str, str] = {
    "cuda": "nccl",
    "cpu": "gloo",
}

UNDEFINED = "undefined"
XLA = "xla"
FAKE = "fake"


def register_backend(name: str, creator: Callable, *, devices=None, overwrite: bool = False) -> None:
    """Register a third-party backend (torch `distributed_c10d.py:341-407`).

    `creator(mesh, rank, world_size, timeout) -> Backend`.
    """
    name = name.lower()
    if name in _registry and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _registry[name] = creator
    if devices:
        for d in devices if isinstance(devices, (list, tuple)) else [devices]:
            default_device_backend_map[d] = name


def backend_registered(name: str) -> bool:
    return name.lower() in _registry


def creator_of(name: str) -> Callable:
    """The registered creator of `name`; BackendError listing the registry
    if there is none."""
    name = (name or XLA).lower()
    creator = _registry.get(name)
    if creator is None:
        raise BackendError(
            f"unknown backend {name!r}; registered: {sorted(_registry)}"
        )
    return creator


def create_backend(name: str, mesh, rank: int, world_size: int, timeout: float,
                   torch_group=None) -> Backend:
    """The backend `name` over `mesh`. With a torch.distributed group
    (multiproc mode), the built-in collective backend becomes a
    `ProcessBackend` over it; any other creator is called as registered."""
    creator = creator_of(name)
    if torch_group is not None and creator is StackedBackend:
        return ProcessBackend(mesh, rank, world_size, timeout, torch_group)
    return creator(mesh, rank, world_size, timeout)


register_backend(XLA, StackedBackend)
register_backend(FAKE, FakeBackend)
# the reference's launch names: `--backend gloo` / `--backend nccl` run the
# same collective backend (the transport follows the device in multiproc)
register_backend("gloo", StackedBackend)
register_backend("nccl", StackedBackend)

__all__ = [
    "Backend",
    "BackendError",
    "FakeBackend",
    "ProcessBackend",
    "StackedBackend",
    "register_backend",
    "backend_registered",
    "creator_of",
    "create_backend",
    "default_device_backend_map",
]
