"""DistTensor — a group's per-rank tensors as one rank-stacked torch tensor.

The port's answer to the reference's `tensor.py`. In torch c10d each
process owns one rank's tensor. In driver mode one process acts for every
rank of a group, so a DistTensor packs "rank r's tensor" for every r into
one tensor of shape `(world, *per_rank_shape)` on the group's device, and a
collective is a computation over dim 0 (`backends/stacked.py`). In
multiproc mode each process holds only its own row, a `(1, *shape)` tensor,
and collectives go through torch.distributed (`backends/process.py`).

The wrapper is *mutable* so the torch in-place idiom works:

    t = DistTensor.from_rank_fn(lambda r: torch.ones(4) * r)
    dist.all_reduce(t)      # t now holds the sum on every rank

Host copies (`numpy`, `local_numpy`, `unstack`, `rank_local`) return numpy
arrays; numpy has no bfloat16, so a bfloat16 tensor comes back as float32
(exactly: every bfloat16 value is a float32 value).
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class DistTensor:
    def __init__(self, tensor: torch.Tensor, group=None):
        self._tensor = tensor
        self._group = group

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_rank_fn(cls, fn: Callable[[int], Any], group=None) -> "DistTensor":
        """Build from a per-rank initializer: fn(rank) -> tensor or array.
        Multiproc mode calls it for this process's rank alone."""
        group = _resolve_group(group)
        if _multiproc():
            return cls.from_process_local(fn(group.rank()), group)
        vals = [_as_tensor(fn(r)) for r in range(group.size())]
        return cls.from_stacked(torch.stack(vals), group)

    @classmethod
    def from_stacked(cls, stacked, group=None) -> "DistTensor":
        """Build from a tensor or array whose leading axis indexes ranks.
        Multiproc mode keeps this process's row."""
        group = _resolve_group(group)
        stacked = _as_tensor(stacked)
        if stacked.shape[0] != group.size():
            raise ValueError(
                f"leading axis {stacked.shape[0]} != world size {group.size()}"
            )
        if _multiproc():
            me = group.rank()
            stacked = stacked[me : me + 1]
        return cls(stacked.to(group.device).contiguous(), group)

    @classmethod
    def from_process_local(cls, value, group=None) -> "DistTensor":
        """Build from THIS process's tensor — the c10d constructor shape.

        In multiproc mode the process contributes `value` as its own row.
        In driver mode the calling process acts for every rank, so the
        value is replicated — the same program then runs unchanged in
        either mode."""
        group = _resolve_group(group)
        v = _as_tensor(value)
        if not _multiproc():
            return cls.replicate(v, group)
        return cls(v.to(group.device)[None].contiguous(), group)

    @classmethod
    def replicate(cls, value, group=None) -> "DistTensor":
        """Same value on every rank (W separate rows, not a view)."""
        group = _resolve_group(group)
        v = _as_tensor(value).to(group.device)
        rows = 1 if _multiproc() else group.size()
        return cls(v[None].expand((rows,) + tuple(v.shape)).clone(), group)

    @classmethod
    def wrap(cls, tensor: torch.Tensor, group=None) -> "DistTensor":
        """Adopt an existing rank-stacked tensor (no copy)."""
        return cls(tensor, _resolve_group(group))

    # -- views -------------------------------------------------------------
    @property
    def tensor(self) -> torch.Tensor:
        """The device tensor: (world, *shape) in driver mode, (1, *shape)
        in multiproc mode."""
        return self._tensor

    @property
    def group(self):
        return self._group

    @property
    def shape(self):
        """Per-rank shape."""
        return tuple(self._tensor.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self._tensor.dtype

    @property
    def world_size(self) -> int:
        return self._group.size() if self._group is not None else self._tensor.shape[0]

    def numpy(self) -> np.ndarray:
        """Full (world, *shape) host copy.

        In multiproc mode this is a COLLECTIVE read (every process must
        call it: an all_gather of the rows); use `local_numpy()` for this
        process's row alone."""
        if _multiproc():
            gathered, _ = self._group.backend_impl.allgather(self._tensor)
            return _host(gathered[0])
        return _host(self._tensor)

    def local_numpy(self) -> np.ndarray:
        """This process's rank row(s), host copy — (n_local, *shape): every
        row in driver mode, one in multiproc mode."""
        return _host(self._tensor)

    def unstack(self) -> List[np.ndarray]:
        """Per-rank host copies — `[t_rank0, t_rank1, ...]`."""
        full = self.numpy()
        return [full[i] for i in range(full.shape[0])]

    def rank_local(self, rank: int) -> np.ndarray:
        return self.numpy()[rank]

    def block_until_ready(self) -> "DistTensor":
        """Wait for the tensor's pending work on the card."""
        if self._tensor.device.type == "cuda":
            torch.cuda.synchronize(self._tensor.device)
        return self

    # -- mutation (in-place collective support) ----------------------------
    def _set(self, new_tensor: torch.Tensor) -> None:
        self._tensor = new_tensor

    def __repr__(self):
        return (
            f"DistTensor(world={self.world_size}, shape={self.shape}, "
            f"dtype={self.dtype}, device={self._tensor.device})"
        )


def _multiproc() -> bool:
    from . import distributed as dist

    return dist._world.mode == "multiproc"


def _resolve_group(group):
    if group is not None:
        return group
    from . import distributed as dist

    return dist._get_default_group()
