"""DistributedSampler — deterministic per-rank dataset sharding.

A copy of the reference's `data/sampler.py`, whose semantics are torch's
`torch/utils/data/distributed.py:17-157`:
  - `num_replicas` defaults to the world size, `rank` to this process's
    rank, both read from the port's `distributed` (driver mode: the world
    size and rank 0)
  - `num_samples = ceil(len/num_replicas)` when not drop_last,
    `total_size = num_samples * num_replicas`
  - epoch-seeded shuffle: a generator seeded with `seed + epoch`
  - padding: indices repeated to reach `total_size`; drop_last truncates
  - rank-strided slice `indices[rank : total_size : num_replicas]`
  - `set_epoch()`: call it every epoch or the order repeats

The permutation is numpy's PCG64, not a torch generator, exactly as in the
reference: for every (seed, epoch, rank, world) the index stream is the
reference's, element for element.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sized

import numpy as np


class DistributedSampler:
    def __init__(
        self,
        dataset: Sized,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if num_replicas is None or rank is None:
            from .. import distributed as dist

            if num_replicas is None:
                num_replicas = dist.get_world_size()
                if num_replicas <= 0:
                    raise RuntimeError(
                        "Requires distributed package to be initialized or "
                        "explicit num_replicas"
                    )
            if rank is None:
                rank = dist.get_rank()
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"Invalid rank {rank}, rank should be in [0, {num_replicas - 1}]"
            )
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.drop_last = drop_last
        n = len(self.dataset)
        if self.drop_last and n % self.num_replicas != 0:
            self.num_samples = math.ceil((n - self.num_replicas) / self.num_replicas)
        else:
            self.num_samples = math.ceil(n / self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))

        if not self.drop_last:
            padding_size = self.total_size - len(indices)
            if padding_size <= len(indices):
                indices += indices[:padding_size]
            else:
                indices += (indices * math.ceil(padding_size / len(indices)))[
                    :padding_size
                ]
        else:
            indices = indices[: self.total_size]
        assert len(indices) == self.total_size

        indices = indices[self.rank : self.total_size : self.num_replicas]
        assert len(indices) == self.num_samples
        return iter(indices)

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
