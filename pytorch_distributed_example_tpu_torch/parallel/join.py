"""Join: uneven inputs across ranks, the port of the reference's
`parallel/join.py` (torch `torch/distributed/algorithms/join.py`:
`Joinable` `:44`, `Join` `:104`, and DDP's `_DDPJoinHook`).

When ranks hold unequal numbers of batches, the ones that run out early
must shadow the collectives of the ranks still training, contributing
zero gradient, so nobody deadlocks. In driver mode every step is one
program over all ranks, so no rank can hang, and the problem becomes one
of masking: exhausted ranks must add zero to the gradient mean and not
skew its divisor. `join_batches` pads the per-rank streams to the longest
and emits a per-sample weight; a weighted loss (`weighted_loss_fn`) then
gives torch-Join's numbers inside the step. The loss's cross-rank divisor
is `nn.functional.rank_all_reduce` of the weights inside the DDP step's
rank `vmap` (the reference's `psum` over its ranks). `Join` and
`Joinable` keep the torch API shape for code being ported.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch


class JoinHook:
    """Per-joinable shadow hooks (torch JoinHook)."""

    def main_hook(self) -> None: ...

    def post_hook(self, is_last_joiner: bool) -> None: ...


class Joinable:
    """torch `Joinable` (join.py:44) protocol."""

    def join_hook(self, **kwargs) -> JoinHook:
        return JoinHook()

    @property
    def join_device(self):
        return None

    @property
    def join_process_group(self):
        from .. import distributed as dist

        return dist._get_default_group()


class Join(contextlib.AbstractContextManager):
    """torch `Join` (join.py:104) context manager.

    In driver mode all ranks advance in lockstep inside one process, so
    there is nothing to shadow; the context validates its joinables and
    runs their post-hooks on exit."""

    def __init__(self, joinables: Sequence[Joinable], enable: bool = True, **kwargs):
        if not joinables:
            raise ValueError("Join expects at least one Joinable")
        self.joinables = list(joinables)
        self.enable = enable
        self._hooks: List[JoinHook] = []

    def __enter__(self):
        if self.enable:
            self._hooks = [j.join_hook() for j in self.joinables]
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.enable and exc_type is None:
            for i, h in enumerate(self._hooks):
                h.post_hook(is_last_joiner=(i == len(self._hooks) - 1))
        return False

    @staticmethod
    def notify_join_context(joinable: Joinable) -> None:
        """torch `Join.notify_join_context`: the per-iteration notice of the
        first joinable; nothing to do under lockstep ranks."""
        return None


def join_batches(
    per_rank_batches: Sequence[Sequence[Tuple[np.ndarray, np.ndarray]]],
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Pad uneven per-rank batch streams into global (x, y, weight) steps.

    `per_rank_batches[r]` is rank r's list of (x, y) batches (as from a
    per-rank DataLoader). Streams shorter than the longest are padded with
    zero-weighted repeats of their last batch: the exhausted rank "joins"
    and shadows the remaining steps with zero contribution, torch-Join's
    effect on the gradient all-reduce."""
    world = len(per_rank_batches)
    streams = [list(s) for s in per_rank_batches]
    if any(len(s) == 0 for s in streams):
        raise ValueError("every rank needs at least one batch to define shapes")
    longest = max(len(s) for s in streams)
    for step in range(longest):
        xs, ys, ws = [], [], []
        for r in range(world):
            s = streams[r]
            if step < len(s):
                x, y = s[step]
                w = np.ones((x.shape[0],), np.float32)
            else:
                x, y = s[-1]  # shadow batch: shapes right, weight zero
                w = np.zeros((x.shape[0],), np.float32)
            xs.append(x)
            ys.append(y)
            ws.append(w)
        yield np.concatenate(xs), np.concatenate(ys), np.concatenate(ws)


def weighted_loss_fn(loss_fn, world: int = 0):
    """Lift `loss_fn(logits, y) -> per-sample losses` into a join-aware
    weighted mean `(logits, y, w) -> loss`.

    With `world` 0 (the reference's form) the mean is local,
    sum(l*w) / max(sum(w), 1): exact when `join_batches`' weights are
    balanced over the ranks of a step. With `world` W, for a loss inside
    the DDP step's rank `vmap`, the divisor counts every rank's real
    samples: sum(l*w) / max(sum_ranks(sum(w)), 1) * W, whose mean over
    the W ranks is the mean over the real samples of all of them."""
    from ..nn.functional import rank_all_reduce

    def fn(logits, y, w):
        losses = loss_fn(logits, y)
        if not world:
            return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)
        return (losses * w).sum() / torch.clamp(rank_all_reduce(w.sum()), min=1.0) * world

    return fn
