"""Dataset combinators — `torch.utils.data` staples.

A copy of the reference's `data/dataset.py`. `TensorDataset`, `Subset`,
`ConcatDataset`, `random_split`: the dataset algebra users wrap around
`DistributedSampler` + `DataLoader`. All support BATCH indexing with an
integer array (the convention `loader.py` uses: `dataset[np.array([...])]`
returns stacked columns), which keeps batch assembly one fancy-index per
column instead of a Python loop per sample.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class TensorDataset:
    """Column-stacked arrays; `ds[i]` -> tuple of rows (torch
    `TensorDataset`)."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError(
                    f"size mismatch: {[len(x) for x in arrays]}"
                )
        self.arrays = tuple(np.asarray(a) for a in arrays)

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)


class Subset:
    """A view of `dataset` at `indices` (torch `Subset`)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]


class ConcatDataset:
    """Datasets chained end-to-end (torch `ConcatDataset`). Batch
    indexing gathers per source then restitches in request order."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("need at least one dataset")
        self.cumsizes = np.cumsum([len(d) for d in self.datasets])
        if self.cumsizes[-1] == 0:
            raise ValueError("all source datasets are empty")
        # validate shapes and fix the promoted dtype per column ONCE, so
        # batch dtype/shape cannot vary with which sources a batch hits.
        # Probe one SCALAR row per non-empty source (empty members are
        # legal — they contribute no rows — and lazy sources pay one read)
        probes = [d[0] for d in self.datasets if len(d) > 0]
        ncols = {len(p) for p in probes}
        if len(ncols) > 1:
            raise ValueError(f"column counts differ across datasets: {ncols}")
        self._col_shapes, self._col_dtypes = [], []
        for c in range(ncols.pop()):
            shapes = {np.asarray(p[c]).shape for p in probes}
            if len(shapes) > 1:
                raise ValueError(
                    f"column {c} row shapes differ across datasets: {shapes}"
                )
            self._col_shapes.append(shapes.pop())
            self._col_dtypes.append(
                np.result_type(*[np.asarray(p[c]).dtype for p in probes])
            )

    def __len__(self) -> int:
        return int(self.cumsizes[-1])

    def _locate(self, i):
        ds = int(np.searchsorted(self.cumsizes, i, side="right"))
        prev = 0 if ds == 0 else int(self.cumsizes[ds - 1])
        return ds, i - prev

    def __getitem__(self, idx):
        n = len(self)
        if np.ndim(idx) == 0:
            i = int(idx)
            if i < -n or i >= n:
                raise IndexError(f"index {i} out of range for size {n}")
            ds, local = self._locate(i + n if i < 0 else i)
            return self.datasets[ds][local]
        idx = np.asarray(idx, dtype=np.intp)
        if len(idx) > 0:
            if ((idx < -n) | (idx >= n)).any():
                raise IndexError(f"index out of range for size {n}")
            idx = np.where(idx < 0, idx + n, idx)  # torch-style negatives
        # allocate with the construction-time shapes/dtypes: stable
        # output regardless of which sources this batch touches
        cols = [
            np.empty((len(idx),) + s, d)
            for s, d in zip(self._col_shapes, self._col_dtypes)
        ]
        which = np.searchsorted(self.cumsizes, idx, side="right")
        for ds in np.unique(which):
            sel = np.nonzero(which == ds)[0]
            prev = 0 if ds == 0 else int(self.cumsizes[ds - 1])
            rows = self.datasets[ds][idx[sel] - prev]
            for out_col, col in zip(cols, rows):
                out_col[sel] = col  # one vectorized scatter per source
        return tuple(cols)


def random_split(dataset, lengths: Sequence[int], seed: int = 0):
    """Split into non-overlapping `Subset`s (torch `random_split`; takes
    a seed instead of a torch.Generator)."""
    total = sum(lengths)
    if total != len(dataset):
        raise ValueError(
            f"lengths sum to {total}, dataset has {len(dataset)}"
        )
    perm = np.random.default_rng(seed).permutation(len(dataset))
    out, start = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[start : start + n]))
        start += n
    return out
