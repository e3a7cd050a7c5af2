"""Datasets for the loader parity tests, importable by spawned loader
workers (numpy only): every batch carries draws from numpy's global RNG,
which the workers seed per (epoch, worker), so two loaders that seed the
same way deliver the same bytes."""

import numpy as np


class RngDataset:
    def __init__(self, n=96):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        noise = np.random.rand(*idx.shape).astype(np.float32)
        return idx.astype(np.float32) * 2.0 + noise, idx.astype(np.int32)
