"""Data feeding helpers (counterpart of ``singa_tpu/data.py``; the
reference's ``python/singa/data.py``): the in-memory batch iterator of the
reference examples and a seeded train/test split, numpy in and out.  The
BinFile datasets with threaded prefetch are ``singa_tpu_torch.io.loader``."""

from __future__ import annotations

import numpy as np


class ImageBatchIter:
    """Iterate (x_batch, y_batch) over in-memory arrays with optional
    shuffling and an augmentation callback."""

    def __init__(self, x, y, batch_size, shuffle=True, augment=None, seed=0):
        assert len(x) == len(y)
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.x) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.x))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            xb, yb = self.x[idx], self.y[idx]
            if self.augment is not None:
                xb = np.stack([self.augment(v) for v in xb])
            yield xb, yb


def train_test_split(x, y, test_frac=0.2, seed=0):
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(x))
    n_test = int(len(x) * test_frac)
    te, tr = order[:n_test], order[n_test:]
    return (x[tr], y[tr]), (x[te], y[te])
