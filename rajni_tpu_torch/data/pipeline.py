"""Synthetic data (port of ``rajni_tpu/data/pipeline.py:SyntheticLoader``;
the ImageFolder pipeline is not ported yet)."""

from __future__ import annotations

import numpy as np


class SyntheticLoader:
    """Deterministic in-memory loader of NHWC float32 images and int64
    labels, drawn once from ``seed`` and yielded ``num_batches`` times."""

    def __init__(
        self,
        num_batches: int = 8,
        batch_size: int = 256,
        img_size: int = 224,
        num_classes: int = 1000,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        self._images = rng.standard_normal(
            (batch_size, img_size, img_size, 3)
        ).astype(np.float32)
        self._labels = rng.integers(0, num_classes, batch_size).astype(np.int64)
        self.num_batches = num_batches
        self.batch_size = batch_size

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self):
        for _ in range(self.num_batches):
            yield self._images, self._labels
