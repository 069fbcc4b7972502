"""CIFAR-10 from its binary distribution: a copy of
``fluxdistributed_tpu/data/cifar.py`` (numpy only).

``data_batch_{1..5}.bin`` (train) or ``test_batch.bin`` (test): records
of one label byte and 3072 pixel bytes (CHW).  Images come out NHWC
float32, scaled to [0, 1] and normalised per channel by default.  The
dataset of the ResNet-34/CIFAR-10 configuration.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["CIFAR10_MEAN", "CIFAR10_STD", "CIFAR10Dataset"]

_RECORD = 3073
_TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
_TEST_FILES = ["test_batch.bin"]

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


class CIFAR10Dataset:
    """CIFAR-10 from the binaries at ``root`` (or its
    ``cifar-10-batches-bin/`` subdirectory); ``split`` is ``"train"`` or
    ``"test"``.  ``batch(rng, n, indices=None) -> (images [n, 32, 32, 3]
    f32, labels [n] int32)``, sampled with replacement unless
    ``indices`` are given."""

    nclasses = 10

    def __init__(self, root: str, split: str = "train",
                 normalize: bool = True):
        sub = os.path.join(root, "cifar-10-batches-bin")
        base = sub if os.path.isdir(sub) else root
        files = _TRAIN_FILES if split == "train" else _TEST_FILES
        paths = [os.path.join(base, f) for f in files]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                f"CIFAR-10 binaries not found: {missing[0]} (download the "
                "'binary version' archive and point path= at it)")
        raw = np.concatenate([np.fromfile(p, np.uint8).reshape(-1, _RECORD)
                              for p in paths])
        self.labels_table = raw[:, 0].astype(np.int32)
        imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        x = imgs.astype(np.float32) / 255.0
        if normalize:
            x = (x - CIFAR10_MEAN) / CIFAR10_STD
        self.images = x

    def __len__(self) -> int:
        return len(self.labels_table)

    def batch(self, rng: np.random.Generator, n: int, indices=None):
        if indices is None:
            indices = rng.integers(0, len(self), size=n)
        indices = np.asarray(indices)
        return self.images[indices], self.labels_table[indices]
