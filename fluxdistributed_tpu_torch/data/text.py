"""Byte-level text dataset: train the LM on any local file.

A copy of ``fluxdistributed_tpu/data/text.py:ByteTextDataset`` (numpy
only): a UTF-8/binary file is memory-mapped and batches are random
fixed-length byte windows, vocab = 256.  No tokenizer is needed for
byte-level modeling, and windows are drawn with replacement.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["ByteTextDataset"]


class ByteTextDataset:
    """Random ``seqlen``-byte windows over a memory-mapped file.

    Protocol: ``batch(rng, n) -> tokens [n, seqlen] int32`` (the
    loader's bare-array/token protocol); ``len(ds)`` is the number of
    non-overlapping windows, so ``epochs``-based cycle derivation works.
    """

    vocab = 256

    def __init__(self, path: str, seqlen: int = 256):
        self.path = os.fspath(path)
        self.seqlen = int(seqlen)
        size = os.path.getsize(self.path)
        if size < self.seqlen:
            raise ValueError(
                f"{self.path}: {size} bytes < seqlen ({self.seqlen}) — "
                "need at least one full window (the next-token shift happens "
                "inside the window, so no extra target byte is required)"
            )
        # mmap: no copy of the corpus per worker thread, OS page cache
        # shared across processes on a host
        self._data = np.memmap(self.path, dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        # non-overlapping full windows; the next-token shift is
        # intra-window, so no trailing target byte is reserved
        return len(self._data) // self.seqlen

    def batch(self, rng: np.random.Generator, n: int, indices=None) -> np.ndarray:
        """Random windows by default; ``indices`` selects the
        NON-OVERLAPPING windows ``indices[i]·seqlen`` (the ``len(self)``
        windows ``__len__`` counts) — the deterministic-coverage protocol
        ``train.evaluate`` uses for exact whole-corpus perplexity."""
        if indices is None:
            # inclusive upper bound: the last valid window start is
            # len - seqlen, so the corpus's final byte is reachable
            starts = rng.integers(0, len(self._data) - self.seqlen + 1, size=n)
        else:
            indices = np.asarray(indices)
            if (indices.max(initial=0) >= len(self)
                    or indices.min(initial=0) < 0):
                raise IndexError(
                    f"window indices must be in [0, {len(self)}); got "
                    f"[{int(indices.min())}, {int(indices.max())}]"
                )
            starts = indices * self.seqlen
        idx = starts[:, None] + np.arange(self.seqlen)[None, :]
        return self._data[idx].astype(np.int32)

    @staticmethod
    def decode(tokens) -> str:
        """Bytes → text (lossy on invalid UTF-8), for eyeballing samples."""
        return bytes(np.asarray(tokens, np.uint8)).decode("utf-8", errors="replace")
