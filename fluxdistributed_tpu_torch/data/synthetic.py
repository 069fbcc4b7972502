"""Synthetic image batches and token sequences for training, smoke
runs and benchmarks.

A copy of ``fluxdistributed_tpu/data/synthetic.py`` (numpy only): the
same seed and the same ``rng`` give the same images, labels and tokens
as the JAX package's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticDataset", "SyntheticTextDataset"]


class SyntheticDataset:
    """Deterministic, learnable fake image classification data: each
    class has its own template image (drawn from ``seed``), and a sample
    is its class's template plus Gaussian ``noise``, so a model that
    learns the templates drives the loss down.

    ``nsamples`` labels are drawn once (the sample table);
    ``batch(rng, n, indices=None) -> (images [n, H, W, C] f32, labels [n]
    int32)`` samples the table with replacement, or takes ``indices``.
    Each batch draws ``n * H * W * C`` normals on the host.
    """

    def __init__(self, nsamples: int = 1024, nclasses: int = 10,
                 shape: tuple = (32, 32, 3), seed: int = 0,
                 noise: float = 0.3):
        self.nsamples = nsamples
        self.nclasses = nclasses
        self.shape = shape
        self.noise = noise
        root = np.random.default_rng(seed)
        self.templates = root.normal(0.0, 1.0, size=(nclasses, *shape)).astype(
            np.float32)
        self.labels_table = root.integers(0, nclasses, size=nsamples).astype(
            np.int32)

    def __len__(self) -> int:
        return self.nsamples

    def batch(self, rng: np.random.Generator, n: int, indices=None):
        if indices is None:
            indices = rng.integers(0, self.nsamples, size=n)
        labels = self.labels_table[np.asarray(indices)]
        imgs = self.templates[labels] + rng.normal(
            0.0, self.noise, size=(len(labels), *self.shape)).astype(
                np.float32)
        return imgs.astype(np.float32), labels


class SyntheticTextDataset:
    """Deterministic, learnable fake token sequences for LM training.

    Sequences are drawn from a fixed low-entropy order-1 Markov chain:
    from each token, one successor has probability ``peak`` and the rest
    share the remainder.  An LM that learns the transition table drives
    next-token loss from ln(vocab) down toward the chain's conditional
    entropy — so "loss falls well below uniform" is a real learning
    signal, not memorization of a fixed batch.

    Protocol: ``batch(rng, n) -> tokens [n, seqlen] int32`` (each draw
    generates fresh sequences from the chain).  The transition tables
    are dense float64 [vocab, vocab]: about 24 GB of host memory at
    vocab 32000.
    """

    def __init__(
        self,
        vocab: int = 64,
        seqlen: int = 64,
        seed: int = 0,
        peak: float = 0.9,
    ):
        self.vocab = vocab
        self.seqlen = seqlen
        root = np.random.default_rng(seed)
        succ = root.permutation(vocab)  # the high-probability successor map
        probs = np.full((vocab, vocab), (1.0 - peak) / (vocab - 1), np.float64)
        probs[np.arange(vocab), succ] = peak
        self.transition = probs / probs.sum(axis=1, keepdims=True)
        self.cum = np.cumsum(self.transition, axis=1)

    def batch(self, rng: np.random.Generator, n: int):
        toks = np.empty((n, self.seqlen), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=n)
        u = rng.random((n, self.seqlen - 1))
        for t in range(1, self.seqlen):
            # inverse-CDF draw from each row's current-token distribution;
            # clip guards the fp edge where u >= cum[-1] (~1 - 1e-16)
            # would index one past the last token
            toks[:, t] = np.minimum(
                (self.cum[toks[:, t - 1]] < u[:, t - 1 : t]).sum(axis=1),
                self.vocab - 1,
            )
        return toks
