"""Synthetic token sequences for LM training, smoke runs and benchmarks.

A copy of ``fluxdistributed_tpu/data/synthetic.py:SyntheticTextDataset``
(numpy only): the same seed and the same ``rng`` give the same tokens as
the JAX package's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticTextDataset"]


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
