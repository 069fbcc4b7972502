"""Loss functions: the JAX package's ``ops/losses.py`` on tensors.

Batch-major layout (batch x classes), as in the JAX package, and every
loss is a mean over the batch.  ``logitcrossentropy`` is the reference's
training loss (``Flux.Losses.logitcrossentropy``); its log-softmax runs
in float32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch

from .metrics import onehot

__all__ = ["crossentropy", "logitcrossentropy", "mse"]


def _targets(labels: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """One-hot f32 targets from integer ids [batch] or one-hot labels."""
    if labels.ndim == like.ndim - 1:
        return onehot(labels, like.shape[-1])
    return labels.float()


def logitcrossentropy(logits: torch.Tensor, labels: torch.Tensor,
                      label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross entropy on unnormalised logits, averaged over the batch.
    ``labels`` are one-hot (batch x classes) or integer ids (batch,);
    ``label_smoothing`` mixes the targets with the uniform distribution."""
    logits = logits.float()
    y = _targets(labels, logits)
    if label_smoothing > 0.0:
        y = y * (1.0 - label_smoothing) + label_smoothing / logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(y * logp, dim=-1))


def crossentropy(probs: torch.Tensor, labels: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Cross entropy on probabilities (after a softmax)."""
    y = _targets(labels, probs)
    return -torch.mean(torch.sum(y * torch.log(probs + eps), dim=-1))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))
