"""Evaluation metrics: the JAX package's ``ops/metrics.py`` on tensors.

``topkaccuracy`` is the reference's top-k accuracy (k in {1, 5, 10} in
its eval).  ``torch.topk`` promises no order among equal scores, where
``lax.top_k`` returns the lower index first, so on rows with ties at
the k-th place the two packages may count a hit differently; on scores
without ties they agree.
"""

from __future__ import annotations

import torch

__all__ = ["onehot", "showpreds", "topkaccuracy"]


def onehot(labels: torch.Tensor, nclasses: int) -> torch.Tensor:
    """f32 one-hot rows of integer ``labels`` (an id outside
    ``[0, nclasses)`` gives a row of zeros, as ``jax.nn.one_hot`` does)."""
    classes = torch.arange(nclasses, device=labels.device)
    return (labels[..., None] == classes).float()


def topkaccuracy(scores: torch.Tensor, labels: torch.Tensor,
                 k: int = 5) -> torch.Tensor:
    """Fraction of rows whose true class is among the ``k`` highest
    ``scores`` (batch x classes; logits or probabilities).  ``labels``
    are one-hot or integer ids; ``k`` is clipped to the class count."""
    if labels.ndim == scores.ndim:
        labels = torch.argmax(labels, dim=-1)
    k = min(k, scores.shape[-1])
    idx = torch.topk(scores, k, dim=-1).indices
    hits = torch.any(idx == labels[:, None], dim=-1)
    return torch.mean(hits.float())


def showpreds(logits, class_names=None, k: int = 3, names=None) -> str:
    """The top-``k`` predictions of each row as a table: softmax
    probabilities beside the class names (``class_names``, else
    ``class i``), one block per row (named by ``names``, else
    ``sample i``)."""
    logits = torch.as_tensor(logits).detach().float().cpu()
    probs = torch.softmax(logits, dim=-1).numpy()
    k = min(k, logits.shape[-1])
    lines = []
    for i in range(logits.shape[0]):
        order = (-probs[i]).argsort(kind="stable")[:k]
        lines.append(f"{names[i] if names is not None else f'sample {i}'}:")
        for rank, c in enumerate(order, 1):
            label = class_names[c] if class_names is not None else f"class {c}"
            lines.append(f"  {rank}. {label:<40s} {probs[i, c]:7.4f}")
    return "\n".join(lines)
