"""The data path: image and token datasets and the prefetching loader."""

from .cifar import CIFAR10Dataset
from .loader import PrefetchLoader, apply_transform, batch_to_dict
from .synthetic import SyntheticDataset, SyntheticTextDataset
from .text import ByteTextDataset

__all__ = ["ByteTextDataset", "CIFAR10Dataset", "PrefetchLoader",
           "SyntheticDataset", "SyntheticTextDataset", "apply_transform",
           "batch_to_dict"]
