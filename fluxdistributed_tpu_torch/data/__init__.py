"""The LM data path: token datasets and the prefetching loader."""

from .loader import PrefetchLoader, batch_to_dict
from .synthetic import SyntheticTextDataset
from .text import ByteTextDataset

__all__ = ["ByteTextDataset", "PrefetchLoader", "SyntheticTextDataset",
           "batch_to_dict"]
