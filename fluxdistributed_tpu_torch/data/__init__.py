"""The data path: image and token datasets, the ImageNet reader with
its decode and preprocessing (PIL, or the native C++ library), the
dataset sources and registry, and the prefetching loader."""

from .cifar import CIFAR10Dataset
from .imagenet import (ImageNetDataset, LabelTable, SampleTable, labels,
                       makepaths, relpath, train_solutions)
from .loader import PrefetchLoader, apply_transform, batch_to_dict
from .preprocess import preprocess
from .registry import (DRIVERS, driver_of, load_registry, open_dataset,
                       register_dataset)
from .sources import (FileSource, GCSSource, HTTPSource, fetch_artifact,
                      fetch_checkpoint, make_source)
from .synthetic import SyntheticDataset, SyntheticTextDataset
from .text import ByteTextDataset

__all__ = ["ByteTextDataset", "CIFAR10Dataset", "DRIVERS", "FileSource",
           "GCSSource", "HTTPSource", "ImageNetDataset", "LabelTable",
           "PrefetchLoader", "SampleTable", "SyntheticDataset",
           "SyntheticTextDataset", "apply_transform", "batch_to_dict",
           "driver_of", "fetch_artifact", "fetch_checkpoint", "labels",
           "load_registry", "make_source", "makepaths", "open_dataset",
           "preprocess", "register_dataset", "relpath", "train_solutions"]
