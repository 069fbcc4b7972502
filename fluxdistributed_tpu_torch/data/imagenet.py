"""ImageNet (ILSVRC CLS-LOC) metadata parsing and sample loading: a copy
of ``fluxdistributed_tpu/data/imagenet.py`` (numpy only).

Replaces the reference's ImageNet data layer (src/imagenet.jl):

* ``labels``          — parse ``LOC_synset_mapping.txt`` into a label
                        table (:8-21);
* ``train_solutions`` — parse ``LOC_train_solution.csv`` into a sample
                        table with ``class_idx``, filtered to requested
                        classes (:58-75);
* ``makepaths``       — train/val file layout (:50-56);
* ``ImageNetDataset`` — with-replacement minibatch sampling (:23-26) +
                        threaded JPEG decode/preprocess into a
                        preallocated float32 batch (:28-48, one
                        ``Threads.@spawn`` per image → here a thread
                        pool), one-hot handled by the loader.

No pandas/DataFrames dependency — plain numpy arrays and dicts.
"""

from __future__ import annotations

import csv
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .preprocess import preprocess, sample_augment_params
from .sources import make_source

__all__ = [
    "LabelTable", "SampleTable", "labels", "train_solutions", "relpath",
    "makepaths", "ImageNetDataset",
]


@dataclass
class LabelTable:
    """wnid ↔ class-index ↔ human-readable names (``labels`` analog,
    src/imagenet.jl:8-21: DataFrame of (label, name, class_idx))."""

    wnids: list
    names: list
    class_idx: dict = field(default_factory=dict)  # wnid -> 0-based index

    def __post_init__(self):
        if not self.class_idx:
            self.class_idx = {w: i for i, w in enumerate(self.wnids)}

    def __len__(self):
        return len(self.wnids)


def labels(synset_mapping_path: str) -> LabelTable:
    """Parse ``LOC_synset_mapping.txt``: one line per class,
    ``<wnid> <comma separated names>``."""
    wnids, names = [], []
    with open(synset_mapping_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            wnid, _, rest = line.partition(" ")
            wnids.append(wnid)
            names.append(rest)
    return LabelTable(wnids, names)


@dataclass
class SampleTable:
    """image-id / class-index table — the sampling ``key`` the reference
    threads through ``prepare_training``/``minibatch``
    (src/imagenet.jl:58-75)."""

    image_ids: np.ndarray  # str array
    class_idx: np.ndarray  # int32
    split: str = "train"

    def __len__(self):
        return len(self.image_ids)

    def shard(self, i: int, n: int) -> "SampleTable":
        """Contiguous row shard, as ``prepare_training`` partitions the
        key across devices (src/ddp_tasks.jl:257-258)."""
        idx = np.array_split(np.arange(len(self)), n)[i]
        return SampleTable(self.image_ids[idx], self.class_idx[idx], self.split)


def train_solutions(
    csv_path: str,
    label_table: LabelTable,
    classes: Optional[Sequence[str]] = None,
    split: str = "train",
) -> SampleTable:
    """Parse ``LOC_train_solution.csv`` (columns ``ImageId,
    PredictionString`` where the prediction string starts with the wnid),
    keeping rows whose class is in ``classes`` (all classes if None) —
    the reference's class filter (src/imagenet.jl:58-75).

    ``split`` stamps the resulting table (``LOC_val_solution.csv`` has
    the same schema); it controls both the file layout (``makepaths``)
    and whether ``ImageNetDataset`` augments by default.
    """
    keep = set(classes) if classes is not None else None
    ids, cls = [], []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            wnid = row["PredictionString"].split()[0]
            if keep is not None and wnid not in keep:
                continue
            if wnid not in label_table.class_idx:
                continue
            ids.append(row["ImageId"])
            cls.append(label_table.class_idx[wnid])
    return SampleTable(np.asarray(ids, object), np.asarray(cls, np.int32), split)


def relpath(image_id: str, split: str = "train") -> str:
    """Dataset-relative file layout (src/imagenet.jl:50-56): train images
    live under ``ILSVRC/Data/CLS-LOC/train/<wnid>/<id>.JPEG`` (wnid
    prefix of the id), val/test flat under their split dir."""
    if split == "train":
        wnid = image_id.split("_")[0]
        return f"ILSVRC/Data/CLS-LOC/train/{wnid}/{image_id}.JPEG"
    return f"ILSVRC/Data/CLS-LOC/{split}/{image_id}.JPEG"


def makepaths(image_id: str, root: str, split: str = "train") -> str:
    """Absolute local path for a sample under a filesystem root."""
    return os.path.join(root, relpath(image_id, split))


class ImageNetDataset:
    """Dataset-protocol view over an ImageNet directory tree.

    ``batch(rng, n)`` samples rows with replacement (src/imagenet.jl:24),
    decodes + preprocesses each image on a worker thread into a
    preallocated ``(n, crop, crop, 3)`` float32 array (:37-48), and
    returns integer labels (the loader one-hots them).

    ``augment`` (default: on for the train split) switches the geometric
    stage to torchvision-style RandomResizedCrop + p=0.5 hflip — the
    train-time augmentation the reference lacks but the 75.9% top-1
    target requires.  Params are sampled in Python from the batch RNG
    (after the index draw), so the native and PIL backends produce
    identical batches for identical ``(rng_state, indices)``.
    """

    def __init__(
        self,
        root: str,
        table: SampleTable,
        nclasses: int,
        crop: int = 224,
        resize: int = 256,
        compat_double_normalize: bool = False,
        num_threads: int = 8,
        use_native: Optional[bool] = None,
        augment: Optional[bool] = None,
        cache_dir: Optional[str] = None,
    ):
        # ``root`` may be a local dir, a remote URL (gs:// or http(s)://,
        # fetched through a caching source — the reference's S3-backed
        # dataset analog, Data.toml:14-27), or a source object.
        self.source = root if hasattr(root, "local_path") else make_source(
            str(root), cache_dir=cache_dir
        )
        # the user-facing dataset location: a directory for filesystem
        # sources, the gs://... or http(s)://... URL for remote ones
        self.root = (
            getattr(self.source, "location", None)
            or getattr(self.source, "root", None)
            or str(root)
        )
        self.table = table
        self.nclasses = nclasses
        self.crop = crop
        self.resize = resize
        self.compat = compat_double_normalize
        self._num_threads = num_threads
        self._pool = None  # created lazily, released by close()
        if use_native is None:
            from . import native as _native

            use_native = _native.available()
        self.use_native = use_native
        if augment is None:
            augment = table.split == "train"
        self.augment = augment

    def __len__(self):
        return len(self.table)

    def close(self):
        """Release decode worker threads (also runs on GC / context exit)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self._num_threads)
        return self._pool

    def _path(self, image_id: str) -> str:
        """Local path of a sample (remote sources fetch-to-cache here).

        On the PIL path this runs on the decode worker, so fetch I/O
        overlaps other slots' decode; on the native path ``_paths``
        fetches the whole batch concurrently *before* handing local
        files to the C++ pool (cold-cache batches pay fetch-then-decode
        as two phases — steady-state cache hits make it a pure local
        read)."""
        return self.source.local_path(relpath(image_id, self.table.split))

    def _paths(self, indices) -> list:
        ids = [self.table.image_ids[j] for j in indices]
        # unknown duck-typed sources default to the remote path: the
        # concurrent fetch is harmless for local files, while serial
        # fetches on a remote source cost ~100ms/object
        if getattr(self.source, "is_local", False):
            return [self._path(i) for i in ids]
        # remote: fetch-to-cache concurrently, not one file at a time
        return list(self._ensure_pool().map(self._path, ids))

    def _load_one(self, out: np.ndarray, i: int, image_id: str, aug=None):
        path = self._path(image_id)
        out[i] = preprocess(
            path,
            crop=self.crop,
            resize=self.resize,
            compat_double_normalize=self.compat,
            augment=aug,
        )

    def batch(self, rng: np.random.Generator, n: int, indices=None):
        if indices is None:
            indices = rng.integers(0, len(self.table), size=n)
        indices = np.asarray(indices)
        # one RandomResizedCrop+flip draw per slot, consumed identically
        # by both backends (and by the native path's PIL fallback)
        augs = sample_augment_params(rng, len(indices)) if self.augment else None
        if self.use_native:
            from . import native as _native

            paths = self._paths(indices)
            # PIL fallback per file: ImageNet hides a few PNG/odd-format
            # files behind .JPEG extensions that libjpeg rejects.
            arr = _native.load_batch(
                paths,
                crop=self.crop,
                resize=self.resize,
                compat_double_normalize=self.compat,
                num_threads=self._num_threads,
                augs=augs,
                fallback=lambda p, aug=None: preprocess(
                    p,
                    crop=self.crop,
                    resize=self.resize,
                    compat_double_normalize=self.compat,
                    augment=aug,
                ),
            )
            return arr, self.table.class_idx[indices]
        pool = self._ensure_pool()
        arr = np.zeros((len(indices), self.crop, self.crop, 3), np.float32)
        futures = [
            pool.submit(
                self._load_one, arr, i, self.table.image_ids[j],
                augs[i] if augs is not None else None,
            )
            for i, j in enumerate(indices)
        ]
        for f in futures:
            f.result()  # propagate decode errors
        return arr, self.table.class_idx[indices]
