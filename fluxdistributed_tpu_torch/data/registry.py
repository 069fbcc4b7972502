"""Named-dataset registry — the ``Data.toml`` analog: a copy of
``fluxdistributed_tpu/data/registry.py``.

The reference selects datasets by hard-coded name strings
(``"imagenet_local"`` / ``"imagenet"`` / ``"imagenet_cyclops"``) resolved
through DataSets.jl against a ``Data.toml`` listing driver + location
(Data.toml:4-27; call sites src/ddp_tasks.jl:277, src/sync.jl:112).  Its
README admits the hard-coding should become an API (README.md:11).

Here that API: a TOML file (``datasets.toml``) declaring named datasets,

    [[datasets]]
    name = "imagenet_local"
    driver = "imagenet"             # imagenet | cifar10 | synthetic
    path = "/data/imagenet"         # filesystem root
    # driver-specific keys: split, classes, crop, ...

plus programmatic registration (``register_dataset``) and
``open_dataset(name)`` returning a dataset-protocol object.
"""

from __future__ import annotations

import tomllib
from typing import Any, Callable

__all__ = ["register_dataset", "open_dataset", "load_registry", "driver_of",
           "DRIVERS"]

_REGISTRY: dict[str, dict] = {}


def _driver_imagenet(spec: dict):
    from .imagenet import ImageNetDataset, labels, train_solutions
    from .sources import make_source

    # ``path`` may be a local dir, gs://bucket/prefix, or http(s)://…
    # (the reference's Data.toml registers both a FileSystem and an
    # S3-backed driver for the same dataset, Data.toml:4-27); remote
    # metadata files are fetched through the caching source.
    source = make_source(str(spec["path"]), cache_dir=spec.get("cache_dir"))
    split = spec.get("split", "train")
    synset = spec.get("synset_mapping") or source.local_path("LOC_synset_mapping.txt")
    lt = labels(synset)
    csv_path = spec.get("solution_csv", spec.get("train_solution"))
    if csv_path is None:
        csv_path = source.local_path(f"LOC_{split}_solution.csv")
    table = train_solutions(csv_path, lt, classes=spec.get("classes"), split=split)
    kwargs = {}
    for k in ("augment", "use_native"):
        # None keeps the dataset's auto/per-split default
        if spec.get(k) is not None:
            kwargs[k] = bool(spec[k])
    return ImageNetDataset(
        source,
        table,
        nclasses=len(lt),
        crop=int(spec.get("crop", 224)),
        resize=int(spec.get("resize", 256)),
        compat_double_normalize=bool(spec.get("compat_double_normalize", False)),
        num_threads=int(spec.get("num_threads", 8)),
        **kwargs,
    )


def _driver_cifar10(spec: dict):
    from .cifar import CIFAR10Dataset

    return CIFAR10Dataset(spec["path"], split=spec.get("split", "train"))


def _driver_synthetic(spec: dict):
    from .synthetic import SyntheticDataset

    shape = tuple(spec.get("shape", (32, 32, 3)))
    return SyntheticDataset(
        nsamples=int(spec.get("nsamples", 1024)),
        nclasses=int(spec.get("nclasses", 10)),
        shape=shape,
        seed=int(spec.get("seed", 0)),
    )


def _driver_text(spec: dict):
    from .text import ByteTextDataset

    return ByteTextDataset(spec["path"], seqlen=int(spec.get("seqlen", 256)))


DRIVERS: dict[str, Callable[[dict], Any]] = {
    "imagenet": _driver_imagenet,
    "cifar10": _driver_cifar10,
    "synthetic": _driver_synthetic,
    "text": _driver_text,
}


def register_dataset(name: str, driver: str, **spec) -> None:
    """Programmatic analog of a Data.toml entry."""
    if driver not in DRIVERS:
        raise ValueError(f"unknown driver {driver!r}; have {sorted(DRIVERS)}")
    _REGISTRY[name] = {"driver": driver, **spec}


def load_registry(toml_path: str) -> None:
    """Load ``[[datasets]]`` entries from a TOML file into the registry."""
    with open(toml_path, "rb") as f:
        doc = tomllib.load(f)
    for entry in doc.get("datasets", []):
        entry = dict(entry)
        name = entry.pop("name")
        driver = entry.pop("driver")
        register_dataset(name, driver, **entry)


def _spec(name: str) -> dict:
    if name not in _REGISTRY:
        raise KeyError(
            f"dataset {name!r} not registered; known: {sorted(_REGISTRY)} "
            "(load a datasets.toml with load_registry or call register_dataset)"
        )
    return _REGISTRY[name]


def driver_of(name: str) -> str:
    """The driver of a registered dataset, without opening it (the CLI
    checks the kind of data against the model first)."""
    return _spec(name)["driver"]


def open_dataset(name: str, **overrides):
    """Instantiate the named dataset (``open(BlobTree, dataset(name))``
    analog, src/sync.jl:112)."""
    spec = {**_spec(name), **overrides}
    driver = spec.pop("driver")
    return DRIVERS[driver](spec)
