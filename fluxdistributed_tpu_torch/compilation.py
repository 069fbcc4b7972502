"""Cold start: the persistent kernel build cache, AOT manifests and
warmup.

The port's counterpart of ``fluxdistributed_tpu/compilation.py``.  The
JAX package pays its cold start in XLA compiles; the port pays it in
two other events (:mod:`.obs.jaxmon` counts both): an ``nvcc`` build of
each ``csrc/*.cu`` kernel library (tens of seconds for a fresh
checkout) and a CUDA graph capture of each captured step (the device
loop, the serving engine's decode step).  This module ports the JAX
module's contract, not XLA's mechanism:

* :func:`enable_persistent_cache` points the kernel build directory
  (``ops/_build.py``) at ``dir/<topology_namespace()>/``: the next
  process with the same toolchain and card loads every library from
  there instead of running ``nvcc`` (a cache hit), and a process with
  another ``nvcc`` or another card never finds a library built for a
  different one.
* AOT manifests: a CUDA graph cannot outlive its process and a kernel
  library is not a program, so the port's "executable" is a manifest
  (magic :data:`AOT_MAGIC`) holding the topology fingerprint, the
  argument signature and every kernel library the callable launched,
  by name, source key and content hash.  The libraries themselves stay
  in the build cache (the persistent one when it is enabled):
  :func:`load_or_compile` loads the manifest when all of these match
  and the cache holds those very libraries, and then builds nothing;
  otherwise it runs the callable once on the example arguments
  (building and capturing at prepare time rather than at step 0) and
  saves the manifest.  A mismatch or a corrupt file falls back to that
  fresh run, never to a crash.
* :func:`warmup_train` runs one train step on zero-filled copies of the
  state (the live state untouched) so every build, capture and
  allocator warm-up is paid before timing or traffic starts; the serve
  side's counterpart is ``LMEngine.warmup``.

AOT outcomes are counted in the obs registry
(``fdtpu_aot_loads_total`` / ``fdtpu_aot_compiles_total``, seconds in
``fdtpu_aot_seconds_total{source=...}``), and the build cache's hits
and misses land through :mod:`.obs.jaxmon`.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import re
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

__all__ = [
    "AOT_MAGIC",
    "AotProgram",
    "enable_persistent_cache",
    "persistent_cache_dir",
    "topology_fingerprint",
    "topology_namespace",
    "abstract_signature",
    "callable_tag",
    "config_tag",
    "aot_compile",
    "save_executable",
    "load_executable",
    "load_or_compile",
    "warmup_train",
    "compile_metrics",
]

#: format tag of every manifest; bumping it invalidates all on-disk
#: manifests at once (they fall back to a fresh run, never to a crash)
AOT_MAGIC = "fdtpu-aot-torch-v1"

#: filename suffix of a manifest
AOT_SUFFIX = ".aot.json"

_cache_dir: Optional[str] = None


@functools.lru_cache(maxsize=None)
def _nvcc_line(path: str) -> str:
    try:
        out = subprocess.run([path, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvcc-unusable"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else "nvcc-silent"


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its build tag), or ``"none"``
    when there is no ``nvcc``."""
    from .ops import _build

    try:
        return _nvcc_line(_build.nvcc())
    except RuntimeError:
        return "none"


def _card():
    """``(platform, device kind, compute capability)`` of this process's
    first card, or the CPU's."""
    import torch

    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return "cuda", torch.cuda.get_device_name(0), f"sm_{major}{minor}"
    return "cpu", "cpu", "cpu"


def _counts():
    """``(device count, process count)``."""
    import torch

    ndev = torch.cuda.device_count() if torch.cuda.is_available() else 1
    nproc = 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        nproc = torch.distributed.get_world_size()
    return ndev, nproc


def topology_fingerprint(mesh=None, tag: str = "") -> str:
    """Digest of everything a manifest is specific to: the torch and
    CUDA versions, the ``nvcc --version`` line, the card's name and
    compute capability, the device and process counts, optionally the
    mesh shape and a caller tag (the knobs that change the program
    without changing argument shapes).  Argument shapes are
    :func:`abstract_signature`'s; the two compose into the on-disk
    key."""
    import torch

    platform, kind, cc = _card()
    ndev, nproc = _counts()
    parts = [torch.__version__, str(torch.version.cuda), nvcc_version(),
             platform, kind, cc, str(ndev), str(nproc)]
    if mesh is not None:
        parts.append(repr(sorted(dict(mesh.shape).items())))
    if tag:
        parts.append(tag)
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _slug(s: str) -> str:
    return re.sub(r"[^a-z0-9.]+", "-", s.lower()).strip("-")


def topology_namespace() -> str:
    """Readable per-toolchain subdirectory of the build cache:
    ``cuda-nvidia-h100-80gb-hbm3-sm_90-cuda12.4-nvcc-build-cuda_12.4...``.
    A kernel library depends on the toolchain and the card's
    architecture only, so unlike the JAX namespace it leaves the device
    and process counts out: a 4-rank run reuses a 1-rank run's builds."""
    import torch

    platform, kind, cc = _card()
    return "-".join([platform, _slug(kind), cc.replace("sm_", "sm"),
                     f"cuda{torch.version.cuda}",
                     "nvcc-" + _slug(nvcc_version())])[:200]


def enable_persistent_cache(cache_dir: Optional[str]) -> Optional[str]:
    """Point the kernel build cache at ``cache_dir``.

    Returns the RESOLVED directory (namespaced per toolchain and card),
    or ``None`` when ``cache_dir`` is falsy.  Call it before the first
    kernel build: libraries this process has loaded stay loaded."""
    global _cache_dir
    if not cache_dir:
        return None
    path = os.path.join(os.path.abspath(os.path.expanduser(cache_dir)),
                        topology_namespace())
    os.makedirs(path, exist_ok=True)
    from .obs import get_registry, jaxmon
    from .ops import _build

    _build.set_build_dir(path)
    _cache_dir = path
    # surface enablement in the registry: a scrape answers "is this
    # process even using the cache" without reading logs
    jaxmon.install()
    get_registry().gauge(
        "fdtpu_compile_cache_enabled",
        "1 when the persistent kernel build cache is configured",
    ).set(1)
    return path


def persistent_cache_dir() -> Optional[str]:
    """The resolved cache directory of the last
    :func:`enable_persistent_cache` call in this process (``None`` when
    the cache was never enabled here)."""
    return _cache_dir


_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def _structure(x, leaves: list) -> str:
    """The tree structure of ``x`` (dicts by sorted key, lists, tuples,
    dataclasses by field); each leaf's abstract value appended to
    ``leaves``."""
    import torch

    if isinstance(x, dict):
        return "{" + ",".join(f"{k!r}:{_structure(x[k], leaves)}"
                              for k in sorted(x, key=repr)) + "}"
    if isinstance(x, (list, tuple)):
        inner = ",".join(_structure(v, leaves) for v in x)
        return f"[{inner}]" if isinstance(x, list) else f"({inner})"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x).__name__ + "(" + ",".join(
            f"{f.name}={_structure(getattr(x, f.name), leaves)}"
            for f in dataclasses.fields(x)) + ")"
    if isinstance(x, torch.Tensor):
        leaves.append(f"{tuple(x.shape)}:{str(x.dtype).split('.')[-1]}:"
                      f"{x.device.type}")
    elif isinstance(x, torch.nn.Module):
        leaves.append(_ADDR_RE.sub("0x", repr(x)))
    elif x is None:
        return "None"
    else:
        leaves.append(f"():{type(x).__name__}")
    return "*"


def abstract_signature(args: Sequence[Any],
                       kwargs: Optional[dict] = None) -> str:
    """Digest of the tree structure and the abstract values of a call's
    arguments: a tensor's shape, dtype and device type, a module's repr
    (addresses scrubbed), a plain value's type.  The part of a
    manifest's identity the topology fingerprint does not cover."""
    leaves: list = []
    tree = _structure((tuple(args), kwargs or {}), leaves)
    payload = tree + "|" + ";".join(leaves)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def callable_tag(fn, depth: int = 2) -> str:
    """Stable identity string for a configured callable: its name plus
    any scalar constants (and, one level down, callables) closed over —
    e.g. ``momentum(0.1, 0.9).rule`` → ``rule:0.9``.  This is what
    distinguishes two optimizers/losses whose hyperparameters are
    baked into the program without changing any argument shape.
    Deliberately address-free: reprs of functions or objects (which
    embed ``0x...`` ids) never enter the tag, so the same configuration
    hashes identically across processes."""
    parts = [getattr(fn, "__name__", type(fn).__name__)]
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:  # pragma: no cover — empty cell
            continue
        if isinstance(v, (bool, int, float, str, bytes, type(None))):
            parts.append(repr(v))
        elif isinstance(v, (tuple, frozenset)) and all(
                isinstance(e, (bool, int, float, str)) for e in v):
            parts.append(repr(v))
        elif callable(v) and depth > 0:
            parts.append(callable_tag(v, depth - 1))
    return ":".join(parts)


def config_tag(*parts) -> str:
    """Digest arbitrary configuration parts into the short tag that
    feeds :func:`topology_fingerprint` — THE one place AOT key
    construction lives, shared by the trainer and the serve engine so
    the two cannot drift.  Callables route through :func:`callable_tag`;
    everything else stringifies with memory addresses scrubbed."""
    norm = []
    for p in parts:
        if callable(p) and not isinstance(p, type):
            norm.append(callable_tag(p))
        else:
            norm.append(_ADDR_RE.sub("0x", str(p)))
    return hashlib.sha256("|".join(norm).encode()).hexdigest()[:12]


def _wrapper_libraries() -> dict:
    """Every kernel wrapper (each counts its launches) and the library
    its kernel lives in."""
    import importlib

    # the package exports the wrappers under their modules' names
    fa, fd, adam = (importlib.import_module(f"{__package__}.ops.{m}")
                    for m in ("flash_attention", "flash_decode",
                              "fused_adam"))
    return {fd.flash_decode: "flash_decode",
            fd.flash_decode_paged: "flash_decode",
            fa.flash_attention_fwd: "flash_attention",
            fa.flash_attention_dq: "flash_attention",
            fa.flash_attention_dkv: "flash_attention",
            adam.fused_adam: "fused_adam"}


class AotProgram:
    """A callable and the kernel libraries it launches (``{name:
    path}``).  Calls go to ``fn``, and so do attribute reads it lacks
    (a device loop's ``graphs``).  ``loaded`` is true when a manifest
    supplied the libraries (nothing was built or run at prepare
    time)."""

    def __init__(self, fn, signature: str, libraries: Dict[str, Path],
                 loaded: bool = False):
        self.fn = fn
        self.signature = signature
        self.libraries = dict(libraries)
        self.loaded = loaded

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __getattr__(self, name: str):
        if name == "fn":  # not set yet (unpickling): no recursion
            raise AttributeError(name)
        return getattr(self.fn, name)


def aot_compile(fn, *args, **kwargs) -> AotProgram:
    """Run ``fn`` once on the given arguments and wait for the card:
    every kernel it launches is built (or found in the cache) and every
    graph it captures is captured now.  Returns the :class:`AotProgram`
    naming the libraries of the kernels it launched."""
    import torch

    from .ops import _build

    wrappers = _wrapper_libraries()
    before = {w: w.launches for w in wrappers}
    loaded0 = {n for n in _build.SOURCES if _build.loaded_path(n)}
    fn(*args, **(kwargs or {}))
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    names = {lib for w, lib in wrappers.items() if w.launches > before[w]}
    names |= {n for n in _build.SOURCES
              if _build.loaded_path(n) and n not in loaded0}
    libs = {n: _build.loaded_path(n) for n in sorted(names)}
    return AotProgram(fn, abstract_signature(args, kwargs),
                      {n: p for n, p in libs.items() if p is not None})


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_executable(path: str, compiled: AotProgram, *,
                    fingerprint: Optional[str] = None) -> str:
    """Write ``compiled``'s manifest to ``path`` (atomic).  It carries
    the format magic, the topology fingerprint, the argument signature
    and, per library, its source key and content hash;
    :func:`load_executable` refuses anything that does not match."""
    from .ops import _build

    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    libs = {name: {"key": _build.library_key(name), "sha256": _sha256(src)}
            for name, src in sorted(compiled.libraries.items())}
    blob = {"magic": AOT_MAGIC,
            "fingerprint": fingerprint or topology_fingerprint(),
            "signature": compiled.signature, "libraries": libs}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_executable(path: str, *, fingerprint: Optional[str] = None,
                    signature: Optional[str] = None
                    ) -> Optional[AotProgram]:
    """Read a manifest saved by :func:`save_executable` and check that
    the build cache holds each of its libraries, built from the current
    source (its key) and byte for byte the one saved (its hash): the
    kernel loader then finds them there and builds nothing.

    Returns an :class:`AotProgram` without a callable (``fn=None``;
    ``loaded=True``), or ``None`` — never raises — on a missing or
    corrupt file, a format-magic, fingerprint or signature mismatch, a
    library whose source changed since, or a library the cache lacks or
    holds with other content: every load site falls back to a fresh
    run."""
    from .ops import _build

    expected = fingerprint or topology_fingerprint()
    try:
        with open(path) as f:
            blob = json.load(f)
        if (blob.get("magic") != AOT_MAGIC
                or blob.get("fingerprint") != expected
                or (signature is not None
                    and blob.get("signature") != signature)):
            return None
        libs = {}
        for name, meta in blob["libraries"].items():
            lib = _build.library_path(name)
            if (meta["key"] != _build.library_key(name)
                    or _sha256(lib) != meta["sha256"]):
                return None
            libs[name] = lib
    except Exception:  # noqa: BLE001 — any load failure means "rebuild"
        return None
    return AotProgram(None, blob.get("signature", ""), libs, loaded=True)


def load_or_compile(
    fn,
    args: Sequence[Any] = (),
    kwargs: Optional[dict] = None,
    *,
    directory: str,
    name: str,
    fingerprint: Optional[str] = None,
    registry=None,
) -> AotProgram:
    """The AOT workflow in one call: look for a manifest of ``fn`` at
    these arguments under ``directory`` whose libraries the build cache
    holds, else run ``fn`` once on the arguments (:func:`aot_compile`)
    and save the manifest for the next process.  A process in another
    checkout finds those libraries only through a persistent cache
    (:func:`enable_persistent_cache`) shared with the saving one.

    The on-disk key is ``<name>-<topology fp>-<argument signature>`` — a
    torch or ``nvcc`` upgrade, another card, another device count or a
    shape change each select a different file, so a mismatch is an
    automatic miss, not a crash.  Returns an :class:`AotProgram` that
    calls ``fn``.  Outcomes are counted in the obs registry
    (``fdtpu_aot_loads_total`` / ``fdtpu_aot_compiles_total``) and the
    seconds accumulate in ``fdtpu_aot_seconds_total{source=...}``."""
    from .obs import get_registry

    reg = registry or get_registry()
    fp = fingerprint or topology_fingerprint()
    sig = abstract_signature(args, kwargs)
    path = os.path.join(directory, f"{name}-{fp}-{sig}{AOT_SUFFIX}")
    secs = reg.histogram(
        "fdtpu_aot_seconds_total",
        "wall seconds loading or compiling AOT manifests",
        labelnames=("source",),
    )
    t0 = time.perf_counter()
    loaded = load_executable(path, fingerprint=fp, signature=sig)
    if loaded is not None:
        reg.counter(
            "fdtpu_aot_loads_total",
            "AOT manifests loaded from disk (builds skipped)",
        ).inc()
        secs.labels(source="load").observe(time.perf_counter() - t0)
        return AotProgram(fn, sig, loaded.libraries, loaded=True)
    t0 = time.perf_counter()
    compiled = aot_compile(fn, *args, **(kwargs or {}))
    reg.counter(
        "fdtpu_aot_compiles_total",
        "AOT programs run fresh at prepare time (no matching manifest)",
    ).inc()
    secs.labels(source="compile").observe(time.perf_counter() - t0)
    try:
        save_executable(path, compiled, fingerprint=fp)
    except Exception as e:  # noqa: BLE001 — saving is best-effort
        import sys

        print(f"compilation: could not save {name!r} to {path}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
    return compiled


def zeros_like_state(state):
    """A zero-filled copy of a train state (same shapes, dtypes and
    devices; the step counter kept)."""
    import torch

    from .tree import tree_map

    zero = lambda x: (torch.zeros_like(x)  # noqa: E731
                      if isinstance(x, torch.Tensor) else x)
    return type(state)(params=tree_map(zero, state.params),
                       opt_state=tree_map(zero, state.opt_state),
                       model_state=tree_map(zero, state.model_state),
                       step=state.step)


def warmup_train(task, batch) -> dict:
    """Pre-pay the training cold start: run ONE train call on
    zero-filled copies of the state (the task's real state is never
    touched) and wait for the card.  That builds every kernel the step
    launches and, for a device loop on a card, captures its graph.

    ``batch`` must have the exact layout training will feed (the
    trainer's ``prepare_training(warmup=True)`` builds it from the
    dataset).  The eval step warms up too, against the task's val batch
    when one exists.

    Returns ``{"seconds": ..., "compiles": ..., "compile_seconds": ...}``
    — what the cold start actually cost."""
    import torch

    from .obs import jaxmon

    jaxmon.install()
    c0, s0 = jaxmon.compile_count(), jaxmon.compile_seconds()
    t0 = time.perf_counter()
    task.step_fn(zeros_like_state(task.state), batch)
    if task.val_batch is not None:
        task.eval_fn(zeros_like_state(task.state), task.val_batch)
    if task.device.type == "cuda":
        torch.cuda.synchronize(task.device)
    return {
        "seconds": time.perf_counter() - t0,
        "compiles": jaxmon.compile_count() - c0,
        "compile_seconds": jaxmon.compile_seconds() - s0,
    }


def compile_metrics() -> dict:
    """The cold-start ledger of this process, from the jaxmon counters:
    compile count/seconds plus build-cache hits/misses and the ``nvcc``
    seconds the cache saved."""
    from .obs import jaxmon

    jaxmon.install()
    return {
        "compiles": int(jaxmon.compile_count()),
        "compile_seconds": round(jaxmon.compile_seconds(), 3),
        "cache_hits": int(jaxmon.cache_hits()),
        "cache_misses": int(jaxmon.cache_misses()),
        "compile_seconds_saved": round(jaxmon.compile_seconds_saved(), 3),
    }
