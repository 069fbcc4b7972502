"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build dir>/lib<name>-<hash>.so csrc/<name>.cu

The library is built at first use into the build directory, named by a
hash of its source and flags, so an edited source rebuilds and an
unchanged one loads what is there.  The directory is
``fluxdistributed_tpu_torch/_build/`` (git-ignored) unless
:func:`..compilation.enable_persistent_cache` points it at a persistent
cache namespaced by the toolchain and the card (:func:`set_build_dir`),
where a library built for another ``nvcc`` or another card is never
found; an AOT manifest (:mod:`..compilation`) names libraries there.
:func:`build_all` starts one ``nvcc`` per source at once.  A failed
build or load raises; nothing falls back.

Every library a process finds (a cache hit, with the seconds its build
once took) or builds (a miss and a compile, with the ``nvcc`` seconds)
is reported once to :mod:`..obs.jaxmon`.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "library_key", "library_path",
           "load", "loaded_path", "nvcc", "set_build_dir"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
#: the default build directory
BUILD_DIR = _HERE.parent / "_build"
#: every kernel source of the package, by library name
SOURCES: Dict[str, Path] = {p.stem: p for p in sorted(CSRC.glob("*.cu"))}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_dir = BUILD_DIR
_loaded: Dict[str, ctypes.CDLL] = {}
# where each loaded library came from
_paths: Dict[str, Path] = {}
# library files already reported to the compile counters
_reported: set = set()


def nvcc() -> str:
    """The ``nvcc`` a build runs: ``$CUDA_HOME/bin``, ``PATH``, then
    ``/usr/local/cuda/bin``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from source at first use")


def set_build_dir(path) -> Path:
    """Build into and look in ``path`` from now on (the persistent
    cache).  Libraries this process has loaded stay loaded."""
    global _dir
    with _lock:
        _dir = Path(path)
        return _dir


def library_key(name: str) -> str:
    """The hash of ``name``'s current source and flags."""
    if name not in SOURCES:
        raise KeyError(f"no kernel source csrc/{name}.cu")
    h = hashlib.sha1(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for its current source and flags."""
    return _dir / f"lib{name}-{library_key(name)}.so"


def loaded_path(name: str) -> Optional[Path]:
    """The file ``name``'s loaded library came from, or ``None``."""
    return _paths.get(name)


def _report(out: Path, name: str, seconds: Optional[float]) -> None:
    """One compile-counter event for ``out``, the first time this
    process finds or builds it: ``seconds`` the ``nvcc`` run's, or
    ``None`` for a hit (its saved build seconds are read back)."""
    if out in _reported:
        return
    _reported.add(out)
    from ..obs import jaxmon

    if seconds is not None:
        jaxmon.record("build", seconds, what=f"csrc/{name}.cu")
        return
    try:
        saved = json.loads(out.with_suffix(".json").read_text())["seconds"]
    except (OSError, ValueError, KeyError, TypeError):
        saved = 0.0
    jaxmon.record("build", saved, cached=True, what=f"csrc/{name}.cu")


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(process | None, tmp_path, final_path, t0)``."""
    out = library_path(name)
    if out.exists():
        _report(out, name, None)
        return None, None, out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    # unique temp name + atomic rename: a concurrent build never sees a
    # half-written library
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _communicate(proc, done: dict, name: str) -> None:
    """Wait for ``proc``: ``done[name] = (its output, when it ended)``."""
    log, _ = proc.communicate()
    done[name] = (log, time.perf_counter())


def _finish(name: str, proc, tmp: Path, out: Path, t0: float,
            done: Optional[tuple] = None) -> str:
    """Install ``name``'s built library; ``done`` is ``(output, end
    time)`` of a process already waited for (:func:`_communicate`)."""
    if done is None:
        done = (proc.communicate()[0], time.perf_counter())
    log, seconds = done[0], done[1] - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    out.with_suffix(".json").write_text(json.dumps({"seconds": seconds}))
    _report(out, name, seconds)
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel source, one ``nvcc`` per source started
    together.  Returns ``{name: compiler output}`` ('' for a library
    that was already built)."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        # each build is waited for on a thread of its own, so each
        # library's seconds end when its own nvcc does
        done: Dict[str, tuple] = {}
        waits = [threading.Thread(target=_communicate, args=(st[0], done, n))
                 for n, st in started.items() if st[0] is not None]
        for t in waits:
            t.start()
        for t in waits:
            t.join()
        logs: Dict[str, str] = {}
        errors: List[str] = []
        for n, (proc, tmp, out, t0) in started.items():
            if proc is None:
                logs[n] = ""
                continue
            try:
                logs[n] = _finish(n, proc, tmp, out, t0, done[n])
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        proc, tmp, out, t0 = _start(name)
        if proc is not None:
            _finish(name, proc, tmp, out, t0)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        _paths[name] = out
        return lib
