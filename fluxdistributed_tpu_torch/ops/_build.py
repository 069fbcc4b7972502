"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library is built at first use into ``fluxdistributed_tpu_torch/
_build/`` (git-ignored), named by a hash of its source and flags, so an
edited source rebuilds and an unchanged one loads what is there.
:func:`build_all` starts one ``nvcc`` per source at once.  A failed
build or load raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "library_path", "load"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE.parent / "_build"
#: every kernel source of the package, by library name
SOURCES: Dict[str, Path] = {p.stem: p for p in sorted(CSRC.glob("*.cu"))}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for its current source and flags."""
    if name not in SOURCES:
        raise KeyError(f"no kernel source csrc/{name}.cu")
    h = hashlib.sha1(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(process | None, tmp_path, final_path)``."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # unique temp name + atomic rename: a concurrent build never sees a
    # half-written library
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel source, one ``nvcc`` per source started
    together.  Returns ``{name: compiler output}`` ('' for a library
    that was already built)."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        logs: Dict[str, str] = {}
        errors: List[str] = []
        for n, (proc, tmp, out) in started.items():
            if proc is None:
                logs[n] = ""
                continue
            try:
                logs[n] = _finish(n, proc, tmp, out)
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
        proc, tmp, out = _start(name)
        if proc is not None:
            _finish(name, proc, tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
