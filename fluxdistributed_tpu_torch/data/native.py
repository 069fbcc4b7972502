"""ctypes binding for the native C++ image-ingest library: a copy of
``fluxdistributed_tpu/data/native.py`` that builds the repository's
``native/fd_native.cpp`` into the port's own build directory.

The reference's data path reaches native code through dependencies —
libjpeg-turbo via JpegTurbo.jl (src/imagenet.jl:32) and the
ImageMagick/Images.jl stack for resize/filter (src/preprocess.jl:39-41) —
with one Julia thread per image (src/imagenet.jl:44-46).  This framework
ships its own native pipeline (``native/fd_native.cpp``): libjpeg decode,
antialiased triangle-filter resize, center crop, normalize, batched over
an internal C++ thread pool.  ctypes releases the GIL for the whole batch
call, so ingest runs fully parallel to the training step dispatch.

The library is compiled on first use (g++, ~1s, the JAX package's
flags) and cached at ``fluxdistributed_tpu_torch/_build/libfdnative.so``
(git-ignored, beside the kernels).  Everything degrades gracefully: if the
toolchain or libjpeg is missing, callers fall back to the PIL path in
``preprocess.py`` (same output contract, looser perf).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from .preprocess import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["available", "load_batch", "preprocess_rgb", "decode_jpeg_file", "lib_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "fd_native.cpp")
_SO = os.path.join(_PKG, "_build", "libfdnative.so")

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> str:
    return _SO


_ABI_VERSION = 3  # must match fd_version() in fd_native.cpp


def _build() -> bool:
    """Compile to a per-process temp file then os.replace() into place —
    atomic, so concurrent builders (multi-host shared filesystem,
    pytest-xdist) never dlopen a half-written library."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3", "-fPIC", "-std=c++17", "-shared",
        "-o", tmp, _SRC, "-ljpeg", "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not os.path.exists(_SRC) or not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.fd_version.restype = ctypes.c_int
        if lib.fd_version() != _ABI_VERSION:
            # stale prebuilt library from an older source — rebuild once
            if not _build():
                return None
            lib = ctypes.CDLL(_SO)
            lib.fd_version.restype = ctypes.c_int
            if lib.fd_version() != _ABI_VERSION:
                return None
        lib.fd_preprocess_rgb.restype = ctypes.c_int
        lib.fd_preprocess_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.fd_decode_jpeg_file.restype = ctypes.c_int
        lib.fd_decode_jpeg_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.fd_load_batch.restype = ctypes.c_int
        lib.fd_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ]
        lib.fd_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native library is present (building it if needed)."""
    return _load() is not None


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _norm_params(mean, std):
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    return m, s


def _aug_ptr(augment, expected_shape):
    """None → NULL; else a C-contiguous float32 array of aug params and
    its pointer (the array must stay referenced for the call's lifetime)."""
    if augment is None:
        return None, None
    arr = np.ascontiguousarray(augment, np.float32)
    if arr.shape != expected_shape:
        raise ValueError(f"augment params must have shape {expected_shape}, got {arr.shape}")
    return arr, _fp(arr)


def preprocess_rgb(
    rgb: np.ndarray,
    crop: int = 224,
    resize: int = 256,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    compat_double_normalize: bool = False,
    augment=None,
) -> np.ndarray:
    """Native resize→crop→normalize for one HWC uint8 RGB array.

    ``augment``: optional 5-vector ``(area, ratio, u, v, flip)`` from
    ``preprocess.sample_augment_params`` switching the geometric stage to
    RandomResizedCrop+hflip (train path); None is the eval path.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    out = np.empty((crop, crop, 3), np.float32)
    m, s = _norm_params(mean, std)
    aug_arr, aug_p = _aug_ptr(augment, (5,))
    rc = lib.fd_preprocess_rgb(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        resize, crop, _fp(m), _fp(s),
        1 if compat_double_normalize else 0, _fp(out), aug_p,
    )
    del aug_arr
    if rc != 0:
        raise ValueError(f"fd_preprocess_rgb failed (rc={rc})")
    return out


def decode_jpeg_file(path: str) -> np.ndarray:
    """Native libjpeg decode of one file → HWC uint8 RGB."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    buf = ctypes.POINTER(ctypes.c_uint8)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.fd_decode_jpeg_file(path.encode(), ctypes.byref(buf),
                                 ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"cannot decode {path} (rc={rc})")
    try:
        n = h.value * w.value * 3
        arr = np.ctypeslib.as_array(buf, shape=(n,)).copy()
    finally:
        lib.fd_free(buf)
    return arr.reshape(h.value, w.value, 3)


def load_batch(
    paths: Sequence[str],
    crop: int = 224,
    resize: int = 256,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    compat_double_normalize: bool = False,
    num_threads: int = 8,
    out: Optional[np.ndarray] = None,
    strict: bool = True,
    fallback: Optional[Callable[..., np.ndarray]] = None,
    augs: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Full native pipeline for a list of JPEG files → (N, crop, crop, 3).

    The ``minibatch`` builder analog (src/imagenet.jl:37-48): decode +
    preprocess every file on a C++ thread pool into a preallocated
    float32 batch.  Slots the native decoder cannot handle (e.g. PNG
    bytes hiding behind a ``.JPEG`` extension) are retried through
    ``fallback(path) -> HWC float32`` when given — so a handful of odd
    files degrade to the slow path instead of poisoning the batch.  With
    ``strict`` (default) anything still failing after the fallback
    raises; otherwise those slots stay zero-filled.

    ``augs``: optional ``(N, 5)`` float32 of per-image
    ``sample_augment_params`` rows enabling RandomResizedCrop+hflip
    (train path).  When given, the fallback is called as
    ``fallback(path, aug_row)`` so slow-path slots see the same
    augmentation.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not 1 <= crop <= resize:
        raise ValueError(f"need 1 <= crop <= resize, got crop={crop} resize={resize}")
    n = len(paths)
    if out is None:
        out = np.empty((n, crop, crop, 3), np.float32)
    if out.shape != (n, crop, crop, 3) or out.dtype != np.float32:
        raise ValueError(
            f"out must be float32 {(n, crop, crop, 3)}, got {out.dtype} {out.shape}"
        )
    if not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous (native code writes raw memory)")
    enc = [p.encode() for p in paths]
    arr = (ctypes.c_char_p * n)(*enc)
    m, s = _norm_params(mean, std)
    errbuf = ctypes.create_string_buffer(512)
    failed = np.zeros(n, np.uint8)
    aug_arr, aug_p = _aug_ptr(augs, (n, 5))
    failures = lib.fd_load_batch(
        arr, n, resize, crop, _fp(m), _fp(s),
        1 if compat_double_normalize else 0, _fp(out),
        num_threads, errbuf, len(errbuf),
        failed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), aug_p,
    )
    if failures:
        still_failed = []
        first_fb_err = None
        for i in np.nonzero(failed)[0]:
            if fallback is not None:
                try:
                    if aug_arr is None:
                        out[i] = fallback(paths[i])
                    else:
                        out[i] = fallback(paths[i], aug_arr[i])
                    continue
                except Exception as e:  # noqa: BLE001 — any decode error → slot failed
                    first_fb_err = first_fb_err or e
            still_failed.append(int(i))
        if still_failed and strict:
            detail = errbuf.value.decode(errors="replace")
            if first_fb_err is not None:
                detail += f"; fallback: {first_fb_err}"
            raise ValueError(
                f"{len(still_failed)}/{n} images failed to load (first: {detail})"
            )
    return out
