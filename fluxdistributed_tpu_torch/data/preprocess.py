"""Image decode + preprocessing for ImageNet-style training: a copy of
``fluxdistributed_tpu/data/preprocess.py`` (numpy and PIL only).

Replaces the reference's preprocessing stack (src/preprocess.jl):
``resize_smallest_dimension`` 256 with a Gaussian lowpass when
downscaling (:30-42), ``center_crop`` 224 (:45-49), mean/std ImageNet
normalization and CHW→WHCN permute (:51-67).  Here decode and resize run
on host CPU via PIL (JPEG decode stays host-side on TPU too — SURVEY §2
native-dep table), arrays are NHWC float32, and the device copy happens
in the prefetch loader.

**The double-normalize quirk.**  The reference multiplies the normalized
image by 255 (src/preprocess.jl:66) and then ``fproc`` re-standardizes
each image with ``Flux.normalise`` (src/imagenet.jl:34), so the de-facto
training distribution is per-image zero-mean/unit-var — the ImageNet
mean/std wash out.  The clean behavior (resize → crop → (x-μ)/σ) is the
default here; ``compat_double_normalize=True`` reproduces the
reference's exact pipeline for parity testing.
"""

from __future__ import annotations

import io
from typing import Sequence

import numpy as np

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "decode_image",
    "resize_smallest_dimension",
    "center_crop",
    "preprocess",
    "sample_augment_params",
    "random_resized_crop",
]

# Reference constants, src/preprocess.jl:51-53
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def decode_image(src) -> np.ndarray:
    """JPEG/PNG bytes, path, or file-like → RGB uint8 HWC array.

    The ``jpeg_decode`` analog (src/imagenet.jl:32, via libjpeg-turbo);
    PIL uses libjpeg on the host here.
    """
    from PIL import Image

    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(src)
    img = Image.open(src)
    if img.mode != "RGB":
        img = img.convert("RGB")  # handles grayscale/CMYK ImageNet files
    return np.asarray(img, np.uint8)


def resize_smallest_dimension(img: np.ndarray, size: int = 256) -> np.ndarray:
    """Scale so the smallest side equals ``size`` (aspect preserved).

    The reference lowpass-filters with a Gaussian before downscaling
    (src/preprocess.jl:30-42, ``imfilter`` + ``imresize``); PIL's
    ``BILINEAR`` with ``reducing_gap`` performs the equivalent
    antialiased area reduction.  An image already at the target size
    comes back as it is, as PIL's resize returns a copy then (so the
    eval pipeline runs without PIL on such images).
    """
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
    if (nh, nw) == (h, w):
        return img
    from PIL import Image

    pil = Image.fromarray(img)
    pil = pil.resize((nw, nh), Image.BILINEAR, reducing_gap=2.0)
    return np.asarray(pil, np.uint8)


def center_crop(img: np.ndarray, size: int = 224) -> np.ndarray:
    """Central ``size``×``size`` crop (src/preprocess.jl:45-49)."""
    h, w = img.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return img[top : top + size, left : left + size]


def sample_augment_params(rng: np.random.Generator, n: int) -> np.ndarray:
    """Sample (n, 5) train-augmentation parameters: ``(area_frac,
    log_ratio→ratio, u, v, flip)`` — the torchvision RandomResizedCrop
    distribution (scale 0.08–1.0, aspect 3/4–4/3) + p=0.5 hflip.

    Parameters are RELATIVE so they can be sampled before image
    dimensions are known; the executor (Python or native C++) converts
    them to a pixel rect after decode.  Keeping the RNG in Python keeps
    the native pipeline deterministic and both paths reproducible from
    the same draw.
    """
    area = rng.uniform(0.08, 1.0, n)
    ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3), n))
    u = rng.uniform(0, 1, n)
    v = rng.uniform(0, 1, n)
    flip = (rng.uniform(0, 1, n) < 0.5).astype(np.float64)
    return np.stack([area, ratio, u, v, flip], axis=1).astype(np.float32)


def _aug_rect(h: int, w: int, area: float, ratio: float, u: float, v: float):
    """Pixel crop rect from relative params (shared contract with the
    native implementation — keep in sync with fd_native.cpp aug_rect)."""
    target = area * h * w
    cw = int(round(np.sqrt(target * ratio)))
    ch = int(round(np.sqrt(target / ratio)))
    if cw < 1 or ch < 1 or cw > w or ch > h:
        # fallback: largest centered square (torchvision's fallback is
        # a center crop of the min side)
        side = min(h, w)
        return (h - side) // 2, (w - side) // 2, side, side
    y0 = int(round(v * (h - ch)))
    x0 = int(round(u * (w - cw)))
    return y0, x0, ch, cw


def random_resized_crop(img: np.ndarray, crop: int, params) -> np.ndarray:
    """Apply one ``sample_augment_params`` row: crop the sampled rect,
    resize to ``crop``×``crop``, horizontal-flip if flagged."""
    from PIL import Image

    area, ratio, u, v, flip = (float(p) for p in params)
    h, w = img.shape[:2]
    y0, x0, ch, cw = _aug_rect(h, w, area, ratio, u, v)
    region = img[y0 : y0 + ch, x0 : x0 + cw]
    pil = Image.fromarray(region).resize((crop, crop), Image.BILINEAR, reducing_gap=2.0)
    out = np.asarray(pil, np.uint8)
    if flip >= 0.5:
        out = out[:, ::-1]
    return out


def preprocess(
    img,
    crop: int = 224,
    resize: int = 256,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
    compat_double_normalize: bool = False,
    augment=None,
) -> np.ndarray:
    """Full pipeline: decode (if needed) → resize → crop → normalize.

    ``augment``: an optional ``sample_augment_params`` row switching the
    geometric stage to RandomResizedCrop+flip (train mode); the default
    is the eval/reference path (resize smallest side → center crop).

    Returns HWC float32 (NHWC once batched) — the TPU-native layout; the
    reference's WHCN permute (src/preprocess.jl:64-65) is a Julia
    memory-order artifact with no analog here.
    """
    if not isinstance(img, np.ndarray):
        img = decode_image(img)
    # area <= 0 means "no augmentation" — the same gate the native
    # executor applies (fd_native.cpp: `aug && aug[0] > 0.f`), so
    # degenerate rows behave identically on both backends.
    if augment is not None and float(augment[0]) > 0:
        img = random_resized_crop(img, crop, augment)
    else:
        img = resize_smallest_dimension(img, resize)
        img = center_crop(img, crop)
    x = img.astype(np.float32) / 255.0
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    if compat_double_normalize:
        # Reference quirk: .* 255 after normalizing (src/preprocess.jl:66)
        # then per-image standardization (Flux.normalise, src/imagenet.jl:34).
        x = x * 255.0
        x = (x - x.mean()) / (x.std() + 1e-5)
    return x
