"""Classify images with a trained checkpoint: the port of the JAX
package's ``bin/infer.py``, the stand-in for the reference's Pluto
inference notebook (``bin/pluto.jl``).

    python -m fluxdistributed_tpu_torch.infer --model resnet50 \\
        --checkpoint ckpts/ --synset LOC_synset_mapping.txt cat.jpg dog.jpg

    # no checkpoint and no images: a random-init demo on a noise image
    python -m fluxdistributed_tpu_torch.infer --model resnet18 \\
        --num-classes 10 --device cpu

The checkpoint is a trainer's (:mod:`.train.checkpoint`; the latest
step, or ``--step``), or ``--torch-weights`` names a torchvision-layout
``state_dict`` file.  Images go through training's eval pipeline
(resize the smallest side, center-crop, normalise), one forward pass in
eval mode, and the ``showpreds`` table of the top ``--topk`` is
printed.  Runs on the GPU unless ``--device cpu`` (or ``--platform
cpu``; ``gpu`` is ``cuda``, ``tpu`` is refused) is given.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["build_parser", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.infer",
        description=__doc__.split("\n")[0])
    p.add_argument("images", nargs="*", help="image files (JPEG/PNG)")
    p.add_argument("--model", default="resnet50",
                   help="image model factory in fluxdistributed_tpu_torch."
                        "models")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--checkpoint", default=None,
                   help="trainer checkpoint dir (the latest step, or "
                        "--step; random init if omitted); http(s):// or "
                        "gs:// are fetched (a remote .zip is unpacked)")
    p.add_argument("--step", type=int, default=None,
                   help="specific checkpoint step")
    p.add_argument("--torch-weights", default=None,
                   help=".pt/.pth file with a torchvision-layout "
                        "state_dict")
    p.add_argument("--synset", default=None,
                   help="LOC_synset_mapping.txt for human-readable labels")
    p.add_argument("--topk", type=int, default=3,
                   help="predictions per image (the reference demo: 3)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--resize", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--platform", default=None,
                   help="bin/infer.py's platform: cpu is --device cpu, gpu "
                        "is --device cuda; tpu is refused")
    return p


def main(argv=None) -> int:
    from .train.__main__ import platform_device

    args = build_parser().parse_args(argv)
    platform_device(args)

    import numpy as np
    import torch

    from .data.preprocess import preprocess
    from .device import resolve_device
    from .ops.metrics import showpreds
    from .serve.vision import class_names, load_image_model

    device = resolve_device(args.device)
    try:
        model, source = load_image_model(
            args.model, args.num_classes, checkpoint=args.checkpoint,
            step=args.step, torch_weights=args.torch_weights, device=device)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.checkpoint or args.torch_weights:
        print(f"restored {source}")
    names = class_names(args.synset)
    if args.images:
        batch = np.stack([preprocess(p, crop=args.image_size,
                                     resize=args.resize)
                          for p in args.images])
        rows = args.images
    else:
        print("(no images given — running a random-init demo on noise)")
        batch = np.random.default_rng(0).normal(
            0, 1, (1, args.image_size, args.image_size, 3)).astype(np.float32)
        rows = ["<synthetic>"]
    with torch.no_grad():
        logits = model(torch.from_numpy(batch).to(device))
    print(showpreds(logits, class_names=names, k=args.topk, names=rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
