"""Sample from a trained LM: ``python -m fluxdistributed_tpu_torch.generate``.

The port's counterpart of the JAX package's ``bin/generate.py``, with
its flags: it loads a checkpoint of the port's trainer
(``python -m fluxdistributed_tpu_torch.train --model lm_* ...
--checkpoint-dir``), rebuilds the model and samples from a prompt
through the KV cache (:func:`.models.generate`: a batched prefill, then
one single-token step a position, each through the hand-written decode
kernel on the card): byte-level prompts and outputs for ``text:``
corpora (vocab 256), integer token prompts otherwise::

    python -m fluxdistributed_tpu_torch.train --model lm_tiny \\
        --dataset text:corpus.txt --seqlen 128 --batch-size 64 \\
        --epochs 2 --checkpoint-dir ck/
    python -m fluxdistributed_tpu_torch.generate --model lm_tiny \\
        --checkpoint ck/ --prompt "The quick" --length 200 \\
        --temperature 0.8

    # no checkpoint: a random-init model (a structure smoke test)
    python -m fluxdistributed_tpu_torch.generate --model lm_tiny \\
        --vocab 64 --prompt-tokens 3,1,4

``--gpt2-weights FILE`` samples from a HuggingFace ``GPT2LMHeadModel``
``state_dict`` saved with ``torch.save`` (:mod:`.models.gpt2`: the
architecture comes from the weights, so ``--model``, ``--vocab``,
``--norm`` and ``--mlp`` are ignored; it has no tokenizer, so prompts
are ``--prompt-tokens``).  ``--engine`` decodes through the serving
engine (:mod:`.serve`) instead: the same greedy tokens.  ``--seed``
seeds the ``torch.Generator`` that sampling draws from.  It runs on the
card unless given ``--device cpu`` (``--platform cpu|gpu`` is
``--device cpu|cuda``; ``--platform tpu`` is refused).
"""

from __future__ import annotations

import argparse
import sys

from .train.__main__ import LM_MODELS, platform_device

__all__ = ["build_parser", "main", "run"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m fluxdistributed_tpu_torch.generate",
        description="Sample from a trained LM with the PyTorch/H100 port.")
    p.add_argument("--model", default="lm_tiny", choices=LM_MODELS,
                   help="LM factory in fluxdistributed_tpu_torch.models")
    p.add_argument("--vocab", type=int, default=256,
                   help="vocab size (256 = byte-level, text: corpora)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint directory of the port's trainer (the "
                        "latest step unless --step; random init if "
                        "omitted); an http(s):// or gs:// URL of a .zip of "
                        "it is fetched through data.sources")
    p.add_argument("--gpt2-weights", default=None,
                   help="a torch-saved HF GPT2LMHeadModel state_dict "
                        "(.pt): the architecture comes from the weights "
                        "and --model/--vocab/--norm/--mlp are ignored; "
                        "may be a URL (fetched and cached)")
    p.add_argument("--engine", action="store_true",
                   help="decode through the serving engine "
                        "(fluxdistributed_tpu_torch.serve) instead of the "
                        "sampler: the same greedy tokens")
    p.add_argument("--gpt2-heads", type=int, default=None,
                   help="GPT-2 head count (default: dim // 64)")
    p.add_argument("--step", type=int, default=None,
                   help="a specific checkpoint step")
    p.add_argument("--prompt", default=None,
                   help="text prompt, encoded as UTF-8 bytes (needs "
                        "vocab >= 256)")
    p.add_argument("--prompt-tokens", default=None,
                   help="comma-separated integer token prompt")
    p.add_argument("--length", type=int, default=128,
                   help="total sequence length, prompt included")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy; > 0 samples")
    p.add_argument("--top-k", type=int, default=0,
                   help="keep only the k highest logits (0 = off)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling threshold (1.0 = off)")
    p.add_argument("--seed", type=int, default=0,
                   help="sampling seed (a torch.Generator)")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu", "tpu"],
                   help="bin/generate.py's platform: cpu is --device cpu, "
                        "gpu --device cuda; tpu is refused")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    # architecture flags: they must match the training run's
    p.add_argument("--kv-heads", type=int, default=None,
                   help="match the trainer's --kv-heads (GQA)")
    p.add_argument("--window", type=int, default=None,
                   help="match the trainer's --window (rolling KV cache)")
    p.add_argument("--sinks", type=int, default=0,
                   help="match the trainer's --sinks (attention sinks)")
    p.add_argument("--norm", default="layernorm",
                   choices=["layernorm", "rmsnorm"],
                   help="match the trainer's --norm")
    p.add_argument("--mlp", default="gelu", choices=["gelu", "swiglu"],
                   help="match the trainer's --mlp")
    return p


def _prompt(args, vocab: int):
    """The prompt tokens (numpy int64), checked against ``vocab`` and
    ``--length``."""
    import numpy as np

    if args.prompt is not None:
        if vocab < 256:
            raise SystemExit("--prompt is byte-encoded; needs --vocab >= 256")
        prompt = np.frombuffer(args.prompt.encode("utf-8"),
                               np.uint8).astype(np.int64)
    elif args.prompt_tokens is not None:
        prompt = np.asarray([int(t) for t in args.prompt_tokens.split(",")],
                            np.int64)
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise SystemExit(f"prompt tokens must be in [0, {vocab})")
    else:
        prompt = np.zeros(1, np.int64)
    # a prompt of exactly --length is valid: nothing to sample
    if not 0 < len(prompt) <= args.length:
        raise SystemExit(f"prompt length {len(prompt)} must be in (0, "
                         f"--length {args.length}]")
    return prompt


def _lm(args, device):
    """The ``--model`` LM with the checkpoint's weights, or random ones
    from seed 0."""
    import torch

    from . import models

    arch = {"num_kv_heads": args.kv_heads, "window": args.window,
            "sinks": args.sinks, "norm": args.norm, "mlp": args.mlp}
    model = getattr(models, args.model)(vocab=args.vocab, device=device,
                                        seed=0, **arch)
    if args.checkpoint:
        from .data.sources import fetch_checkpoint
        from .train.checkpoint import load_checkpoint

        path = fetch_checkpoint(args.checkpoint)
        restored = load_checkpoint(path, step=args.step)
        with torch.no_grad():
            model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in
                 restored["params"].items()}, strict=True)
        print(f"loaded checkpoint step {restored.get('step', -1)} from "
              f"{path}", file=sys.stderr)
    else:
        print("no --checkpoint: sampling from a RANDOM-INIT model",
              file=sys.stderr)
    return model


def _gpt2(args, device):
    """The ``--gpt2-weights`` model (its position table cut to
    ``--length``)."""
    import torch

    from .data.sources import fetch_artifact
    from .models import gpt2

    sd = torch.load(fetch_artifact(args.gpt2_weights), map_location="cpu",
                    weights_only=True)
    try:
        cfg = gpt2.gpt2_config(sd)
        heads = args.gpt2_heads or max(cfg["dim"] // 64, 1)
        if args.length > cfg["n_positions"]:
            raise SystemExit(f"--length {args.length} exceeds the GPT-2 "
                             f"positional table ({cfg['n_positions']})")
        model = gpt2.gpt2_model(sd, num_heads=heads, seqlen=args.length,
                                device=device)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    print(f"loaded GPT-2 weights: depth={cfg['depth']} d={cfg['dim']} "
          f"heads={heads} vocab={cfg['vocab']}", file=sys.stderr)
    return model


def _engine_generate(args, model, prompt):
    """One prompt through the serving engine's decode path."""
    import numpy as np

    from .serve import LMEngine, Request, Scheduler

    if args.top_k or args.top_p < 1.0:
        raise SystemExit("--engine does not support --top-k/--top-p "
                         "(drop them or use the sampler)")
    if args.length == len(prompt):
        return np.asarray(prompt)
    # bucket at the prompt's length: prefill runs over its positions
    engine = LMEngine(model, max_slots=1, max_len=args.length,
                      buckets=(len(prompt),))
    req = Request(prompt=[int(t) for t in prompt],
                  max_new_tokens=args.length - len(prompt),
                  temperature=args.temperature, seed=args.seed)
    return np.asarray(Scheduler(engine).generate_all([req])[0], np.int64)


def run(argv=None):
    """Parse ``argv``, sample, and return the tokens (numpy, prompt
    included); :func:`main` prints them."""
    import numpy as np
    import torch

    from . import models

    args = build_parser().parse_args(argv)
    if args.prompt is not None and args.prompt_tokens is not None:
        raise SystemExit("pass --prompt OR --prompt-tokens, not both")
    if args.gpt2_weights and args.prompt is not None:
        raise SystemExit("--gpt2-weights has no tokenizer; pass "
                         "--prompt-tokens (BPE ids)")
    from .device import resolve_device

    platform_device(args)
    device = resolve_device(args.device)
    if args.gpt2_weights:
        model = _gpt2(args, device)
        args.vocab = model.vocab
    else:
        model = _lm(args, device)
    prompt = _prompt(args, args.vocab)
    if args.engine:
        out = _engine_generate(args, model, prompt)
    else:
        rng = None
        if args.temperature > 0:
            rng = torch.Generator(device=device).manual_seed(args.seed)
        with torch.no_grad():
            out = models.generate(
                model, torch.as_tensor(prompt)[None], args.length,
                temperature=args.temperature, rng=rng, top_k=args.top_k,
                top_p=args.top_p)[0].cpu().numpy()
    return np.asarray(out, np.int64), args.vocab


def main(argv=None) -> int:
    toks, vocab = run(argv)
    if vocab == 256:
        from .data import ByteTextDataset

        print(ByteTextDataset.decode(toks))
    else:
        print(",".join(str(int(t)) for t in toks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
