"""Port parity: GPT-2 weights in the port's LM (``models/gpt2.py``) and
the sampling CLI (``fluxdistributed_tpu_torch/generate.py``), the
counterparts of the JAX package's ``models/torch_import.py`` GPT-2 half
and ``bin/generate.py`` (``tests/test_torch_import.py:204-326``,
``tests/test_generate_cli.py``).

A seeded random ``transformers.GPT2LMHeadModel`` (nothing is
downloaded).  The port's import equals the JAX import's tree mapped to
the port's names exactly, and its logits are within 2e-4 of HF's and of
the JAX LM's on the JAX import (the JAX tests' tolerance).  A
``state_dict`` that is not GPT-2 is refused as JAX refuses it.  Decode
(prefill, then single-token cache steps through the decode kernel's
plain version on the CPU) matches the full forward within 2e-4; greedy
``generate`` equals HF's greedy continuation.  The CLI: its bounds,
byte and integer prompts, a port trainer checkpoint, ``--engine``, and
``--gpt2-weights`` against HF.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from fluxdistributed_tpu.models import import_gpt2 as jimport_gpt2
from fluxdistributed_tpu.models.torch_import import gpt2_config as jgpt2_config
from fluxdistributed_tpu.models.transformer_lm import TransformerLM as JLM
from fluxdistributed_tpu_torch import models
from fluxdistributed_tpu_torch.models import gpt2
from fluxdistributed_tpu_torch.models.from_jax import flax_to_state_dict

gen = importlib.import_module("fluxdistributed_tpu_torch.generate")
train_cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")


def _hf(seed, vocab, pos, dim, layers, heads):
    torch.manual_seed(seed)
    cfg = transformers.GPT2Config(
        vocab_size=vocab, n_positions=pos, n_embd=dim, n_layer=layers,
        n_head=heads, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def hm():
    return _hf(0, 100, 32, 48, 2, 3)


@pytest.fixture(scope="module")
def small():
    return _hf(2, 64, 16, 32, 2, 2)


def test_import_equals_the_jax_import(hm):
    sd = hm.state_dict()
    assert gpt2.gpt2_config(sd) == jgpt2_config(sd)
    params, mstate = gpt2.import_gpt2(sd, num_heads=3, seqlen=32)
    jparams, _ = jimport_gpt2(sd, num_heads=3, seqlen=32)
    assert mstate == {}
    ref = flax_to_state_dict(jparams)
    assert set(params) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(params[k].numpy(), v, err_msg=k)


def test_logits_match_hf_and_jax(hm):
    sd = hm.state_dict()
    m = gpt2.gpt2_model(sd, num_heads=3, seqlen=32, device="cpu")
    toks = np.random.default_rng(0).integers(0, 100, (2, 32))
    with torch.no_grad():
        ref = hm(torch.from_numpy(toks)).logits.numpy()
        out = m(torch.from_numpy(toks)).numpy()
    jparams, _ = jimport_gpt2(sd, num_heads=3, seqlen=32)
    jm = JLM(vocab=100, depth=2, dim=48, num_heads=3, mlp_dim=192,
             dtype=jnp.float32, dropout=0.0, use_rope=False, norm_eps=1e-5)
    jout = np.asarray(jm.apply({"params": jparams},
                               jnp.asarray(toks, jnp.int32), train=False))
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, jout, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bad", [{"foo": torch.zeros(1)},
                                 {"wte.weight": torch.zeros(4, 2),
                                  "wpe.weight": torch.zeros(4, 2),
                                  "ln_f.weight": torch.zeros(2),
                                  "ln_f.bias": torch.zeros(2)}])
def test_rejects_a_non_gpt2_state_dict(bad):
    msg = "wte" if "wte.weight" not in bad else "no transformer blocks"
    with pytest.raises(ValueError, match=msg):
        jimport_gpt2(bad, num_heads=2)
    with pytest.raises(ValueError, match=msg):
        gpt2.import_gpt2(bad, num_heads=2)


def test_decode_matches_full_forward(small):
    m = gpt2.gpt2_model(small.state_dict(), seqlen=16, num_heads=2,
                        device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (2, 16)))
    with torch.no_grad():
        full = m(toks)
        cache = models.make_decode_cache(m, 2, 16)
        got = [m(toks[:, :5], cache)]
        for t in range(5, 16):
            got.append(m(toks[:, t:t + 1], cache))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_greedy_generate_equals_hf_and_bounds(small):
    m = gpt2.gpt2_model(small.state_dict(), seqlen=16, num_heads=2,
                        device="cpu")
    prompt = torch.tensor([[3, 1, 4]])
    with torch.no_grad():
        out = models.generate(m, prompt, total_len=10)
        href = small.generate(prompt, max_length=10, do_sample=False,
                              pad_token_id=0)
    assert out.shape == (1, 10)
    np.testing.assert_array_equal(out.numpy(), href.numpy())
    with pytest.raises(ValueError, match="positional table"):
        models.generate(m, prompt, total_len=32)


def test_cli_gpt2_weights_equal_hf_greedy(small, tmp_path, capsys):
    pt = tmp_path / "gpt2.pt"
    torch.save(small.state_dict(), pt)
    with torch.no_grad():
        ref = small.generate(torch.tensor([[3, 1, 4]]), max_length=10,
                             do_sample=False, pad_token_id=0)[0]
    for extra in ([], ["--engine"]):
        assert gen.main(["--gpt2-weights", str(pt), "--gpt2-heads", "2",
                         "--prompt-tokens", "3,1,4", "--length", "10",
                         "--platform", "cpu", *extra]) == 0
        got = capsys.readouterr().out.strip().splitlines()[-1]
        assert got == ",".join(str(int(t)) for t in ref), (extra, got)
    with pytest.raises(SystemExit, match="positional table"):
        gen.main(["--gpt2-weights", str(pt), "--prompt-tokens", "1",
                  "--length", "17", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no tokenizer"):
        gen.main(["--gpt2-weights", str(pt), "--prompt", "ab",
                  "--device", "cpu"])


def test_cli_token_mode_and_bounds(capsys):
    assert gen.main(["--model", "lm_tiny", "--vocab", "16",
                     "--prompt-tokens", "3,1,4", "--length", "10",
                     "--device", "cpu"]) == 0
    toks = [int(t) for t in capsys.readouterr().out.strip().split(",")]
    assert len(toks) == 10 and toks[:3] == [3, 1, 4]
    assert all(0 <= t < 16 for t in toks)
    # a prompt of exactly --length comes back unchanged
    assert gen.main(["--model", "lm_tiny", "--vocab", "16",
                     "--prompt-tokens", "3,1,4", "--length", "3",
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "3,1,4"
    for argv, msg in (
            (["--prompt", "x", "--prompt-tokens", "1"], "not both"),
            (["--vocab", "16", "--prompt", "x"], "vocab"),
            (["--vocab", "16", "--prompt-tokens", "99", "--length", "4"],
             "in \\[0, 16\\)"),
            (["--vocab", "16", "--prompt-tokens", "1,2,3", "--length", "2"],
             "must be in"),
            (["--platform", "tpu"], "CUDA card")):
        with pytest.raises(SystemExit, match=msg):
            gen.main(argv + ([] if "--platform" in argv
                             else ["--device", "cpu"]))


def test_cli_sampling_is_seeded(capsys):
    argv = ["--model", "lm_tiny", "--vocab", "32", "--prompt-tokens", "1,2",
            "--length", "12", "--temperature", "1.0", "--top-k", "8",
            "--top-p", "0.9", "--device", "cpu"]
    outs = []
    for seed in ("0", "0", "1"):
        gen.main(argv + ["--seed", seed])
        outs.append(capsys.readouterr().out.strip())
    assert outs[0] == outs[1] and outs[0] != outs[2]


def test_cli_bytes_from_a_trainer_checkpoint(tmp_path, capsys):
    """The port's trainer saves lm_tiny on bytes; the CLI samples from
    that checkpoint, byte prompt in, decoded text out, and its greedy
    tokens are those of the trained model."""
    text = tmp_path / "corpus.txt"
    text.write_text("abcabcabd " * 200)
    ck = tmp_path / "ck"
    task = train_cli.run(["--model", "lm_tiny", "--dataset", f"text:{text}",
                          "--seqlen", "32", "--batch-size", "8", "--cycles",
                          "3", "--opt", "adam", "--lr", "3e-3",
                          "--checkpoint-dir", str(ck), "--checkpoint-every",
                          "2", "--device", "cpu",
                          "--eval-every", "0", "--print-every", "0"])
    capsys.readouterr()
    toks, vocab = gen.run(["--model", "lm_tiny", "--checkpoint", str(ck),
                           "--prompt", "ab", "--length", "8",
                           "--device", "cpu"])
    assert vocab == 256 and list(toks[:2]) == [97, 98]
    with torch.no_grad():
        ref = models.generate(task.model, torch.tensor([[97, 98]]), 8)[0]
    np.testing.assert_array_equal(toks, ref.numpy())
    assert gen.main(["--model", "lm_tiny", "--checkpoint", str(ck),
                     "--step", "3", "--prompt", "ab", "--length", "8",
                     "--temperature", "0.5", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("ab")
