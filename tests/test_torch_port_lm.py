"""Port parity: the port's ``TransformerLM`` (weights carried across by
``load_flax_params``) against the JAX package's flax ``TransformerLM``.

* Full-forward logits, f32: atol 1e-4 (depth-2 f32 stacks; the two
  frameworks round matmuls, norms and rope's sin/cos differently in the
  last bits).
* Greedy ``generate``: token-identical to JAX ``generate`` with
  ``attention_impl="pallas"`` (the decode kernel's path; the XLA block
  walk off-TPU).
* int8 KV decode: the per-step logits of a quantised cache within atol
  2e-3 (a value on an int8 rounding boundary may round the other way
  when the f32 K/V differ in the last bit), and greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu.models import generate as jax_generate
from fluxdistributed_tpu.models import lm_tiny as jax_lm_tiny
from fluxdistributed_tpu.models.transformer_lm import (
    make_decode_cache as jax_make_cache)
from fluxdistributed_tpu_torch.models import (
    generate, lm_tiny, load_flax_params, make_decode_cache, quantize_kv,
    dequantize_kv, rope)

CONFIGS = {
    "plain": {},
    "gqa": {"num_kv_heads": 2},
    "window_sinks": {"window": 4, "sinks": 1},
    "rmsnorm_swiglu": {"norm": "rmsnorm", "mlp": "swiglu"},
    "learned_pos": {"use_rope": False, "max_len": 24,
                    "tie_embeddings": False},
}
SMALL = dict(depth=2, dim=64, num_heads=4, mlp_dim=128)


def _pair(config, vocab=32):
    kw = CONFIGS[config]
    jm = jax_lm_tiny(vocab=vocab, dtype=jnp.float32, **SMALL, **kw)
    params = jm.init(jax.random.PRNGKey(1), np.zeros((1, 2), np.int32),
                     train=False)["params"]
    tm = lm_tiny(vocab=vocab, dtype=torch.float32, device="cpu", **SMALL, **kw)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.mark.parametrize("config", list(CONFIGS))
def test_forward_logits_match_flax(config):
    jm, params, tm = _pair(config)
    toks = np.random.default_rng(0).integers(0, 32, (2, 11)).astype(np.int32)
    ref = np.asarray(jm.apply({"params": params}, toks, train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks).long()).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("config", ["plain", "window_sinks", "gqa",
                                    "learned_pos"])
def test_greedy_generate_token_identical(config):
    jm, params, tm = _pair(config)
    prompt = np.random.default_rng(2).integers(0, 32, (2, 5)).astype(np.int32)
    ref = np.asarray(jax_generate(
        jm.clone(decode=True, attention_impl="pallas"), params, prompt,
        total_len=17))
    got = generate(tm, prompt, total_len=17).numpy()
    assert np.array_equal(got, ref)


def test_int8_kv_decode_within_tolerance():
    jm, params, tm = _pair("gqa")
    dm = jm.clone(decode=True, kv_quant="int8", attention_impl="pallas")
    prompt = np.random.default_rng(4).integers(0, 32, (1, 6)).astype(np.int32)
    jcache = jax_make_cache(dm, 1, 12)
    tcache = make_decode_cache(tm, 1, 12, kv_quant="int8")
    jtok, ttok = prompt, torch.from_numpy(prompt).long()
    for _ in range(4):  # prefill, then single-token steps
        jl, mut = dm.apply({"params": params, "cache": jcache}, jtok,
                           train=False, mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            tl = tm(ttok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3,
                                   rtol=0)
        jtok = np.asarray(jl)[:, -1:].argmax(-1).astype(np.int32)
        ttok = tl[:, -1:].argmax(-1)
        assert np.array_equal(ttok.numpy(), jtok)
    assert tcache.k[0].dtype == torch.int8
    assert int(tcache.index[0]) == 6 + 3


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_quantize_kv_roundtrip(kv_quant):
    from fluxdistributed_tpu.models.transformer_lm import quantize_kv as jq

    x = np.random.default_rng(6).normal(size=(3, 5, 2, 16)).astype(np.float32)
    q, s = quantize_kv(torch.from_numpy(x), kv_quant)
    jqv, js = jq(jnp.asarray(x), kv_quant)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(q.float().numpy(),
                                  np.asarray(jqv.astype(jnp.float32)))
    back = dequantize_kv(q, s, torch.float32).numpy()
    tol = 0.5 / 127 if kv_quant == "int8" else 1 / 16  # half a step
    assert np.all(np.abs(back - x) <= tol * np.abs(x).max(-1, keepdims=True)
                  + 1e-7)


def test_rope_interleaved_pairs_match_jax():
    from fluxdistributed_tpu.models.transformer_lm import rope as jrope

    x = np.random.default_rng(7).normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(3, 8)
    np.testing.assert_allclose(
        rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos))), atol=1e-5)


def test_generate_sampling_validation_and_rng():
    tm = lm_tiny(vocab=32, dtype=torch.float32, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="rng"):
        generate(tm, [[1, 2]], 6, temperature=0.8)
    with pytest.raises(ValueError, match="top_k/top_p"):
        generate(tm, [[1, 2]], 6, top_k=3)
    a = generate(tm, [[1, 2]], 12, temperature=0.8, top_k=5, top_p=0.9,
                 rng=torch.Generator().manual_seed(3))
    b = generate(tm, [[1, 2]], 12, temperature=0.8, top_k=5, top_p=0.9,
                 rng=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 32
