"""Port parity: the port's flash attention (B1 forward, B2/B3 backward,
through its ``torch.autograd.Function``) against the JAX package's
``flash_attention`` / ``flash_attention_lse``, which run their Pallas
kernels in interpret mode here, with ``jax.grad`` through them.  On the
CPU the port runs the kernels' plain versions, block for block.

The same numpy inputs (and the same random output cotangent) go to
both.  Tolerances: f32 O and LSE within 1e-5 abs, f32 dQ/dK/dV within
1e-4 abs (f32 sums in another order); bf16 O within 2e-2 abs (one bf16
ulp at |O| < 4 plus the f32 differences before the rounding), bf16
gradients within 5e-2 x the largest reference entry (bf16 rounding of
p and ds at the same points, f32 sums in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu.ops import attention as jattn
from fluxdistributed_tpu.ops.pallas_attention import (
    _flash_fwd_impl, flash_attention as jflash,
    flash_attention_lse as jflash_lse)
from fluxdistributed_tpu_torch.ops import (attention_core,
                                           blockwise_attention,
                                           dot_product_attention,
                                           flash_attention,
                                           flash_attention_lse)

# the module (the package exports a function of the same name)
fa_mod = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")

# name: (B, Tq, Tk, H, Hkv, D, causal, block, window, sinks)
VARIANTS = {
    "noncausal": (2, 64, 64, 2, 2, 16, False, 16, None, 0),
    "causal": (2, 64, 64, 2, 2, 16, True, 16, None, 0),
    "ragged_t": (2, 40, 40, 2, 2, 16, True, 16, None, 0),
    "ragged_noncausal": (1, 40, 40, 2, 2, 32, False, 16, None, 0),
    "tq_lt_tk": (2, 24, 40, 2, 2, 16, True, 16, None, 0),
    "gqa": (2, 32, 32, 4, 2, 16, True, 16, None, 0),
    "window1": (1, 48, 48, 2, 2, 16, True, 16, 1, 0),
    "window5_sinks2": (1, 48, 48, 2, 2, 16, True, 16, 5, 2),
    "window16_sinks4_gqa": (1, 48, 48, 4, 2, 16, True, 16, 16, 4),
    "fully_masked_rows": (2, 8, 4, 2, 2, 16, True, 4, None, 0),
    "big_block": (1, 96, 96, 2, 1, 32, True, 32, None, 0),
    # head dim 80 (ViT-H/14's 1280 / 16) at its 257 tokens: the kernels'
    # fourth head dim, with a ragged last block
    "d80_noncausal": (2, 257, 257, 2, 2, 80, False, 128, None, 0),
    "d80_causal_window_sinks": (1, 257, 257, 2, 2, 80, True, 128, 64, 2),
}


def _inputs(b, tq, tk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, hkv, d)).astype(np.float32)
    g = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    return q, k, v, g


def _jax_run(q, k, v, g, causal, block, window, sinks, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    gj = jnp.asarray(g, dtype)

    def f(a, b_, c):
        return jflash(a, b_, c, causal, block, block, window, sinks)

    out = f(*args)
    grads = jax.grad(
        lambda a, b_, c: (f(a, b_, c).astype(jnp.float32)
                          * gj.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(*args)
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _torch_run(q, k, v, g, causal, block, window, sinks,
               dtype=torch.float32):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, causal, block, block, window, sinks)
    out.backward(torch.from_numpy(g).to(dtype))
    return [x.detach().float().numpy() for x in (out, *(t.grad for t in ts))]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_flash_matches_jax_f32(name):
    b, tq, tk, h, hkv, d, causal, block, window, sinks = VARIANTS[name]
    q, k, v, g = _inputs(b, tq, tk, h, hkv, d)
    ref = _jax_run(q, k, v, g, causal, block, window, sinks)
    got = _torch_run(q, k, v, g, causal, block, window, sinks)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5, rtol=0)
    for a, r in zip(got[1:], ref[1:]):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, r, atol=1e-4, rtol=0)
    # the per-row LSE B1 saves for the backward
    _, jlse = _flash_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)), causal,
                              block, block, window=window, sinks=sinks)
    jlse = np.asarray(jlse).reshape(b, h, tq)
    _, tlse = fa_mod.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        block_q=block, block_k=block, window=window, sinks=sinks)
    live = jlse > -1e29
    np.testing.assert_array_equal(tlse.numpy() > -1e29, live)
    np.testing.assert_allclose(tlse.numpy()[live], jlse[live], atol=1e-5,
                               rtol=0)
    if name == "fully_masked_rows":
        # Tq > Tk end-aligned: the first 4 query rows attend nothing
        assert not live[:, :, :4].any()
        assert np.abs(got[0][:, :4]).max() == 0.0
        assert np.abs(got[1][:, :4]).max() == 0.0


def test_flash_padded_k_extreme_scores_finite():
    """Non-causal, a padded KV block, and a row whose every real score
    is << 0 (LSE < -88): exp(0 - LSE) overflows at the padded keys, which
    the backward must re-mask (tests/test_pallas_attention.py:151)."""
    q, k, v, g = _inputs(2, 24, 24, 2, 2, 32)
    q[:, 0] = 5.0
    k[:] = -5.0
    ref = _jax_run(q, k, v, g, False, 16, None, 0)
    got = _torch_run(q, k, v, g, False, 16, None, 0)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5, rtol=0)
    for a, r in zip(got[1:], ref[1:]):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, r, atol=1e-4, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_bf16(causal):
    q, k, v, g = _inputs(2, 48, 48, 2, 2, 32, seed=3)
    ref = _jax_run(q, k, v, g, causal, 16, None, 0, dtype=jnp.bfloat16)
    got = _torch_run(q, k, v, g, causal, 16, None, 0, dtype=torch.bfloat16)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-2, rtol=0)
    for a, r in zip(got[1:], ref[1:]):
        assert np.abs(a - r).max() <= 5e-2 * np.abs(r).max()


def test_flash_lse_with_lse_cotangent_matches_jax():
    """flash_attention_lse with a nonzero LSE cotangent: the cotangent
    folds into delta, the kernels are unchanged."""
    b, tq, tk, h, d = 2, 24, 40, 2, 16
    q, k, v, g = _inputs(b, tq, tk, h, h, d, seed=5)
    gl = np.random.default_rng(6).normal(size=(b, h, tq)).astype(np.float32)

    def jf(a, b_, c):
        out, lse = jflash_lse(a, b_, c, True, 16, 16)
        return (out * jnp.asarray(g)).sum() + (lse * jnp.asarray(gl)).sum()

    jargs = [jnp.asarray(x) for x in (q, k, v)]
    jout, jlse = jflash_lse(*jargs, True, 16, 16)
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(*jargs)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention_lse(*ts, True, 16, 16)
    assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
    torch.autograd.backward((out, lse), (torch.from_numpy(g),
                                         torch.from_numpy(gl)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               atol=1e-5, rtol=0)
    for t, r in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)


# name: (Tq, Tk, causal, window, sinks)
TILE_CASES = {
    "causal": (256, 256, True, None, 0),
    "noncausal": (200, 130, False, None, 0),
    "window_sinks": (512, 512, True, 100, 4),
    "window_no_sinks": (384, 384, True, 64, 0),
    "tq_lt_tk": (96, 320, True, None, 0),
    "tq_gt_tk": (300, 40, True, None, 0),
    "ragged": (200, 200, True, None, 0),
    "ragged_window_sinks": (150, 230, True, 70, 3),
}


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_block_relevant_at_kernel_tiles_is_exact(name):
    """At the kernels' tiles (``TILE_Q`` x ``TILE_K``), the dead-tile test
    is true exactly for the tiles whose band mask holds a live pair: a
    skipped tile drops nothing, and a tile the kernel walks has work."""
    tq, tk, causal, window, sinks = TILE_CASES[name]
    tile_q, tile_k = fa_mod.TILE_Q, fa_mod.TILE_K
    offset = tk - tq
    for qs in range(0, tq, tile_q):
        for ks in range(0, tk, tile_k):
            live = fa_mod._band_mask(qs, min(qs + tile_q, tq), ks,
                                     min(ks + tile_k, tk), tk, causal,
                                     offset, window, sinks, "cpu").any()
            assert fa_mod._block_relevant(qs, ks, tile_q, tile_k, causal,
                                          offset, window, sinks) == bool(live), (
                qs, ks)


def test_plain_versions_match_dense_oracle():
    """Block walk == one dense softmax, fwd and bwd (window + GQA)."""
    q, k, v, g = _inputs(2, 40, 40, 4, 2, 16, seed=8)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ds = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, True, 16, 16, 7, 2)
    ref = dot_product_attention(*ds, causal=True, window=7, sinks=2)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    out.backward(torch.from_numpy(g))
    ref.backward(torch.from_numpy(g))
    for a, r in zip(ts, ds):
        torch.testing.assert_close(a.grad, r.grad, atol=1e-4, rtol=0)


def test_cpu_backward_runs_the_b2_b3_plain_versions(monkeypatch):
    """The CPU backward goes through the B2/B3 wrappers (their plain
    versions), not autograd of the forward; no kernel launch counts."""
    calls = []
    for name in ("flash_attention_dq_reference",
                 "flash_attention_dkv_reference"):
        orig = getattr(fa_mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(fa_mod, name, spy)
    before = (fa_mod.flash_attention_fwd.launches,
              fa_mod.flash_attention_dq.launches,
              fa_mod.flash_attention_dkv.launches)
    q, k, v, g = _inputs(1, 16, 16, 2, 2, 16)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    flash_attention(*ts, True, 8, 8).backward(torch.from_numpy(g))
    assert calls == ["flash_attention_dq_reference",
                     "flash_attention_dkv_reference"]
    assert (fa_mod.flash_attention_fwd.launches,
            fa_mod.flash_attention_dq.launches,
            fa_mod.flash_attention_dkv.launches) == before


def test_validation_errors():
    q = torch.zeros(1, 8, 3, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, kv, kv, False, 16, 16, 4)
    with pytest.raises(ValueError, match="window must be >= 1"):
        flash_attention(q, kv, kv, True, 16, 16, 0)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, kv, kv, True, 16, 16, None, 2)
    with pytest.raises(ValueError, match="sinks must be >= 0"):
        flash_attention(q, kv, kv, True, 16, 16, 4, -1)
    with pytest.raises(ValueError, match="multiple of num KV heads"):
        flash_attention(q, kv[:, :, :2], kv[:, :, :2], True, 16, 16)
    with pytest.raises(ValueError, match="causal"):
        flash_attention_lse(q, kv, kv, False, 16, 16, 4)
    # the JAX validation, for comparison: the same combos raise there
    with pytest.raises(ValueError, match="causal"):
        jflash(jnp.zeros((1, 8, 3, 16)), jnp.zeros((1, 8, 3, 16)),
               jnp.zeros((1, 8, 3, 16)), False, 16, 16, 4)


def test_attention_core_names_and_decode_refusal():
    assert attention_core("dense") is None
    with pytest.raises(ValueError, match="unknown attention core"):
        attention_core("nope")
    with pytest.raises(ValueError, match="block size"):
        attention_core("flash", 0)
    with pytest.raises(ValueError, match="sinks"):
        attention_core("flash", 16, sinks=2)
    flash = attention_core("flash", 16)
    with pytest.raises(ValueError, match="decode"):
        flash(torch.zeros(1, 1, 2, 16), torch.zeros(1, 9, 2, 16),
              torch.zeros(1, 9, 2, 16))
    # the JAX core refuses the same shape
    with pytest.raises(ValueError, match="decode"):
        jattn.attention_core("flash", 16)(
            jnp.zeros((1, 1, 2, 16)), jnp.zeros((1, 9, 2, 16)),
            jnp.zeros((1, 9, 2, 16)))


@pytest.mark.parametrize("window,sinks,match", [
    (0, 0, "window must be >= 1"), (4, -1, "sinks must be >= 0"),
    (None, 2, "sinks only make sense with a window")])
def test_every_core_shares_the_window_rules(window, sinks, match):
    """One validator (``ops.attention.validate_window``) holds the window
    and sinks rules for the dense and blockwise cores, the core names,
    the flash kernels and the model's attention."""
    from fluxdistributed_tpu_torch.models import lm_tiny

    q = torch.zeros(1, 8, 2, 16)
    calls = [
        lambda: dot_product_attention(q, q, q, causal=True, window=window,
                                      sinks=sinks),
        lambda: blockwise_attention(q, q, q, block_size=4, causal=True,
                                    window=window, sinks=sinks),
        lambda: attention_core("flash", 16, window=window, sinks=sinks),
        lambda: flash_attention(q, q, q, True, 16, 16, window, sinks),
        lambda: lm_tiny(vocab=32, device="cpu", window=window, sinks=sinks),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("window,sinks", [(None, 0), (6, 2)])
def test_blockwise_matches_jax(window, sinks):
    q, k, v, _ = _inputs(2, 40, 40, 4, 2, 16, seed=9)
    ref = jattn.blockwise_attention(
        *(jnp.asarray(x) for x in (q, k, v)), block_size=16, causal=True,
        window=window, sinks=sinks)
    got = blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              block_size=16, causal=True, window=window,
                              sinks=sinks)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_kernels_take_head_dim_80():
    """The kernels' head dims are 32, 64, 80 and 128: the wrapper's check
    passes D = 80 (ViT-H/14) and still refuses the others."""
    ok = [torch.zeros(1, 8, 2, 80) for _ in range(3)]
    fa_mod._check_kernel_inputs(*ok)
    assert fa_mod._HEAD_DIMS == (32, 64, 80, 128)
    with pytest.raises(ValueError, match="head_dim"):
        fa_mod._check_kernel_inputs(*(torch.zeros(1, 8, 2, 48)
                                      for _ in range(3)))
