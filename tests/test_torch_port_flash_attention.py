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


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_kernel_design_table(kernel, dtype, d):
    """The launcher's dispatch from (kernel, dtype, head dim) to a design,
    explicit: f32 on SIMT; bf16 B1, B2 and B3 at 64, 80 and 128 on the
    Hopper kernels (wgmma, TMA, warp-specialised); bf16 at 32 on
    mma.sync."""
    got = fa_mod.kernel_design(kernel, dtype, d)
    if dtype == torch.float32:
        assert got == "SIMT f32"
    elif d in (64, 80, 128):
        assert got == "wgmma, TMA, warp-specialised"
    else:
        assert got == "tensor cores, mma.sync"
    assert got in fa_mod.DESIGNS


@pytest.mark.parametrize("args,exc", [
    (("bwd", torch.bfloat16, 64), ValueError),
    (("dq", torch.float16, 64), TypeError),
    (("dq", torch.bfloat16, 48), ValueError),
])
def test_kernel_design_refuses_what_no_kernel_takes(args, exc):
    with pytest.raises(exc):
        fa_mod.kernel_design(*args)


def test_tma_geometry_of_contiguous_and_fused_qkv_views():
    """The Hopper kernels' TMA descriptor: dims (D, T, H, B), the byte
    strides of T, H and B taken from the view itself (a fused [B, T, 3,
    H, D] QKV projection's q/k/v are read in place), 64 x 64 boxes, one
    box across a row at D = 64 and two at 128, each with the 128-byte
    swizzle; a dim of extent 1 takes 128 bytes."""
    x = torch.zeros(2, 77, 4, 128, dtype=torch.bfloat16)
    geo = fa_mod.tma_geometry(x.shape, x.stride(), 2, 0)
    assert geo == {"dims": (128, 77, 4, 2),
                   "byte_strides": (4 * 128 * 2, 128 * 2, 77 * 4 * 128 * 2),
                   "box": (64, 64, 1, 1), "boxes_per_row": 2,
                   "boxes": ((64, 128), (64, 128))}
    qkv = torch.zeros(3, 197, 3, 16, 64, dtype=torch.bfloat16)
    for i, view in enumerate(qkv.unbind(2)):
        geo = fa_mod.tma_geometry(view.shape, view.stride(), 2,
                                  i * 16 * 64 * 2)
        assert geo["dims"] == (64, 197, 16, 3)
        assert geo["byte_strides"] == (3 * 16 * 64 * 2, 64 * 2,
                                       197 * 3 * 16 * 64 * 2)
        assert geo["boxes_per_row"] == 1
    one = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    assert fa_mod.tma_geometry(one.shape, (7, 5, 3, 1), 2, 0)[
        "byte_strides"] == (128, 128, 128)


@pytest.mark.parametrize("shape,strides,ptr,what", [
    ((2, 8, 4, 64), (4 * 8 * 68, 4 * 68, 68, 1), 0, "head stride 136"),
    ((2, 8, 4, 64), (8 * 4 * 64, 4 * 64, 64, 1), 8, "base address"),
    ((2, 8, 4, 64), (8 * 4 * 64, 1, 8 * 64, 8), 0, "feature stride 8"),
    ((2, 8, 4, 64), (8 * 4 * 64, 0, 64, 1), 0, "seq stride 0"),
    ((2, 8, 4, 32), (8 * 4 * 32, 4 * 32, 32, 1), 0, "64-feature boxes"),
])
def test_tma_geometry_refuses_what_tma_cannot_read(shape, strides, ptr, what):
    """A stride or base address not a multiple of 16 bytes, a feature dim
    that is not contiguous or a head dim that is not whole boxes: refused
    with ValueError (the wrapper never copies the view)."""
    with pytest.raises(ValueError, match=what):
        fa_mod.tma_geometry(shape, strides, 2, ptr)


def test_tma_geometry_splits_a_head_dim_80_row():
    """D = 80 (ViT-H/14): a 160-byte row is no whole number of 128-byte
    swizzle atoms, so it takes two boxes, 64 features with the 128-byte
    swizzle and 16 with the 32-byte one (``RowBoxes`` in the source); a
    fused QKV view of it is read in place.  No split takes 32, 48 or 96."""
    qkv = torch.zeros(2, 257, 3, 16, 80, dtype=torch.bfloat16)
    q = qkv.unbind(2)[0]
    geo = fa_mod.tma_geometry(q.shape, q.stride(), 2, 0)
    assert geo == {"dims": (80, 257, 16, 2),
                   "byte_strides": (3 * 16 * 80 * 2, 80 * 2,
                                    257 * 3 * 16 * 80 * 2),
                   "box": (64, 64, 1, 1), "boxes_per_row": 2,
                   "boxes": ((64, 128), (16, 32))}
    assert [fa_mod.row_boxes(d) for d in (32, 48, 64, 80, 96, 128, 144)] == [
        None, None, ((64, 128),), ((64, 128), (16, 32)), None,
        ((64, 128), (64, 128)), ((64, 128), (64, 128), (16, 32))]


# -------------------------------------------------- C17: the autograd layer
#
# On the kernel path (a CUDA tensor, or a fake one on any device) the
# Hopper kernels read q, k, v and dO in place through TMA, and the B2/B3
# wrappers refuse a view TMA cannot take.  The autograd functions pass what
# they hand the kernels through ``_readable`` (a contiguous copy of what a
# design cannot read): autograd's cotangent of a ``.sum()`` is expanded
# (strides of 0), and a q view of a [..., D + 4] tensor has a head stride
# of 2 D + 8 bytes (136 at D = 64).  Fake bf16 tensors take every
# wrapper's shape-only branch, checks and all, without a card.


def _fake_qkv(d, skew=False, t=64):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        if skew:
            q = torch.empty(2, t, 4, d + 4, dtype=torch.bfloat16)[..., :d]
        else:
            q = torch.empty(2, t, 4, d, dtype=torch.bfloat16)
        k, v = (torch.empty(2, t, 4, d, dtype=torch.bfloat16)
                for _ in range(2))
    return mode, [x.requires_grad_() for x in (q, k, v)]


@pytest.mark.parametrize("d", [64, 80, 128])
def test_sum_loss_backward_on_the_kernel_path_does_not_raise(d):
    """``flash_attention(q, k, v, True).sum().backward()`` on fake bf16
    tensors: the expanded cotangent reaches B2/B3 as a copy they read."""
    mode, (q, k, v) = _fake_qkv(d)
    with mode:
        flash_attention(q, k, v, True).sum().backward()
        assert q.grad.shape == q.shape and v.grad.shape == v.shape


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_lse"])
def test_skewed_q_view_on_the_kernel_path_does_not_raise(fn, d):
    """A q view with a head stride of 2 D + 8 bytes (136 at D = 64)
    through both autograd functions: B1 reads a copy and the backward
    takes the copy B1 read."""
    mode, (q, k, v) = _fake_qkv(d, skew=True)
    assert q.stride(2) * 2 == 2 * d + 8
    with mode:
        if fn == "flash_attention":
            flash_attention(q, k, v, True).sum().backward()
        else:
            out, lse = flash_attention_lse(q, k, v, True)
            (out.float().sum() + lse.sum()).backward()
        assert q.grad.shape == q.shape


@pytest.mark.parametrize("kernel,d", [("fwd", 64), ("fwd", 80), ("dq", 80),
                                      ("fwd", 32), ("dkv", 128)])
def test_readable_copies_only_what_a_design_cannot_read(kernel, d):
    """``_readable`` hands a contiguous tensor (and a fused QKV view)
    back as it is, never a copy; an expanded or skewed view becomes a
    contiguous copy for the Hopper designs (TMA) and for the others alike,
    while ``_kernel_views`` still refuses it for a Hopper design."""
    x = torch.randn(2, 40, 4, d).bfloat16()
    fused = torch.randn(2, 40, 3, 4, d).bfloat16().unbind(2)[1]
    expanded = torch.ones(()).bfloat16().expand(2, 40, 4, d)
    skewed = torch.randn(2, 40, 4, d + 4).bfloat16()[..., :d]
    got = fa_mod._readable(kernel, x, fused, expanded, skewed)
    assert got[0] is x and got[1] is fused
    for view, copy in zip((expanded, skewed), got[2:]):
        assert copy is not view and copy.is_contiguous()
        assert torch.equal(copy, view)
    hopper = fa_mod.kernel_design(kernel, torch.bfloat16, d) == \
        "wgmma, TMA, warp-specialised"
    if hopper:
        with pytest.raises(ValueError, match="16-byte"):
            fa_mod._kernel_views(kernel, x, expanded)


@pytest.mark.parametrize("shape", [(128, 196, 16, 64), (32, 257, 16, 80)],
                         ids=["vit_l16", "vit_h14"])
def test_b1_reads_a_fused_qkv_view_in_place(shape):
    """At ViT-L/16's and ViT-H/14's shapes the q, k and v views of one
    [B, T, 3, H, D] projection are what B1 reads (no copy), on fake
    tensors on the kernel path."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, t, h, d = shape
    with FakeTensorMode():
        qkv = torch.empty(b, t, 3, h, d, dtype=torch.bfloat16)
        views = qkv.unbind(2)
        read = fa_mod._b1_views(*views)
        out, lse = fa_mod.flash_attention_fwd(*views)
        assert out.shape == (b, t, h, d) and lse.shape == (b, h, t)
    assert all(r is v for r, v in zip(read, views))


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_b2_b3_read_a_fused_qkv_view_in_place(kernel, monkeypatch):
    """At ViT-H/14's shape the q, k and v views of one [32, 257, 3, 16,
    80] projection and a contiguous dO go to B2 and B3 as they are: the
    Hopper design at D = 80 reads them through TMA (160-byte rows as two
    boxes), and the wrappers' shape-only branch on fake tensors copies
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert fa_mod.kernel_design(kernel, torch.bfloat16, 80) == \
        "wgmma, TMA, warp-specialised"
    with FakeTensorMode():
        qkv = torch.empty(32, 257, 3, 16, 80, dtype=torch.bfloat16)
        q, k, v = qkv.unbind(2)
        do = torch.empty(32, 257, 16, 80, dtype=torch.bfloat16)
        lse, delta = (torch.empty(32, 16, 257) for _ in range(2))
        seen = []
        views = fa_mod._kernel_views
        monkeypatch.setattr(fa_mod, "_kernel_views", lambda name, *xs: (
            seen.append((name, views(name, *xs))) or seen[-1][1]))
        monkeypatch.setattr(torch.Tensor, "clone", lambda *a, **kw: (
            pytest.fail("a B2/B3 input was copied")))
        call = (fa_mod.flash_attention_dq if kernel == "dq"
                else fa_mod.flash_attention_dkv)
        before = call.launches
        out = call(q, k, v, do, lse, delta)
    assert seen and seen[0][0] == kernel
    assert all(a is b for a, b in zip(seen[0][1], (q, k, v, do)))
    shapes = [(32, 257, 16, 80)] * (1 if kernel == "dq" else 2)
    assert [tuple(x.shape) for x in ((out,) if kernel == "dq" else out)] \
        == shapes
    assert call.launches == before


@pytest.mark.parametrize("d", [64, 80, 128])
def test_sum_and_skewed_q_gradients_match_jax(d):
    """On CPU tensors (the plain versions): the ``.sum()`` loss and a
    loss through a skewed q view give the JAX ``custom_vjp``'s gradients
    (f32: O within 1e-5, gradients within 1e-4)."""
    b, t, h = 1, 40, 2
    q, k, v, _ = _inputs(b, t, t, h, h, d, seed=11)
    ones = np.ones((b, t, h, d), np.float32)
    ref = _jax_run(q, k, v, ones, True, 16, None, 0)
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, True, 16, 16)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref[0], atol=1e-5,
                               rtol=0)
    for a, r in zip(ts, ref[1:]):
        np.testing.assert_allclose(a.grad.numpy(), r, atol=1e-4, rtol=0)
    wide = torch.zeros(b, t, h, d + 4)
    wide[..., :d] = torch.from_numpy(q)
    wide.requires_grad_()
    kv = [torch.from_numpy(x).requires_grad_() for x in (k, v)]
    flash_attention(wide[..., :d], *kv, True, 16, 16).sum().backward()
    np.testing.assert_allclose(wide.grad[..., :d].numpy(), ref[1],
                               atol=1e-4, rtol=0)
    assert not wide.grad[..., d:].any()
    for a, r in zip(kv, ref[2:]):
        np.testing.assert_allclose(a.grad.numpy(), r, atol=1e-4, rtol=0)
