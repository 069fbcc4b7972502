"""Port parity: ``fluxdistributed_tpu_torch.ops.attention`` against the
JAX package's ``ops/attention.py`` on the same numpy inputs (f32).

Tolerance: atol 1e-5 — both sides compute the same f32 math; only the
order of summation differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu.ops import attention as jattn
from fluxdistributed_tpu_torch.ops import attention as tattn

ATOL = 1e-5


def _qkv(seed, b=2, tq=6, tk=6, h=4, hkv=4, d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, tk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, tk, hkv, d)).astype(np.float32)
    return q, k, v


def _both(q, k, v, **kw):
    ref = np.asarray(jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: (jnp.asarray(x) if n == "mask" else x) for n, x in kw.items()}))
    got = tattn.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        **{n: (torch.from_numpy(x) if n == "mask" else x)
           for n, x in kw.items()}).numpy()
    return got, ref


@pytest.mark.parametrize("case", [
    "plain", "causal", "causal_tq_lt_tk", "mask", "window_sinks", "gqa",
    "gqa_window",
])
def test_dot_product_attention_parity(case):
    kw, shape = {}, {}
    if case == "causal":
        kw = dict(causal=True)
    elif case == "causal_tq_lt_tk":
        shape = dict(tq=3, tk=9)
        kw = dict(causal=True)
    elif case == "mask":
        rng = np.random.default_rng(11)
        m = rng.random((2, 1, 6, 6)) < 0.6
        m[0, 0, 2] = False  # a fully-masked row must come out exactly 0
        kw = dict(mask=m)
    elif case == "window_sinks":
        shape = dict(tq=10, tk=10)
        kw = dict(causal=True, window=3, sinks=2)
    elif case == "gqa":
        shape = dict(h=8, hkv=2)
        kw = dict(causal=True)
    elif case == "gqa_window":
        shape = dict(h=4, hkv=2, tq=9, tk=9)
        kw = dict(causal=True, window=4)
    q, k, v = _qkv(1, **shape)
    got, ref = _both(q, k, v, **kw)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if case == "mask":
        assert np.all(got[0, 2, 0] == 0.0)


def test_dot_product_attention_validation():
    q, k, v = (torch.zeros(1, 2, 2, 4) for _ in range(3))
    with pytest.raises(ValueError, match="causal"):
        tattn.dot_product_attention(q, k, v, window=2)
    with pytest.raises(ValueError, match="sinks"):
        tattn.dot_product_attention(q, k, v, causal=True, sinks=1)
    with pytest.raises(ValueError, match="multiple"):
        tattn.dot_product_attention(torch.zeros(1, 2, 3, 4), k, v)


@pytest.mark.parametrize("masked", [False, True])
def test_online_softmax_update_parity(masked):
    rng = np.random.default_rng(5)
    s = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    m_prev = rng.normal(size=(2, 3, 4)).astype(np.float32)
    l_prev = rng.uniform(0.5, 2.0, size=(2, 3, 4)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((2, 3, 4, 8)) < 0.5
        mask[0, 0, 0] = False  # a row masked everywhere, fresh stats
        m_prev[0, 0, 0] = tattn.NEG_INF
        l_prev[0, 0, 0] = 0.0
    ref = jattn.online_softmax_update(
        jnp.asarray(s), jnp.asarray(m_prev), jnp.asarray(l_prev),
        mask=None if mask is None else jnp.asarray(mask))
    got = tattn.online_softmax_update(
        torch.from_numpy(s), torch.from_numpy(m_prev),
        torch.from_numpy(l_prev),
        mask=None if mask is None else torch.from_numpy(mask))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=0)
    if masked:
        # the explicit zeroing: exp(s - NEG_INF) would be 1 otherwise
        assert np.all(got[0].numpy()[0, 0, 0] == 0.0)
        assert got[3].numpy()[0, 0, 0] == 0.0
    assert tattn.NEG_INF == jattn.NEG_INF
