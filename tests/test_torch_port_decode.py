"""Port parity: ``fluxdistributed_tpu_torch.ops.flash_decode`` on the CPU
(its plain version) against the JAX package's ``flash_decode`` — both
the real Pallas kernel under the interpreter (``impl="interpret"``) and
the XLA block walk (``impl="xla"``) — on the same numpy inputs.

Tolerance: atol 1e-5 for every case.  All inputs are f32 or exactly
representable stored values (int8, fp8 e4m3) with f32 scales; both
sides dequantise to the same f32 numbers and keep p in f32 (the Pallas
body's ``p.astype(v.dtype)`` is a no-op for f32 and dequantised
caches), so only the order of summation differs.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu.ops.pallas_decode import flash_decode as jax_decode
from fluxdistributed_tpu_torch.ops.flash_decode import (
    flash_decode, flash_decode_reference)

# the package re-exports the function under the module's own name
fd_mod = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")

ATOL = 1e-5


def _ring_state(b, rows, sinks, cursors):
    """slot_pos of a ring of ``rows`` slots written up to each cursor."""
    sp = np.full((b, rows), -1, np.int32)
    ring = rows - sinks
    for bb, cur in enumerate(cursors):
        for p in range(cur + 1):
            if p < sinks:
                sp[bb, p] = p
            elif p > cur - ring:
                sp[bb, sinks + (p - sinks) % ring] = p
    return sp


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    b, h, hkv, d, r = 3, 4, 4, 16, 40
    kw, block_k = {}, 16
    if name == "gqa":
        h, hkv = 8, 2
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, r, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, r, hkv, d)).astype(np.float32)
    idx = np.asarray([0, 17, 39], np.int32)  # first token / mid / full
    jk = tk = None
    if name in ("ring_sinks", "nothing"):
        window, sinks, r = 8, 2, 13
        k, v = k[:, :r], v[:, :r]
        idx = np.asarray([0, 7, 25], np.int32)  # pre-wrap / at / post-wrap
        sp = _ring_state(b, r, sinks, idx)
        if name == "nothing":
            sp[:] = -1  # nothing written: every slot attends nothing
        kw = dict(slot_pos=sp, window=window, sinks=sinks)
        block_k = 8
    if name == "int8":
        k = rng.integers(-127, 128, size=k.shape).astype(np.int8)
        v = rng.integers(-127, 128, size=v.shape).astype(np.int8)
        jk, tk = jnp.int8, torch.int8
    if name == "fp8":
        # values exactly representable in e4m3, held as f32 for numpy
        k = torch.from_numpy(k * 8).to(torch.float8_e4m3fn).float().numpy()
        v = torch.from_numpy(v * 8).to(torch.float8_e4m3fn).float().numpy()
        jk, tk = jnp.float8_e4m3fn, torch.float8_e4m3fn
    if jk is not None:
        kw["k_scale"] = rng.uniform(0.01, 0.1, (b, k.shape[1], hkv)).astype(np.float32)
        kw["v_scale"] = rng.uniform(0.01, 0.1, (b, k.shape[1], hkv)).astype(np.float32)
    return q, k, v, idx, kw, block_k, jk, tk


def _run_torch(q, k, v, idx, kw, block_k, tk):
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if tk is not None:
        kt, vt = kt.to(tk), vt.to(tk)
    return flash_decode(torch.from_numpy(q), kt, vt, torch.from_numpy(idx),
                        block_k=block_k, **tkw).numpy()


def _run_jax(q, k, v, idx, kw, block_k, jk, impl):
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    if jk is not None:
        kj, vj = kj.astype(jk), vj.astype(jk)
    return np.asarray(jax_decode(jnp.asarray(q), kj, vj, jnp.asarray(idx),
                                 block_k=block_k, impl=impl, **jkw))


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("name", ["dense", "ring_sinks", "gqa", "int8", "fp8",
                                  "nothing"])
def test_flash_decode_matches_jax(name, impl):
    q, k, v, idx, kw, block_k, jk, tk = _case(name)
    got = _run_torch(q, k, v, idx, kw, block_k, tk)
    ref = _run_jax(q, k, v, idx, kw, block_k, jk, impl)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if name == "nothing":
        assert np.all(got == 0.0)


def test_cpu_tensor_takes_the_plain_version_and_does_not_count():
    q, k, v, idx, kw, block_k, _, _ = _case("dense")
    before = flash_decode.launches
    a = _run_torch(q, k, v, idx, kw, block_k, None)
    b = flash_decode_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(idx), block_k=block_k).numpy()
    assert np.array_equal(a, b)
    assert flash_decode.launches == before


def test_plain_version_keeps_q_dtype_and_skips_dead_blocks():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 1, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 64, 2, 16)).astype(np.float32))
    # NaN rows past every cursor are never read (their block is dead)
    k[:, 32:] = float("nan")
    v = k.clone()
    idx = torch.tensor([5, 31], dtype=torch.int32)
    out = flash_decode(q.to(torch.bfloat16), k.to(torch.bfloat16),
                       v.to(torch.bfloat16), idx, block_k=16)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


def test_validation_errors():
    q = torch.zeros(1, 1, 2, 16)
    k = v = torch.zeros(1, 8, 2, 16)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="slot_pos"):
        flash_decode(q, k, v, idx, window=4)
    with pytest.raises(ValueError, match="slot_pos"):
        flash_decode(q, k, v, idx, slot_pos=torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="k_scale"):
        flash_decode(q, k, v, idx, k_scale=torch.zeros(1, 8, 2))
    with pytest.raises(ValueError, match="sinks"):
        flash_decode(q, k, v, idx, sinks=2)
    with pytest.raises(ValueError, match="window must be"):
        flash_decode(q, k, v, idx, window=0,
                     slot_pos=torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="query row"):
        flash_decode(k, k, v, idx)  # Tq=8, not decode-shaped
    with pytest.raises(ValueError, match="multiple"):
        flash_decode(torch.zeros(1, 1, 3, 16), k, v, idx)
    with pytest.raises(ValueError, match=r"idx must be \[B\]"):
        flash_decode(q, k, v, torch.zeros(2, dtype=torch.int32))


def test_cuda_wrapper_checks_before_launch():
    """The CUDA branch refuses what the kernel does not take before it
    builds or launches anything (checked off-card by calling the launch
    helper directly on CPU tensors)."""
    q = torch.zeros(1, 1, 2, 16, dtype=torch.float16)
    k = v = torch.zeros(1, 8, 2, 16, dtype=torch.float16)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fd_mod._launch(q, k, v, idx, None, None, 0, None, None)
    q = torch.zeros(1, 1, 2, 16)
    with pytest.raises(TypeError, match="match q's dtype"):
        fd_mod._launch(q, k.to(torch.bfloat16), v.to(torch.bfloat16), idx,
                       None, None, 0, None, None)
    k8 = torch.zeros(1, 8, 2, 16, dtype=torch.int8)
    with pytest.raises(TypeError, match="k_scale"):
        fd_mod._launch(q, k8, k8, idx, None, None, 0, None, None)
    with pytest.raises(ValueError, match="head_dim"):
        fd_mod._launch(torch.zeros(1, 1, 2, 8), torch.zeros(1, 8, 2, 8),
                       torch.zeros(1, 8, 2, 8), idx, None, None, 0, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        kt = torch.zeros(1, 2, 8, 16).transpose(1, 2)
        fd_mod._launch(q, kt, kt, idx, None, None, 0, None, None)
