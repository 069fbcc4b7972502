"""Port parity of the paged decode's split-KV schedule on the CPU.

The paged kernel cuts each slot's pages into contiguous runs
(``split_pages``), takes each run's online-softmax state on its own and
merges the states in run order.  Its plain version,
``flash_decode_paged_split``, is held here to the oracle
(``flash_decode_paged_reference``) and to the JAX ``flash_decode_paged``
under the Pallas interpreter and the XLA walk, at 1, 2, 3, 7 and 16
splits (16: the kernel's cluster cap, ``MAX_SPLITS``),
with run boundaries next to unbound pages, a cursor in the first page, a
windowed ring with sinks, and int8 and fp8 pools.  Tolerance atol 1e-5,
as in ``test_torch_port_paged.py``: f32 inputs or exactly representable
stored values with f32 scales, p kept in f32 on every side, so only the
order of summation differs (the merge adds one rescale per run).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu.ops.pallas_decode import (
    flash_decode_paged as jax_decode_paged)
from fluxdistributed_tpu_torch.ops.flash_decode import (
    MAX_SPLITS, flash_decode_paged_reference, flash_decode_paged_split,
    paged_splits, split_pages)

ATOL = 1e-5
B, H, D, BS, NB, PAGES = 4, 4, 16, 4, 64, 14
SPLITS = [1, 2, 3, 7, MAX_SPLITS]


def _ring_state(rows, sinks, cursors):
    sp = np.full((len(cursors), rows), -1, np.int32)
    ring = rows - sinks
    for b, cur in enumerate(cursors):
        for p in range(cur + 1):
            if p < sinks:
                sp[b, p] = p
            elif p > cur - ring:
                sp[b, sinks + (p - sinks) % ring] = p
    return sp


def _case(name):
    """Pools of 64 blocks of 4 rows and 14 pages a slot, scattered by a
    seeded permutation, -1 past each cursor; slot 0's cursor is in its
    first page; slot 1 has unbound pages 4, 7 and 10, each next to a run
    boundary at 7, 3 or 2 splits; NaN in every block no page names, so a
    read of an unbound page would show."""
    rng = np.random.default_rng(sum(map(ord, "split_" + name)))
    hkv = 2 if name == "gqa" else H
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kp = rng.normal(size=(NB, BS, hkv, D)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, hkv, D)).astype(np.float32)
    idx = np.asarray([2, 30, 41, 55], np.int32)
    kw = {}
    if name == "ring_sinks":
        idx = np.asarray([2, 30, 55, 120], np.int32)
        kw = dict(slot_pos=_ring_state(PAGES * BS, 4, idx), window=50,
                  sinks=4)
    pt = rng.permutation(NB)[:B * PAGES].reshape(B, PAGES).astype(np.int32)
    for b in range(B):
        used = ((kw["slot_pos"][b] >= 0).reshape(PAGES, BS).any(1) if kw
                else np.arange(PAGES) * BS <= idx[b])
        pt[b, ~used] = -1
    pt[1, [4, 7, 10]] = -1
    named = np.zeros(NB, bool)
    named[pt[pt >= 0]] = True
    jk = tk = None
    if name == "int8":
        kp = rng.integers(-127, 128, size=kp.shape).astype(np.int8)
        vp = rng.integers(-127, 128, size=vp.shape).astype(np.int8)
        jk, tk = jnp.int8, torch.int8
    elif name == "fp8":
        kp = torch.from_numpy(kp * 8).to(torch.float8_e4m3fn).float().numpy()
        vp = torch.from_numpy(vp * 8).to(torch.float8_e4m3fn).float().numpy()
        jk, tk = jnp.float8_e4m3fn, torch.float8_e4m3fn
    else:
        kp[~named], vp[~named] = np.nan, np.nan
    if jk is not None:
        for s in ("k_scale", "v_scale"):
            sc = rng.uniform(0.01, 0.1, (NB, BS, hkv)).astype(np.float32)
            sc[~named] = np.nan
            kw[s] = sc
    return q, kp, vp, pt, idx, kw, jk, tk


def _torch_args(q, kp, vp, pt, idx, kw, tk):
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    kt, vt = torch.from_numpy(kp), torch.from_numpy(vp)
    if tk is not None:
        kt, vt = kt.to(tk), vt.to(tk)
    return (torch.from_numpy(q), kt, vt, torch.from_numpy(pt),
            torch.from_numpy(idx)), tkw


NAMES = ["dense", "ring_sinks", "gqa", "int8", "fp8"]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", NAMES)
def test_split_and_merge_matches_reference(name, splits):
    q, kp, vp, pt, idx, kw, _, tk = _case(name)
    args, tkw = _torch_args(q, kp, vp, pt, idx, kw, tk)
    got = flash_decode_paged_split(*args, splits=splits, **tkw).numpy()
    ref = flash_decode_paged_reference(*args, **tkw).numpy()
    assert np.isfinite(got).all()  # no unbound page was read
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("splits", [7, MAX_SPLITS])
@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("name", NAMES)
def test_split_and_merge_matches_jax(name, impl, splits):
    """At 7 splits (runs of 2 pages) and at the cluster cap (16 asked:
    14 runs of one page)."""
    q, kp, vp, pt, idx, kw, jk, tk = _case(name)
    args, tkw = _torch_args(q, kp, vp, pt, idx, kw, tk)
    got = flash_decode_paged_split(*args, splits=splits, **tkw).numpy()
    jkw = {n: (jnp.asarray(np.nan_to_num(x)) if isinstance(x, np.ndarray)
               else x) for n, x in kw.items()}
    kj, vj = jnp.asarray(np.nan_to_num(kp)), jnp.asarray(np.nan_to_num(vp))
    if jk is not None:
        kj, vj = kj.astype(jk), vj.astype(jk)
    ref = np.asarray(jax_decode_paged(jnp.asarray(q), kj, vj, jnp.asarray(pt),
                                      jnp.asarray(idx), impl=impl, **jkw))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_split_and_merge_of_a_dead_slot_is_zero():
    """A slot with nothing attendable (every page unbound) gives exactly
    0 whatever the split count; splits < 1 is refused."""
    q, kp, vp, pt, idx, kw, _, tk = _case("dense")
    pt[3, :] = -1
    args, tkw = _torch_args(q, kp, vp, pt, idx, kw, tk)
    for s in SPLITS:
        got = flash_decode_paged_split(*args, splits=s, **tkw)
        assert torch.equal(got[3], torch.zeros_like(got[3]))
    with pytest.raises(ValueError, match="splits"):
        flash_decode_paged_split(*args, splits=0, **tkw)


def test_split_counts():
    """Runs cover every page once, none is empty, and there are no more
    runs than asked; the kernel's count fills the card but never exceeds
    the cluster cap (16): lm_small's 8 slots x 12 heads x 64 pages on
    132 SMs take 6 runs of 11 pages (576 CTAs); one slot of 64 pages
    asks for 64 and takes 16 runs of 4."""
    for pages in range(1, 40):
        for splits in range(1, 12):
            runs, per = split_pages(pages, splits)
            assert runs <= splits and (runs - 1) * per < pages <= runs * per
    assert paged_splits(8, 12, 64, 132) == 6
    assert split_pages(64, 6) == (6, 11)
    assert paged_splits(1, 1, 3, 132) == 3  # never more runs than pages
    assert paged_splits(64, 32, 64, 132) == 1
    # at and above the cluster cap
    assert MAX_SPLITS == 16
    assert paged_splits(8, 4, 64, 132) == 16  # chip_smoke's GQA
    assert paged_splits(1, 1, 64, 132) == 16
    assert split_pages(64, 16) == (16, 4)
    assert paged_splits(1, 12, 256, 132) == 16  # asks for 44
    assert paged_splits(1, 1, 64, 132, cap=8) == 8
