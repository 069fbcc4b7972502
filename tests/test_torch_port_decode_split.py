"""Port parity of the dense decode's split-KV schedule on the CPU.

The dense kernel cuts each slot's live rows (up to its cursor; all rows
of a windowed ring) into tiles of ``decode_tile_rows(D)`` rows, the
tiles into ``splits`` runs (``split_tiles``), takes each run's
online-softmax state on its own and merges the states in run order.  Its
plain version, ``flash_decode_split``, is held here to the oracle
(``flash_decode_reference``) at 1, 2, 3, 7 and 16 splits (16: the
kernel's cluster cap, ``MAX_SPLITS``) and to the JAX ``flash_decode``
under the Pallas interpreter and the XLA walk at 7 and 16 splits: a plain cursor, cursor 0 and R - 1, cursors whose live rows end
one short of, on and one past a tile boundary, a windowed ring with
sinks, GQA, and int8 and fp8 caches.  Tolerance atol 1e-5, as in
``test_torch_port_decode.py``: f32 inputs or exactly representable
stored values with f32 scales, p kept in f32 on every side, so only the
order of summation differs (the merge adds one rescale per run).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu.ops.pallas_decode import flash_decode as jax_decode
from fluxdistributed_tpu_torch.ops.flash_decode import (
    MAX_SPLITS, decode_splits, decode_tile_rows, flash_decode_reference,
    flash_decode_split, split_tiles)

ATOL = 1e-5
B, H, D, R = 4, 4, 16, 520
T = decode_tile_rows(D)  # 64: R holds 8 whole tiles and 8 rows
SPLITS = [1, 2, 3, 7, MAX_SPLITS]
CURSORS = {
    "dense": [37, 200, 449, R - 1],
    # live rows T - 1, T and T + 1, and cursor 0 (one live row)
    "boundaries": [T - 2, T - 1, T, 0],
}


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
    """numpy inputs of a case: ``(q, k, v, idx, kw, jk, tk)``."""
    rng = np.random.default_rng(sum(map(ord, "dsplit_" + name)))
    hkv = 2 if name == "gqa" else H
    h = 8 if name == "gqa" else H
    q = rng.normal(size=(B, 1, h, D)).astype(np.float32)
    k = rng.normal(size=(B, R, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, R, hkv, D)).astype(np.float32)
    idx = np.asarray(CURSORS.get(name, CURSORS["dense"]), np.int32)
    kw = {}
    if name == "ring_sinks":
        # pre-wrap, mid, at the end of the first pass, wrapped twice
        idx = np.asarray([2, 150, R - 1, 1500], np.int32)
        kw = dict(slot_pos=_ring_state(R, 4, idx), window=300, sinks=4)
    jk = tk = None
    if name == "int8":
        k = rng.integers(-127, 128, size=k.shape).astype(np.int8)
        v = rng.integers(-127, 128, size=v.shape).astype(np.int8)
        jk, tk = jnp.int8, torch.int8
    elif name == "fp8":
        # values exactly representable in e4m3, held as f32 for numpy
        k = torch.from_numpy(k * 8).to(torch.float8_e4m3fn).float().numpy()
        v = torch.from_numpy(v * 8).to(torch.float8_e4m3fn).float().numpy()
        jk, tk = jnp.float8_e4m3fn, torch.float8_e4m3fn
    if jk is not None:
        for s in ("k_scale", "v_scale"):
            kw[s] = rng.uniform(0.01, 0.1, (B, R, hkv)).astype(np.float32)
    return q, k, v, idx, kw, jk, tk


def _torch_args(q, k, v, idx, kw, tk):
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if tk is not None:
        kt, vt = kt.to(tk), vt.to(tk)
    return (torch.from_numpy(q), kt, vt, torch.from_numpy(idx)), tkw


def _past_cursor_tiles_nan(k, v, idx):
    """Copies with NaN in every tile past each slot's cursor tile: the
    split schedule never reads them (f32 caches only)."""
    k, v = k.copy(), v.copy()
    for b, cur in enumerate(idx):
        k[b, (cur // T + 1) * T:] = np.nan
        v[b, (cur // T + 1) * T:] = np.nan
    return k, v


NAMES = ["dense", "boundaries", "ring_sinks", "gqa", "int8", "fp8"]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", NAMES)
def test_split_and_merge_matches_reference(name, splits):
    q, k, v, idx, kw, _, tk = _case(name)
    args, tkw = _torch_args(q, k, v, idx, kw, tk)
    ref = flash_decode_reference(*args, **tkw).numpy()
    if k.dtype == np.float32 and "window" not in kw:
        kn, vn = _past_cursor_tiles_nan(k, v, idx)
        args, tkw = _torch_args(q, kn, vn, idx, kw, tk)
    got = flash_decode_split(*args, splits=splits, **tkw).numpy()
    assert np.isfinite(got).all()  # no tile past a cursor was read
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("splits", [7, MAX_SPLITS])
@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("name", NAMES)
def test_split_and_merge_matches_jax(name, impl, splits):
    """At 7 splits (the longest slot's 9 tiles in runs of 2) and at the
    cluster cap (16: runs of one tile, the last 7 empty)."""
    q, k, v, idx, kw, jk, tk = _case(name)
    args, tkw = _torch_args(q, k, v, idx, kw, tk)
    got = flash_decode_split(*args, splits=splits, **tkw).numpy()
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    if jk is not None:
        kj, vj = kj.astype(jk), vj.astype(jk)
    ref = np.asarray(jax_decode(jnp.asarray(q), kj, vj, jnp.asarray(idx),
                                impl=impl, **jkw))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_empty_runs_and_dead_slots():
    """A slot whose one live tile leaves every later run empty gives
    bit for bit what one run gives; a slot with nothing attendable (a
    plain cursor of -1, an unwritten ring slot) gives exactly 0 at every
    split count; splits < 1 is refused."""
    q, k, v, idx, kw, _, tk = _case("dense")
    idx = np.asarray([5, -1, 200, T - 1], np.int32)
    args, tkw = _torch_args(q, k, v, idx, kw, tk)
    one = flash_decode_split(*args, splits=1, **tkw)
    for s in SPLITS:
        got = flash_decode_split(*args, splits=s, **tkw)
        assert torch.equal(got[[0, 3]], one[[0, 3]])
        assert torch.equal(got[1], torch.zeros_like(got[1]))
    q, k, v, idx, kw, _, tk = _case("ring_sinks")
    kw["slot_pos"][2] = -1
    args, tkw = _torch_args(q, k, v, idx, kw, tk)
    for s in SPLITS:
        got = flash_decode_split(*args, splits=s, **tkw)
        assert torch.equal(got[2], torch.zeros_like(got[2]))
    with pytest.raises(ValueError, match="splits"):
        flash_decode_split(*args, splits=0, **tkw)


def test_split_counts():
    """Each slot's runs cover its live tiles once, in order, with no more
    runs than asked; the kernel's count fills the card but never exceeds
    the cache's tiles nor the cluster cap (16): lm_small's 8 slots x 12
    heads x 1024 rows (16 tiles of 64 rows) on 132 SMs take 6 runs (576
    CTAs); one slot of a 4096-row cache would ask for 44 and takes 16."""
    for tiles in range(0, 40):
        for splits in range(1, 12):
            runs = split_tiles(tiles, splits)
            assert len(runs) == splits
            covered = [t for t0, t1 in runs for t in range(t0, t1)]
            assert covered == list(range(tiles))
    assert [decode_tile_rows(d) for d in (16, 64, 128, 256)] == [64, 64, 32,
                                                                 16]
    assert decode_splits(8, 12, 1024, 132, 64) == 6
    assert split_tiles(14, 6) == [(0, 3), (3, 6), (6, 9), (9, 12), (12, 14),
                                  (14, 14)]
    assert decode_splits(1, 1, 100, 132, 64) == 2  # never more runs than tiles
    assert decode_splits(64, 32, 1024, 132, 64) == 1
    assert decode_splits(8, 12, 1024, 132, 128) == 6
    # at and above the cluster cap
    assert MAX_SPLITS == 16
    assert decode_splits(1, 12, 1024, 132, 64) == 16  # the tiles, at the cap
    assert decode_splits(8, 4, 1024, 132, 64) == 16  # chip_smoke's GQA
    assert decode_splits(1, 12, 4096, 132, 64) == 16  # asks for 44
    assert decode_splits(1, 1, 4096, 132, 64) == 16  # asks for 64 tiles
    assert decode_splits(1, 1, 4096, 132, 64, cap=8) == 8
