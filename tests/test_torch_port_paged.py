"""Port parity for paged LM serving on the CPU: the block-pool layout, the
paged flash-decode plain version and the paged engine, each held to the
JAX package on the same inputs.

* ``serve/cache_layout.PagedLayout``: the same admit / alloc / register
  / release sequence through the JAX copy and the port's gives equal
  page tables and pool stats after every step.
* ``flash_decode_paged_reference`` against the JAX ``flash_decode_paged``
  under the Pallas interpreter and the XLA walk.  Tolerance atol 1e-5:
  every input is f32 or an exactly representable stored value (int8,
  fp8 e4m3) with f32 scales, both sides keep p in f32, so only the order
  of summation differs.
* The paged engine's greedy tokens equal the JAX package's sequential
  ``generate`` on the same weights (``load_flax_params``), exactly, in
  f32 — the golden tests of ``tests/test_serve_paged.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluxdistributed_tpu.models import generate as jax_generate
from fluxdistributed_tpu.models import lm_tiny as jax_lm_tiny
from fluxdistributed_tpu.ops.pallas_decode import (
    flash_decode_paged as jax_decode_paged)
from fluxdistributed_tpu.serve.cache_layout import (
    PagedLayout as JaxPagedLayout)
from fluxdistributed_tpu_torch.models import (generate, lm_tiny,
                                              load_flax_params,
                                              make_paged_cache)
from fluxdistributed_tpu_torch.ops.flash_decode import (
    flash_decode_paged, flash_decode_paged_reference)
from fluxdistributed_tpu_torch.serve import (LMEngine, PagedLayout, Request,
                                             Scheduler)
from fluxdistributed_tpu_torch.serve.cache_layout import reserved_kv_bytes

fd_mod = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")

ATOL = 1e-5
SMALL = dict(depth=2, dim=64, mlp_dim=128)

# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("seed,prefix", [(0, True), (1, True), (2, False)])
def test_layout_matches_jax(seed, prefix):
    """Random admissions, growth, prompt registration and releases on a
    pool small enough to evict: the port's layout stays equal to the
    JAX package's after every step."""
    rng = np.random.default_rng(seed)
    kw = dict(max_slots=3, rows_per_slot=16, block_size=4, num_blocks=10,
              prefix_cache=prefix)
    ours, ref = PagedLayout(**kw), JaxPagedLayout(**kw)
    base = [7, 1, 4, 9, 2, 6, 5, 3]
    prompts = [base + [11], base + [12, 13], list(base), base[:4] + [20],
               [5, 3], base + [11, 14, 15, 16]]
    slots = [None] * 3  # [prompt, rows bound, max_new]
    for _ in range(80):
        op = int(rng.integers(4))
        live = [s for s in range(3) if slots[s] is not None]
        if op == 0 and None in slots:
            s = slots.index(None)
            p = prompts[int(rng.integers(len(prompts)))]
            new = int(rng.integers(1, 6))
            ok = ours.can_admit(p, new)
            assert ok == ref.can_admit(p, new)
            if ok:
                start = ours.admit(s, p, new)
                assert start == ref.admit(s, p, new)
                slots[s] = [p, start, new]
        elif op == 1 and live:
            s = live[int(rng.integers(len(live)))]
            p, rows, new = slots[s]
            rows = min(rows + int(rng.integers(1, 6)), len(p) + new)
            assert ours.alloc_rows(s, rows) == ref.alloc_rows(s, rows)
            slots[s][1] = rows
        elif op == 2 and live:
            s = live[int(rng.integers(len(live)))]
            if slots[s][1] >= len(slots[s][0]):
                ours.register_prompt(s, slots[s][0])
                ref.register_prompt(s, slots[s][0])
        elif op == 3 and live:
            s = live[int(rng.integers(len(live)))]
            ours.release(s)
            ref.release(s)
            slots[s] = None
        assert ours.slot_pages == ref.slot_pages
        assert ours.stats() == ref.stats()
    assert ours.pool.stats() == ref.pool.stats()


# ---------------------------------------------------------------- kernel


def _ring_state(b, rows, sinks, cursors):
    sp = np.full((b, rows), -1, np.int32)
    ring = rows - sinks
    for bb, cur in enumerate(cursors):
        for p in range(cur + 1):
            if p < sinks:
                sp[bb, p] = p
            elif p > cur - ring:
                sp[bb, sinks + (p - sinks) % ring] = p
    return sp


def _paged_case(name):
    """Pools of 24 blocks of 4 rows, a page table scattered over them by a
    seeded permutation (-1 past each cursor), NaN in every block no
    page names, so a read of an unbound page would show."""
    rng = np.random.default_rng(sum(map(ord, "paged_" + name)))
    b, h, hkv, d, bs, nb, pages = 3, 4, 4, 16, 4, 24, 6
    if name == "gqa":
        h, hkv = 8, 2
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kp = rng.normal(size=(nb, bs, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, hkv, d)).astype(np.float32)
    idx = np.asarray([0, 9, 23], np.int32)
    kw = {}
    if name == "ring_sinks":
        window, sinks, pages = 8, 2, 3  # rows 10 -> r_pad 12, ring 10
        idx = np.asarray([0, 7, 25], np.int32)
        kw = dict(slot_pos=_ring_state(b, pages * bs, sinks, idx),
                  window=window, sinks=sinks)
    pt = rng.permutation(nb)[:b * pages].reshape(b, pages).astype(np.int32)
    for bb in range(b):
        used = (kw["slot_pos"][bb] >= 0).reshape(pages, bs).any(1) \
            if kw else np.arange(pages) * bs <= idx[bb]
        pt[bb, ~used] = -1
    if name == "hole":
        pt[0, :] = -1   # a parked slot: nothing attendable
        pt[2, 2] = -1   # an unbound page inside slot 2's live range
    named = np.zeros(nb, bool)
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
            sc = rng.uniform(0.01, 0.1, (nb, bs, hkv)).astype(np.float32)
            sc[~named] = np.nan
            kw[s] = sc
    return q, kp, vp, pt, idx, kw, jk, tk


def _run_torch(q, kp, vp, pt, idx, kw, tk):
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    kt, vt = torch.from_numpy(kp), torch.from_numpy(vp)
    if tk is not None:
        kt, vt = kt.to(tk), vt.to(tk)
    return flash_decode_paged(torch.from_numpy(q), kt, vt,
                              torch.from_numpy(pt), torch.from_numpy(idx),
                              **tkw).numpy()


@pytest.mark.parametrize("impl", ["interpret", "xla"])
@pytest.mark.parametrize("name", ["dense", "ring_sinks", "gqa", "int8", "fp8",
                                  "hole"])
def test_flash_decode_paged_matches_jax(name, impl):
    q, kp, vp, pt, idx, kw, jk, tk = _paged_case(name)
    got = _run_torch(q, kp, vp, pt, idx, kw, tk)
    assert np.isfinite(got).all()  # no unbound page was read
    jkw = {n: (jnp.asarray(np.nan_to_num(x)) if isinstance(x, np.ndarray)
               else x) for n, x in kw.items()}
    kj, vj = jnp.asarray(np.nan_to_num(kp)), jnp.asarray(np.nan_to_num(vp))
    if jk is not None:
        kj, vj = kj.astype(jk), vj.astype(jk)
    ref = np.asarray(jax_decode_paged(jnp.asarray(q), kj, vj, jnp.asarray(pt),
                                      jnp.asarray(idx), impl=impl, **jkw))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if name == "hole":
        assert np.all(got[0] == 0.0)


def test_paged_cpu_tensor_takes_the_plain_version_and_does_not_count():
    q, kp, vp, pt, idx, kw, _, _ = _paged_case("dense")
    before = flash_decode_paged.launches
    a = _run_torch(q, kp, vp, pt, idx, kw, None)
    b = flash_decode_paged_reference(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pt), torch.from_numpy(idx)).numpy()
    assert np.array_equal(a, b)
    assert flash_decode_paged.launches == before


def test_paged_validation_errors():
    q = torch.zeros(2, 1, 2, 16)
    kp = torch.zeros(4, 4, 2, 16)
    pt = torch.zeros(2, 3, dtype=torch.int32)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="slot_pos"):
        flash_decode_paged(q, kp, kp, pt, idx, window=4)
    with pytest.raises(ValueError, match=r"slot_pos must be \[B, P\*bs\]"):
        flash_decode_paged(q, kp, kp, pt, idx, window=4,
                           slot_pos=torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="page_table"):
        flash_decode_paged(q, kp, kp, pt.long(), idx)
    with pytest.raises(ValueError, match="page_table"):
        flash_decode_paged(q, kp, kp, pt[:1], idx)
    with pytest.raises(ValueError, match="k_pool/v_pool"):
        flash_decode_paged(q, kp, kp[:, :2], pt, idx)
    with pytest.raises(ValueError, match=r"k_scale/v_scale must be \[NB"):
        flash_decode_paged(q, kp, kp, pt, idx, k_scale=torch.zeros(4, 4),
                           v_scale=torch.zeros(4, 4))
    with pytest.raises(ValueError, match="multiple"):
        flash_decode_paged(torch.zeros(2, 1, 3, 16), kp, kp, pt, idx)


def test_paged_cuda_wrapper_checks_before_launch():
    """The CUDA branch refuses what the kernel does not take before it
    builds or launches anything (its launch helper on CPU tensors)."""
    q = torch.zeros(1, 1, 2, 16)
    kp = torch.zeros(4, 4, 2, 16)
    pt = torch.zeros(1, 2, dtype=torch.int32)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="match q's dtype"):
        fd_mod._launch_paged(q, kp.bfloat16(), kp.bfloat16(), pt, idx, None,
                             None, 0, None, None)
    with pytest.raises(TypeError, match="k_scale"):
        k8 = kp.to(torch.int8)
        fd_mod._launch_paged(q, k8, k8, pt, idx, None, None, 0, None, None)
    with pytest.raises(ValueError, match="contiguous"):
        fd_mod._launch_paged(q, kp, kp, torch.zeros(1, 4, dtype=torch.int32)[:, ::2],
                             idx, None, None, 0, None, None)


# ---------------------------------------------------------------- engine


def _pair(vocab=32, **cfg):
    jm = jax_lm_tiny(vocab=vocab, dtype=jnp.float32, **SMALL, **cfg)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 2), np.int32),
                     train=False)["params"]
    tm = lm_tiny(vocab=vocab, dtype=torch.float32, device="cpu", **SMALL,
                 **cfg)
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _jax_refs(jm, params, prompts, new):
    """JAX sequential generate() per prompt; prompts of one length share
    a batched call (one compile per length)."""
    out = {}
    for n in sorted({len(p) for p in prompts}):
        group = [p for p in prompts if len(p) == n]
        toks = np.asarray(jax_generate(jm.clone(decode=True), params,
                                       np.asarray(group, np.int32),
                                       total_len=n + new))
        for p, row in zip(group, toks):
            out[tuple(p)] = [int(t) for t in row]
    return [out[tuple(p)] for p in prompts]


def _paged(tm, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_len", 32)
    kw.setdefault("kv_block_size", 4)
    kw.setdefault("prefill_chunk", 4)
    return LMEngine(tm, layout="paged", **kw)


def _assert_clean_pool(engine):
    ps = engine.pool_stats()
    assert ps["kv_blocks_active"] == 0
    assert ps["kv_blocks_free"] + ps["kv_blocks_cached"] == ps["kv_blocks_total"]
    assert ps["kv_blocks_promised"] == 0


def test_paged_parity_prefix_reuse():
    """Paged + chunked + prefix-hit parity vs the JAX generate() under
    interleaved admissions, the page table updated in place, and the
    block accounting clean after the drain."""
    jm, params, tm = _pair()
    engine = _paged(tm, prefix_cache=True)
    table = engine.cache.page_table.data_ptr()
    sched = Scheduler(engine, max_queue=16)
    sys_prompt = [7, 1, 4, 9, 2, 6, 5, 3]  # two full blocks
    prompts = [sys_prompt + [11], [5, 3],       # miss, miss
               sys_prompt + [13, 8],            # 2-block prefix HIT
               list(sys_prompt),                # aligned-prompt hit (cap)
               sys_prompt[:4] + [20, 21]]       # 1-block prefix hit
    reqs = [Request(prompt=p, max_new_tokens=7) for p in prompts]
    sched.submit(reqs[0]); sched.submit(reqs[1])
    sched.step(); sched.step()
    for r in reqs[2:]:
        sched.submit(r)
    sched.run_until_idle()
    for r, ref in zip(reqs, _jax_refs(jm, params, prompts, 7)):
        assert r.tokens == ref, r.prompt
    assert sched.metrics()["prefix_cache_hits"] > 0
    assert engine.cache.page_table.data_ptr() == table
    stats = engine.compile_stats()
    assert stats["paged_kernel_launches"] == 0  # CPU: the plain version
    assert stats["bind_compiles"] == stats["release_compiles"] == 0
    _assert_clean_pool(engine)


def test_paged_windowed_drift_parity():
    """One slot DECODES while seven prefill round-robin: every decode
    tick drifts the mid-prefill cursors, and the slot_live gate must
    drop their writes (window 4, chunk 2, blocks of 2)."""
    jm, params, tm = _pair(window=4)
    engine = _paged(tm, max_slots=8, max_len=24, kv_block_size=2,
                    prefill_chunk=2)
    sched = Scheduler(engine, max_queue=16)
    rng = np.random.default_rng(11)
    first = Request(prompt=[int(t) for t in rng.integers(0, 32, 3)],
                    max_new_tokens=14)
    sched.submit(first)
    while first.state != "active":
        sched.step()
    rest = [Request(prompt=[int(t) for t in rng.integers(0, 32, 8)],
                    max_new_tokens=4) for _ in range(7)]
    for r in rest:
        sched.submit(r)
    sched.run_until_idle()
    assert first.tokens == _jax_refs(jm, params, [first.prompt], 14)[0]
    refs = _jax_refs(jm, params, [r.prompt for r in rest], 4)
    for r, ref in zip(rest, refs):
        assert r.tokens == ref, r.prompt
    _assert_clean_pool(engine)


@pytest.mark.parametrize("config", ["window_sinks", "gqa", "window_gqa"])
def test_paged_parity_matrix(config):
    cfg = {"window_sinks": {"window": 8, "sinks": 2},
           "gqa": {"num_kv_heads": 2},
           "window_gqa": {"window": 6, "sinks": 1, "num_kv_heads": 2}}
    jm, params, tm = _pair(**cfg[config])
    engine = _paged(tm)
    sched = Scheduler(engine, max_queue=16)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 32, n)]
               for n in (3, 5, 9, 3, 9, 5)]
    reqs = [Request(prompt=p, max_new_tokens=9) for p in prompts]
    sched.submit(reqs[0]); sched.submit(reqs[1])
    sched.step(); sched.step()
    sched.submit(reqs[2]); sched.submit(reqs[3])
    sched.step()
    sched.submit(reqs[4]); sched.submit(reqs[5])
    sched.run_until_idle()
    for r, ref in zip(reqs, _jax_refs(jm, params, prompts, 9)):
        assert r.tokens == ref, (config, r.prompt)
    _assert_clean_pool(engine)


def test_paged_parity_learned_positions():
    jm, params, tm = _pair(use_rope=False, max_len=24)
    engine = _paged(tm, max_slots=2, max_len=24)
    prompts = [[5, 3, 7], [1, 2], [4, 4, 4, 1, 2, 3]]
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    Scheduler(engine).generate_all(reqs)
    for r, ref in zip(reqs, _jax_refs(jm, params, prompts, 6)):
        assert r.tokens == ref


def test_block_accounting_after_eos_and_cancel():
    """Blocks free on EOS and on cancel (the HTTP disconnect path), and
    pool exhaustion backpressures instead of wedging; every finished
    request keeps parity with the port's generate()."""
    tm = lm_tiny(vocab=32, dtype=torch.float32, device="cpu", **SMALL)
    # tiny pool: 8 blocks of 4 rows — two 12-token budgets fill it
    engine = _paged(tm, max_slots=3, kv_blocks=8)
    sched = Scheduler(engine, max_queue=16)
    probe = generate(tm, [[5, 3]], 6)[0].tolist()
    r_eos = Request(prompt=[5, 3], max_new_tokens=8, eos_id=probe[5])
    sched.generate_all([r_eos])
    assert r_eos.generated[-1] == probe[5]
    _assert_clean_pool(engine)
    r1 = Request(prompt=[1, 2, 3], max_new_tokens=9)
    r2 = Request(prompt=[9, 9], max_new_tokens=9)
    sched.submit(r1); sched.submit(r2)
    sched.step(); sched.step()
    assert engine.pool_stats()["kv_blocks_active"] > 0
    sched.cancel(r1)
    sched.cancel(r2)
    sched.step()  # the scheduler loop services the teardown
    assert r1.done.is_set() and r2.done.is_set()
    ps = engine.pool_stats()
    assert ps["kv_blocks_active"] == 0
    assert ps["kv_blocks_free"] == ps["kv_blocks_total"]
    assert int(engine.cache.page_table.max()) == -1
    assert int(engine.cache.slot_live.max()) == 0
    reqs = [Request(prompt=[i, i + 1], max_new_tokens=12) for i in range(4)]
    for r in reqs:
        sched.submit(r)
    saw_waiting = False
    while not sched.idle:
        sched.step()
        if sched.queue_depth > 0 and None in sched.slots:
            saw_waiting = True  # free slot + queued head = pool gating
    for i, r in enumerate(reqs):
        assert r.tokens == generate(tm, [[i, i + 1]], 14)[0].tolist()
    assert saw_waiting
    assert sched.metrics()["requests_cancelled"] == 2
    _assert_clean_pool(engine)


def test_paged_engine_validation():
    tm = lm_tiny(vocab=32, dtype=torch.float32, device="cpu", **SMALL)
    with pytest.raises(ValueError, match="paged"):
        LMEngine(tm, max_slots=1, max_len=8, prefix_cache=True)
    wm = lm_tiny(vocab=32, dtype=torch.float32, device="cpu", window=8,
                 sinks=2, **SMALL)
    with pytest.raises(ValueError, match="window"):
        _paged(wm, prefix_cache=True)
    with pytest.raises(ValueError, match="layout"):
        LMEngine(tm, max_slots=1, max_len=8, layout="blocky")
    with pytest.raises(ValueError, match="kv_block_size"):
        _paged(tm, kv_block_size=0)
    # a request whose worst case exceeds the WHOLE pool is rejected at
    # validation with the fix spelled out
    eng = _paged(tm, kv_blocks=4)
    with pytest.raises(ValueError, match="kv_blocks >= 8"):
        eng.validate_request(4, 28)
    eng.validate_request(4, 8)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "fp8"])
def test_reserved_bytes_equal_prediction(kv_quant):
    """The measured pool bytes (scratch block excluded) equal the
    layout's sizing model, windowed and plain."""
    for cfg in ({}, {"window": 6, "sinks": 1, "num_kv_heads": 2}):
        tm = lm_tiny(vocab=32, dtype=torch.float32, device="cpu", **SMALL,
                     **cfg)
        eng = _paged(tm, kv_blocks=10, kv_dtype=None if kv_quant == "none"
                     else kv_quant)
        kv = eng.kv_cache_bytes()
        assert kv["reserved"] == kv["predicted"] > 0
        assert kv["live"] == 0
        assert eng.cache.k[0].shape[0] == 10 + 1  # the scratch block
        hkv = cfg.get("num_kv_heads", 4)
        assert kv["predicted"] == reserved_kv_bytes(eng.layout, 2, hkv, 16, 4)


def test_make_paged_cache_shapes():
    tm = lm_tiny(vocab=32, dtype=torch.float32, device="cpu", window=6,
                 sinks=1, **SMALL)
    c = make_paged_cache(tm, 3, 32, 4, 9, "int8")
    assert c.page_table.shape == (3, 2) and c.page_table.dtype == torch.int32
    assert c.slot_pos.shape == (3, 8) and int(c.slot_pos.max()) == -1
    assert c.k[0].shape == (10, 4, 4, 16) and c.k[0].dtype == torch.int8
    assert c.k_scale[0].shape == (10, 4, 4) and c.kv_blocks == 9
    with pytest.raises(ValueError, match="block_size"):
        make_paged_cache(tm, 3, 32, 0, 9)


def test_cli_paged_flags():
    """``--paged --kv-block-size --kv-blocks --prefill-chunk
    --prefix-cache`` build a paged engine through the server's stack."""
    from fluxdistributed_tpu_torch.serve.__main__ import (build_parser,
                                                          build_server)

    args = build_parser().parse_args(
        ["--model", "lm_tiny", "--vocab", "64", "--max-slots", "2",
         "--max-len", "64", "--device", "cpu", "--paged",
         "--kv-block-size", "8", "--kv-blocks", "12", "--prefill-chunk",
         "16", "--prefix-cache"])
    server, sched = build_server(args)
    eng = sched.engine
    try:
        assert eng.layout_name == "paged"
        assert eng.prefill_chunk == 16
        assert eng.layout.block_size == 8
        assert eng.layout.pool.num_blocks == 12
        assert eng.layout.prefix_enabled
        req = Request(prompt=list(range(20)), max_new_tokens=4)
        sched.submit(req)
        sched.run_until_idle()
        assert len(req.generated) == 4
        assert eng.pool_stats()["kv_blocks_cached"] == 2  # 2 full blocks
    finally:
        server.close()
    defaults = build_parser().parse_args(["--paged"])
    assert defaults.kv_block_size == 16 and defaults.kv_blocks is None
    assert defaults.prefill_chunk is None and not defaults.prefix_cache


def test_paged_entry_points_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from fluxdistributed_tpu_torch.serve.__main__ import (build_parser,
                                                          build_server)

    args = build_parser().parse_args(["--model", "lm_tiny", "--vocab", "32",
                                      "--paged", "--prefix-cache"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(args)
