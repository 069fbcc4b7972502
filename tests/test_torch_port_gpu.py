"""The flash-decode kernels (dense and paged) on the card against their
plain versions, and the engine (dense and paged) on the card against
the CPU.  Needs a CUDA GPU (and ``nvcc`` to build the kernel); marked
``gpu`` and skipped elsewhere.  Run on the card with
``python -m pytest --noconftest tests/test_torch_port_gpu.py -q``.

Tolerances: atol 2e-5 for f32 output (same f32 math, summation order
differs); atol 2e-2 for bf16 output (one bf16 ulp at |out| < 4 plus the
f32 differences before the final rounding).
"""

import pytest
import torch

from fluxdistributed_tpu_torch.models import lm_tiny
from fluxdistributed_tpu_torch.models.transformer_lm import quantize_kv
from fluxdistributed_tpu_torch.ops.flash_decode import (
    flash_decode, flash_decode_paged, flash_decode_paged_reference,
    flash_decode_reference)
from fluxdistributed_tpu_torch.serve import LMEngine, Request, Scheduler

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _ring(b, rows, sinks, cursors):
    sp = torch.full((b, rows), -1, dtype=torch.int32)
    ring = rows - sinks
    for bb, cur in enumerate(cursors):
        for p in range(cur + 1):
            if p < sinks:
                sp[bb, p] = p
            elif p > cur - ring:
                sp[bb, sinks + (p - sinks) % ring] = p
    return sp


@pytest.mark.parametrize("variant", ["f32", "bf16", "gqa", "ring", "int8",
                                     "fp8"])
def test_kernel_matches_plain_version(cuda, variant):
    g = torch.Generator().manual_seed(0)
    b, h, hkv, d, r = 4, 8, 8, 64, 300
    if variant == "gqa":
        hkv = 2
    dt = torch.float32 if variant == "f32" else torch.bfloat16
    q = torch.randn(b, 1, h, d, generator=g).to(dt)
    k = torch.randn(b, r, hkv, d, generator=g)
    v = torch.randn(b, r, hkv, d, generator=g)
    idx = torch.tensor([0, 63, 64, 299], dtype=torch.int32)
    kw = {}
    if variant == "ring":
        window, sinks, r = 100, 4, 104
        k, v = k[:, :r].contiguous(), v[:, :r].contiguous()
        idx = torch.tensor([0, 50, 103, 777], dtype=torch.int32)
        kw = dict(slot_pos=_ring(b, r, sinks, idx.tolist()), window=window,
                  sinks=sinks)
    if variant in ("int8", "fp8"):
        k, kw["k_scale"] = quantize_kv(k, variant)
        v, kw["v_scale"] = quantize_kv(v, variant)
    else:
        k, v = k.to(dt), v.to(dt)
    ref = flash_decode_reference(q, k, v, idx, **kw)
    dev = {n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()}
    before = flash_decode.launches
    out = flash_decode(q.to(cuda), k.to(cuda), v.to(cuda), idx.to(cuda), **dev)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    atol = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("config", ["plain", "window_gqa_int8", "fp8",
                                    "chunked"])
def test_engine_on_card_matches_cpu_generate(cuda, config):
    """f32 greedy tokens of the engine on the card (kernel) equal the
    port's generate() on the CPU (plain version)."""
    from fluxdistributed_tpu_torch.models import generate

    kw = dict(vocab=64, depth=2, dim=128, num_heads=4, mlp_dim=256,
              dtype=torch.float32, seed=3)
    ekw, gkw = {}, {}
    if config == "window_gqa_int8":
        kw.update(window=6, sinks=2, num_kv_heads=2)
        ekw, gkw = dict(kv_dtype="int8"), dict(kv_quant="int8")
    elif config == "fp8":
        ekw, gkw = dict(kv_dtype="fp8"), dict(kv_quant="fp8")
    elif config == "chunked":
        ekw = dict(prefill_chunk=4)
    gpu, cpu = lm_tiny(device=cuda, **kw), lm_tiny(device="cpu", **kw)
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6, 5, 4, 3]]
    eng = LMEngine(gpu, max_slots=2, max_len=64, buckets=(16,), **ekw)
    before = flash_decode.launches
    reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
    Scheduler(eng).generate_all(reqs)
    assert flash_decode.launches - before == 2 * eng.decode_steps
    for r, p in zip(reqs, prompts):
        assert r.tokens == generate(cpu, [p], len(p) + 12, **gkw)[0].tolist()


@pytest.mark.parametrize("variant", ["f32", "bf16", "gqa", "ring", "int8",
                                     "fp8"])
def test_paged_kernel_matches_plain_version(cuda, variant):
    """Pages scattered over the pool by a seeded permutation, -1 past each
    cursor and one -1 page inside a live range, block size 16 (and 4 for
    the ring)."""
    g = torch.Generator().manual_seed(1)
    b, h, hkv, d, bs, nb, pages = 4, 8, 8, 64, 16, 128, 12
    if variant == "gqa":
        hkv = 2
    dt = torch.float32 if variant == "f32" else torch.bfloat16
    idx = torch.tensor([0, 63, 64, 191], dtype=torch.int32)
    kw = {}
    if variant == "ring":
        window, sinks, bs, pages = 100, 4, 4, 26  # r_pad 104, ring 100
        idx = torch.tensor([0, 50, 103, 777], dtype=torch.int32)
        kw = dict(slot_pos=_ring(b, pages * bs, sinks, idx.tolist()),
                  window=window, sinks=sinks)
    q = torch.randn(b, 1, h, d, generator=g).to(dt)
    k = torch.randn(nb, bs, hkv, d, generator=g)
    v = torch.randn(nb, bs, hkv, d, generator=g)
    pt = torch.randperm(nb, generator=g)[:b * pages].view(b, pages)
    pt = pt.to(torch.int32).clone()
    for bb in range(b):
        if variant == "ring":
            used = (kw["slot_pos"][bb] >= 0).view(pages, bs).any(1)
        else:
            used = torch.arange(pages) * bs <= idx[bb]
        pt[bb, ~used] = -1
    pt[3, 1] = -1  # an unbound page inside a live range
    if variant in ("int8", "fp8"):
        k, kw["k_scale"] = quantize_kv(k, variant)
        v, kw["v_scale"] = quantize_kv(v, variant)
    else:
        k, v = k.to(dt), v.to(dt)
    ref = flash_decode_paged_reference(q, k, v, pt, idx, **kw)
    dev = {n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()}
    before = flash_decode_paged.launches
    out = flash_decode_paged(q.to(cuda), k.to(cuda), v.to(cuda), pt.to(cuda),
                             idx.to(cuda), **dev)
    torch.cuda.synchronize()
    assert flash_decode_paged.launches == before + 1
    atol = 2e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("config", ["plain", "window_gqa_int8"])
def test_paged_engine_on_card_matches_cpu_generate(cuda, config):
    """f32 greedy tokens of the paged engine on the card (the paged
    kernel) equal the port's generate() on the CPU, with a prefix hit on
    the plain path."""
    from fluxdistributed_tpu_torch.models import generate

    kw = dict(vocab=64, depth=2, dim=128, num_heads=4, mlp_dim=256,
              dtype=torch.float32, seed=3)
    ekw, gkw = {"prefix_cache": True}, {}
    if config == "window_gqa_int8":
        kw.update(window=6, sinks=2, num_kv_heads=2)
        ekw, gkw = dict(kv_dtype="int8"), dict(kv_quant="int8")
    gpu, cpu = lm_tiny(device=cuda, **kw), lm_tiny(device="cpu", **kw)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 5, 4]]
    eng = LMEngine(gpu, max_slots=2, max_len=64, layout="paged",
                   kv_block_size=4, prefill_chunk=4, **ekw)
    before, dense0 = flash_decode_paged.launches, flash_decode.launches
    reqs = [Request(prompt=p, max_new_tokens=12) for p in prompts]
    sched = Scheduler(eng)
    for r in reqs:  # one after the other: the second claims the prefix
        sched.generate_all([r])
    assert flash_decode_paged.launches - before == 2 * eng.decode_steps
    assert flash_decode.launches == dense0
    if config == "plain":
        assert eng.pool_stats()["prefix_cache_hits"] == 2
    for r, p in zip(reqs, prompts):
        assert r.tokens == generate(cpu, [p], len(p) + 12, **gkw)[0].tolist()
