"""The hand-written kernels on the card against their plain versions:
flash decode (dense and paged, with the serving engine on the card
against the CPU), flash attention for training (B1 forward, B2/B3
backward, with a train step on the card against the CPU), and the fused
Adam update (B6, with a fused ZeRO-1 step on a one-rank NCCL group
against the CPU).  Needs a CUDA
GPU (and ``nvcc`` to build the kernels); marked ``gpu`` and skipped
elsewhere.  Run on the card with
``python -m pytest --noconftest tests/test_torch_port_gpu.py -q``.

Tolerances: atol 2e-5 for f32 decode output (same f32 math, summation
order differs); atol 2e-2 for bf16 output (one bf16 ulp at |out| < 4 plus
the f32 differences before the final rounding).  Flash attention: O 1e-5
abs in f32 and 2e-2 abs in bf16, LSE 1e-5 abs; gradients element by
element, within 1e-4 abs in f32 and within 1e-5 + 1.6e-2 x |ref| (two
bf16 ulps of each entry) in bf16.  bf16 B1-B3 run on the tensor cores,
whose f32 sums differ from the plain versions' in order only; B2 rounds
ds, and B3 p and ds, to bf16 exactly as the plain version does, and the
rounding audit (every live pair summed again in the plain order) must
find no pair that the flag let through rounding otherwise.  The paged
and dense kernels are split-KV, one launch a call (a cluster of a
(slot, KV head)'s split CTAs merges their partials; no workspace); at 1,
2, 3, 7 and 16 (the cluster cap) splits each holds the same limits
against its plain version and against its plain split-and-merge
version, and GQA with 8 query heads a KV head runs the shared-memory
state.  ``optim.adam`` on the card equals ``fused_adam``'s plain
version bit for bit.
Fused Adam: bitwise (each op rounded as the plain version's op).  The
fused ZeRO-1 step on the card against the CPU: loss 1e-5 relative;
params lr / 10 absolute, because the card sums gradients in another
order and Adam's first update lr * g / (|g| + eps) moves a gradient near
0 by up to lr * |dg| / eps for a gradient difference dg.
The image path (no hand-written kernel: cuDNN and cuBLAS): f32
resnet18 steps on the card (TF32 off) against the CPU, losses 1e-4
relative, params and running stats 1e-3 relative and 1e-5 of each
leaf's scale, eval top-1/top-5 equal; the bf16 resnet50 step finite and
channels-last; ``module_loss_fn`` never writes the model state it is
given.
The device loop and the decode step as CUDA graphs: K graphed steps
(one replay) equal K eager steps bit for bit (losses, params, optimizer
and model state) for SimpleCNN, lm_tiny (flash, dropout, a schedule)
and resnet18 on a one-rank NCCL group; a capture that fails raises and
nothing falls back; the wrappers' launch counts are exact under
replay; the graphed decode step's greedy tokens equal the eager one's,
dense and paged.
The guard and the observation layer: a guarded graphed step keeps the
state it is given (the shadow copy) and a poisoned item's run equals the
clean skip bit for bit; ``Observation.default()`` issues no device sync;
the memory gauges read the card.
Pricing: on fake ``cuda`` tensors each kernel wrapper's shape-only
branch returns its kernel's outputs' shapes and dtypes without a launch
or a count, and the same calls on real tensors launch each kernel once.
Cold start: a prewarmed engine's captured cache is restored in place
and gives a fresh engine's tokens (dense and paged); an AOT manifest
names the kernel library a callable launched and a load hands the
copy to the kernel loader; the strict checks' second call refuses a
host sync and an implicit host-to-device copy.
"""

import importlib
import math

import pytest
import torch

from fluxdistributed_tpu_torch.models import lm_tiny
from fluxdistributed_tpu_torch.models.transformer_lm import quantize_kv
from fluxdistributed_tpu_torch.ops.flash_decode import (
    flash_decode, flash_decode_paged, flash_decode_paged_reference,
    flash_decode_paged_split, flash_decode_reference, flash_decode_split)
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


def _dense_case(variant):
    """The dense kernel's inputs on the CPU: 300 rows (4 tiles of 64 and
    44 rows) with cursors at the first row, on and past a tile boundary
    and at the last row; a 104-row ring for "ring"."""
    g = torch.Generator().manual_seed(0)
    b, h, hkv, d, r = 4, 8, 8, 64, 300
    if variant == "gqa":
        hkv = 2
    if variant == "gqa8":  # G = 8: each warp's state in shared memory
        h, hkv = 16, 2
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
    return (q, k, v, idx), kw


def _on(cuda, kw):
    return {n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()}


@pytest.mark.parametrize("variant", ["f32", "bf16", "gqa", "gqa8", "ring",
                                     "int8", "fp8"])
def test_kernel_matches_plain_version(cuda, variant):
    (q, k, v, idx), kw = _dense_case(variant)
    ref = flash_decode_reference(q, k, v, idx, **kw)
    before = flash_decode.launches
    out = flash_decode(q.to(cuda), k.to(cuda), v.to(cuda), idx.to(cuda),
                       **_on(cuda, kw))
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    atol = 2e-5 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=atol,
                               rtol=0)


def _dense_kernel(cuda, q, k, v, idx, *, splits, slot_pos=None, window=None,
                  sinks=0, k_scale=None, v_scale=None):
    """The dense kernel on the card at a forced split count."""
    fd = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")
    dev = [None if x is None else x.to(cuda)
           for x in (q, k, v, idx, slot_pos, k_scale, v_scale)]
    return fd._launch(*dev[:5], window, sinks, *dev[5:], splits=splits)


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("variant", ["f32", "bf16", "gqa", "gqa8", "ring",
                                     "int8", "fp8"])
def test_kernel_split_counts(cuda, variant, splits):
    """The split-KV dense kernel at 1, 2, 3, 7 and 16 (the cluster cap)
    forced splits against the plain version and against the plain
    split-and-merge version on the CPU at the same count.  At 7 the last
    slot's 5 live tiles take 5 runs of one and leave 2 empty, the second
    slot's 1 tile leaves 6."""
    args, kw = _dense_case(variant)
    ref = flash_decode_reference(*args, **kw)
    split_ref = flash_decode_split(*args, splits=splits, **kw)
    before = flash_decode.launches
    out = _dense_kernel(cuda, *args, splits=splits, **kw)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    atol = 2e-5 if variant == "f32" else 2e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(out.cpu().float(), split_ref.float(),
                               atol=atol, rtol=0)


def test_kernel_dead_slot_is_zero(cuda):
    """A plain cursor of -1 and an unwritten ring slot attend nothing:
    exactly 0 at every split count."""
    (q, k, v, idx), kw = _dense_case("bf16")
    idx = torch.tensor([-1, 63, 64, 299], dtype=torch.int32)
    (rq, rk, rv, ridx), rkw = _dense_case("ring")
    rkw["slot_pos"][2] = -1
    for splits in (1, 2, 3, 7, 16):
        out = _dense_kernel(cuda, q, k, v, idx, splits=splits)
        ring = _dense_kernel(cuda, rq, rk, rv, ridx, splits=splits, **rkw)
        torch.cuda.synchronize()
        assert torch.equal(out[0].cpu(), torch.zeros_like(out[0].cpu()))
        assert torch.equal(ring[2].cpu(), torch.zeros_like(ring[2].cpu()))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_kernel_counts_one_launch_per_call(cuda, layout):
    """One call is one CUDA launch (no combine kernel) and counts one:
    the profiler sees one decode kernel a call on the device, and the
    library's own launch count rises by one a call."""
    from torch.profiler import ProfilerActivity, profile

    fd = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")
    if layout == "dense":
        (q, k, v, idx), _ = _dense_case("bf16")
        args = [x.to(cuda) for x in (q, k, v, idx)]
        kern = flash_decode
    else:
        (q, k, v, pt, idx), _ = _paged_case("bf16")
        args = [x.to(cuda) for x in (q, k, v, pt, idx)]
        kern = flash_decode_paged
    kern(*args)  # built and loaded outside the profile
    torch.cuda.synchronize()
    before, lib0 = kern.launches, fd._kernel().flash_decode_cuda_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kern(*args)
        torch.cuda.synchronize()
    assert kern.launches == before + 3
    assert fd._kernel().flash_decode_cuda_launches() == lib0 + 3
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "flash_decode" in e.name]
    assert len(names) == 3, names
    assert not any("combine" in n for n in names), names


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_kernel_at_the_cluster_cap(cuda, layout):
    """A long cache (one slot of 4096 rows, 4 KV heads) asks for more
    splits than a cluster holds: the launch's count is the cap (16, a
    cluster the card launches at the kernel's shared memory), the output
    matches the plain version, and 17 is refused before any launch."""
    fd = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")
    g = torch.Generator().manual_seed(7)
    b, h, hkv, d, r = 1, 8, 4, 64, 4096
    q = torch.randn(b, 1, h, d, generator=g).bfloat16()
    idx = torch.tensor([4000], dtype=torch.int32)
    if layout == "dense":
        k = torch.randn(b, r, hkv, d, generator=g).bfloat16()
        v = torch.randn(b, r, hkv, d, generator=g).bfloat16()
        args = (q, k, v, idx)
        splits = fd.kernel_plan(q.to(cuda), k.to(cuda))
        ref = flash_decode_reference(*args)
        run = flash_decode
        launch = fd._launch
    else:
        bs = 16
        pages = r // bs
        k = torch.randn(pages + 8, bs, hkv, d, generator=g).bfloat16()
        v = torch.randn(pages + 8, bs, hkv, d, generator=g).bfloat16()
        pt = torch.randperm(pages + 8, generator=g)[:pages].view(1, pages)
        args = (q, k, v, pt.to(torch.int32), idx)
        splits, _ = fd.paged_kernel_plan(q.to(cuda), k.to(cuda),
                                         args[3].to(cuda))
        ref = flash_decode_paged_reference(*args)
        run = flash_decode_paged
        launch = fd._launch_paged
    assert splits == fd.MAX_SPLITS == 16
    dev = [x.to(cuda) for x in args]
    out = run(*dev)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=2e-2,
                               rtol=0)
    before = run.launches
    with pytest.raises(ValueError, match="cluster cap"):
        launch(*dev, None, None, 0, None, None, splits=17)
    assert run.launches == before


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_kernel_call_leaves_no_workspace(cuda, layout):
    """A call allocates its output and nothing else: the allocator's
    bytes rise by the output alone, and its peak by no more."""
    if layout == "dense":
        (q, k, v, idx), _ = _dense_case("bf16")
        args = [x.to(cuda) for x in (q, k, v, idx)]
        kern = flash_decode
    else:
        (q, k, v, pt, idx), _ = _paged_case("bf16")
        args = [x.to(cuda) for x in (q, k, v, pt, idx)]
        kern = flash_decode_paged
    kern(*args)  # built and loaded first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    before = torch.cuda.memory_allocated(cuda)
    out = kern(*args)
    torch.cuda.synchronize()
    size = -(-out.numel() * out.element_size() // 512) * 512  # the block
    assert torch.cuda.memory_allocated(cuda) - before == size
    assert torch.cuda.max_memory_allocated(cuda) - before == size


def test_kernel_error_raises_and_does_not_fall_back(cuda):
    """A launch the card refuses (64 query heads on one KV head at head
    dim 256 in f32 keep their warps' state, the merge's receive buffer
    and q in ~610 KB of shared memory, above the 227 KB a block may have) raises
    the CUDA error; nothing falls back to a plain version, and nothing
    is counted."""
    q = torch.randn(1, 1, 64, 256, device=cuda)
    k = torch.randn(1, 16, 1, 256, device=cuda)
    idx = torch.tensor([15], dtype=torch.int32, device=cuda)
    before = flash_decode.launches
    with pytest.raises(RuntimeError, match="cudaError"):
        flash_decode(q, k, k, idx)
    assert flash_decode.launches == before
    # the error was reported by the call that made it, not the next one
    (q, k, v, idx), _ = _dense_case("f32")
    out = flash_decode(q.to(cuda), k.to(cuda), v.to(cuda), idx.to(cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


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


@pytest.mark.parametrize("variant", ["f32", "bf16", "gqa", "gqa8", "ring",
                                     "int8", "fp8"])
def test_paged_kernel_matches_plain_version(cuda, variant):
    """Pages scattered over the pool by a seeded permutation, -1 past each
    cursor and one -1 page inside a live range, block size 16 (and 4 for
    the ring); the kernel's own split count."""
    args, kw = _paged_case(variant)
    ref = flash_decode_paged_reference(*args, **kw)
    dev = {n: x.to(cuda) if torch.is_tensor(x) else x for n, x in kw.items()}
    before = flash_decode_paged.launches
    out = flash_decode_paged(*(x.to(cuda) for x in args), **dev)
    torch.cuda.synchronize()
    assert flash_decode_paged.launches == before + 1
    atol = 2e-5 if variant == "f32" else 2e-2
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


fa = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")

# name: (B, Tq, Tk, H, Hkv, D, dtype, causal, window, sinks)
ATTN_VARIANTS = {
    "f32": (2, 96, 96, 4, 4, 64, torch.float32, True, None, 0),
    "bf16": (2, 96, 96, 4, 4, 64, torch.bfloat16, True, None, 0),
    "gqa_d32": (2, 80, 80, 4, 2, 32, torch.float32, True, None, 0),
    "window_sinks_d128": (1, 130, 130, 2, 1, 128, torch.float32, True, 5, 2),
    "noncausal_ragged": (2, 100, 70, 2, 2, 128, torch.bfloat16, False, None,
                         0),
    "tq_lt_tk": (2, 24, 96, 4, 4, 64, torch.float32, True, None, 0),
    "fully_masked_rows": (2, 8, 4, 2, 2, 32, torch.float32, True, None, 0),
    "main_bf16": (8, 1024, 1024, 12, 12, 64, torch.bfloat16, True, None, 0),
    "main_gqa_f32": (8, 1024, 1024, 12, 4, 64, torch.float32, True, None, 0),
    "main_window_f32": (8, 1024, 1024, 12, 12, 64, torch.float32, True, 256,
                        4),
    # bf16: the tensor-core kernels B1 and B3
    "bf16_gqa_d32": (2, 80, 80, 4, 2, 32, torch.bfloat16, True, None, 0),
    "bf16_window_sinks_d128": (1, 130, 130, 2, 1, 128, torch.bfloat16, True,
                               5, 2),
    "bf16_tq_lt_tk": (2, 24, 96, 4, 4, 64, torch.bfloat16, True, None, 0),
    "bf16_fully_masked_rows": (2, 8, 4, 2, 2, 32, torch.bfloat16, True, None,
                               0),
    # the Hopper B2/B3 (head dims 64 and 128) on rows with nothing to attend
    "bf16_fully_masked_rows_d64": (2, 8, 4, 2, 2, 64, torch.bfloat16, True,
                                   None, 0),
    "bf16_ragged_t": (2, 77, 77, 4, 2, 64, torch.bfloat16, True, None, 0),
    "main_gqa_bf16": (8, 1024, 1024, 12, 4, 64, torch.bfloat16, True, None,
                      0),
    "main_window_bf16": (8, 1024, 1024, 12, 12, 64, torch.bfloat16, True, 256,
                         4),
    "main_d128_bf16": (8, 1024, 1024, 6, 6, 128, torch.bfloat16, True, None,
                       0),
    # the Hopper B1-B3 (head dims 64, 80 and 128): D = 80 reads each row as
    # a 64-feature and a 16-feature TMA box
    "bf16_noncausal_ragged_d64": (2, 100, 70, 4, 2, 64, torch.bfloat16,
                                  False, None, 0),
    "bf16_gqa_window_sinks_d80": (2, 300, 300, 4, 2, 80, torch.bfloat16,
                                  True, 70, 3),
    "bf16_noncausal_ragged_d80": (2, 100, 70, 4, 4, 80, torch.bfloat16,
                                  False, None, 0),
    "bf16_ragged_t_d80": (2, 77, 77, 4, 2, 80, torch.bfloat16, True, None,
                          0),
    "bf16_tq_lt_tk_d80": (2, 24, 96, 4, 4, 80, torch.bfloat16, True, None,
                          0),
    "bf16_fully_masked_rows_d80": (2, 8, 4, 2, 2, 80, torch.bfloat16, True,
                                   None, 0),
    "bf16_tq_lt_tk_d128": (2, 24, 96, 4, 2, 128, torch.bfloat16, True, None,
                           0),
    "bf16_fully_masked_rows_d128": (2, 8, 4, 2, 2, 128, torch.bfloat16,
                                    True, None, 0),
    "main_d80_gqa_window_bf16": (8, 1024, 1024, 16, 4, 80, torch.bfloat16,
                                 True, 256, 4),
    # the Hopper B2/B3 at D = 80 on ViT-H/14's 257 tokens (a last tile of
    # one row), causal with a window, sinks and GQA 16 / 4
    "bf16_t257_gqa_window_sinks_d80": (4, 257, 257, 16, 4, 80,
                                       torch.bfloat16, True, 100, 4),
}


@pytest.mark.parametrize("variant", list(ATTN_VARIANTS))
def test_flash_attention_kernels_match_plain_versions(cuda, variant):
    b, tq, tk, h, hkv, d, dt, causal, window, sinks = ATTN_VARIANTS[variant]
    g = torch.Generator().manual_seed(0)
    q, do = (torch.randn(b, tq, h, d, generator=g).to(dt).to(cuda)
             for _ in range(2))
    k, v = (torch.randn(b, tk, hkv, d, generator=g).to(dt).to(cuda)
            for _ in range(2))
    kw = dict(causal=causal, window=window, sinks=sinks)
    before = [w.launches for w in (fa.flash_attention_fwd,
                                   fa.flash_attention_dq,
                                   fa.flash_attention_dkv)]
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do.float() * ref_out.float()).sum(-1).permute(0, 2, 1)
    delta = (delta - torch.randn(delta.shape, generator=g).to(cuda)
             ).contiguous()  # an LSE cotangent folded in
    args = (q, k, v, do, ref_lse, delta)
    dq = fa.flash_attention_dq(*args, **kw)
    dk, dv = fa.flash_attention_dkv(*args, **kw)
    refs = (fa.flash_attention_dq_reference(*args, **kw),
            *fa.flash_attention_dkv_reference(*args, **kw))
    torch.cuda.synchronize()
    assert [w.launches for w in (fa.flash_attention_fwd,
                                 fa.flash_attention_dq,
                                 fa.flash_attention_dkv)] == [
        n + 1 for n in before]
    f32 = dt == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=1e-5 if f32 else 2e-2, rtol=0)
    live = ref_lse > -1e29
    assert torch.equal(lse > -1e29, live)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-5, rtol=0)
    # element by element: bf16 within two ulps of each entry (+ a floor
    # near 0), f32 within 1e-4
    atol, rtol = (1e-4, 0.0) if f32 else (1e-5, 1.6e-2)
    for got, ref in zip((dq, dk, dv), refs):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)


def test_flash_attention_on_cuda_never_reaches_the_plain_path(cuda,
                                                               monkeypatch):
    """A CUDA call launches the kernels (each count + 1) and never runs a
    plain version, in f32 (SIMT) and in bf16 (tensor cores for B1/B3)."""
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    for name in ("flash_attention_fwd_reference",
                 "flash_attention_dq_reference",
                 "flash_attention_dkv_reference"):
        monkeypatch.setattr(fa, name, boom)
    for dt in (torch.float32, torch.bfloat16):
        before = [w.launches for w in (fa.flash_attention_fwd,
                                       fa.flash_attention_dq,
                                       fa.flash_attention_dkv)]
        q, k, v = (torch.randn(1, 64, 2, 64, device=cuda, dtype=dt,
                               requires_grad=True) for _ in range(3))
        fa.flash_attention(q, k, v, True).float().sum().backward()
        torch.cuda.synchronize()
        assert [w.launches for w in (fa.flash_attention_fwd,
                                     fa.flash_attention_dq,
                                     fa.flash_attention_dkv)] == [
            n + 1 for n in before]
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(*(torch.zeros(1, 8, 2, 48, device=cuda)
                                 for _ in range(3)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_fwd(*(torch.zeros(1, 8, 2, 64, device=cuda,
                                             dtype=torch.float16)
                                 for _ in range(3)))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_design_table_is_the_librarys(cuda, dt):
    """The wrapper's dispatch table (``kernel_design``) names the design
    the library's launcher runs for every kernel and head dim: bf16 B1,
    B2 and B3 at 64, 80 and 128 on the Hopper kernels, bf16 at 32 on
    mma.sync, f32 on SIMT."""
    lib = fa._kernel()
    for which, kname in enumerate(("fwd", "dq", "dkv")):
        for d in fa._HEAD_DIMS:
            code = lib.flash_attention_design(which, fa._DTYPES[dt], d)
            assert fa.DESIGNS[code] == fa.kernel_design(kname, dt, d)
    assert lib.flash_attention_design(1, fa._DTYPES[dt], 48) == -1


@pytest.mark.parametrize("d", list(fa.HOPPER_BWD_DIMS))
def test_hopper_bwd_is_deterministic_and_refuses_misaligned_views(cuda, d):
    """The Hopper B2/B3 sum without atomics, in a fixed order: two calls
    give the same bits.  A view TMA cannot read (a row stride that is not
    a multiple of 16 bytes) raises before anything is launched, and is
    never copied."""
    g = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn(2, 200, 4, d, generator=g).bfloat16()
                   .to(cuda) for _ in range(4))
    kw = dict(causal=True, window=None, sinks=0)
    out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, delta)
    first = (fa.flash_attention_dq(*args, **kw),
             *fa.flash_attention_dkv(*args, **kw))
    again = (fa.flash_attention_dq(*args, **kw),
             *fa.flash_attention_dkv(*args, **kw))
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    wide = torch.randn(2, 200, 4, d + 4, generator=g).bfloat16().to(cuda)
    skew = wide[..., :d]  # rows (d + 4) * 2 bytes apart
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    for bad in ((skew, k, v, do), (q, k, v, skew)):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_dq(*bad, lse, delta, **kw)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention_dkv(*bad, lse, delta, **kw)
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before


@pytest.mark.parametrize("d", list(fa.HOPPER_FWD_DIMS))
def test_hopper_fwd_is_deterministic(cuda, d):
    """The Hopper B1 sums in a fixed order with no atomics: two calls give
    the same bits (O and LSE), causal with GQA and a ragged T."""
    g = torch.Generator().manual_seed(d)
    q = torch.randn(2, 333, 4, d, generator=g).bfloat16().to(cuda)
    k, v = (torch.randn(2, 333, 2, d, generator=g).bfloat16().to(cuda)
            for _ in range(2))
    assert fa.kernel_design("fwd", torch.bfloat16, d) == fa.DESIGNS[2]
    first = fa.flash_attention_fwd(q, k, v, causal=True)
    again = fa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_lse"])
@pytest.mark.parametrize("case", ["sum", "skewed_q"])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_autograd_takes_expanded_cotangents_and_skewed_views(cuda, fn, case,
                                                             d):
    """A ``.sum()`` loss (autograd's cotangent is expanded: strides of 0)
    and a q view of a [B, T, H, D + 4] tensor (a head stride of 2 D + 8
    bytes, 136 at D = 64) through both autograd functions: the backward
    hands B2/B3 copies they read, and the gradients equal the plain
    versions' on the tensors the backward was given, element by element
    (1e-5 + two bf16 ulps of each entry)."""
    g = torch.Generator().manual_seed(d)
    width = d + 4 if case == "skewed_q" else d
    leaves = [torch.randn(2, 130, 4, w, generator=g).bfloat16().to(cuda)
              .requires_grad_() for w in (width, d, d)]
    q = leaves[0][..., :d]
    seen, inner = [], fa._backward

    def recording(*args):
        out = inner(*args)
        seen.append((args, out))
        return out

    fa._backward = recording
    try:
        if fn == "flash_attention":
            fa.flash_attention(q, *leaves[1:], True).sum().backward()
        else:
            out, lse = fa.flash_attention_lse(q, *leaves[1:], True)
            (out.sum() + lse.sum()).backward()
    finally:
        fa._backward = inner
    torch.cuda.synchronize()
    (q_, k_, v_, o_, lse_, g_, g_lse, _), grads = seen[0]
    assert 0 in g_.stride()
    assert (q_.data_ptr() != q.data_ptr()) == (case == "skewed_q")
    delta = (g_.float() * o_.float()).sum(-1).permute(0, 2, 1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    bargs = (q_, k_, v_, g_, lse_, delta.contiguous())
    refs = (fa.flash_attention_dq_reference(*bargs, causal=True),
            *fa.flash_attention_dkv_reference(*bargs, causal=True))
    for got, ref in zip(grads, refs):
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-5,
                                   rtol=1.6e-2)
    caller = (leaves[0].grad[..., :d], leaves[1].grad, leaves[2].grad)
    for a, b in zip(caller, grads):
        assert torch.equal(a, b)


def test_dropped_tile_control_fails_the_element_wise_check(cuda):
    """The element-wise check (1e-5 + two bf16 ulps of each entry) has
    the power to see one missing tile of the Hopper kernels' sums: dQ
    without its last key tile and dK/dV without the last query tile (the
    plain versions over the rest) fail it against the kernels' outputs,
    which pass it against the full plain versions."""
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 256, 4, 64, generator=g).bfloat16()
                   .to(cuda) for _ in range(4))
    out, lse = fa.flash_attention_fwd_reference(q, k, v)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, do, lse, delta)
    dq = fa.flash_attention_dq(*args)
    dk, dv = fa.flash_attention_dkv(*args)

    def excess(got, ref):
        err, r = (got.float() - ref.float()).abs(), ref.float().abs()
        return (err / (1e-5 + 1.6e-2 * r)).max().item()

    refs = (fa.flash_attention_dq_reference(*args),
            *fa.flash_attention_dkv_reference(*args))
    assert max(excess(a, r) for a, r in zip((dq, dk, dv), refs)) <= 1
    n = fa.TILE_K
    dropped_dq = fa.flash_attention_dq_reference(q, k[:, :-n], v[:, :-n], do,
                                                 lse, delta)
    tail = slice(256 - fa.TILE_Q, None)
    cdk, cdv = fa.flash_attention_dkv_reference(
        q[:, tail], k, v, do[:, tail], lse[..., tail].contiguous(),
        delta[..., tail].contiguous())
    assert excess(dropped_dq, dq) > 1
    assert excess(dk.float() - cdk.float(), dk) > 1
    assert excess(dv.float() - cdv.float(), dv) > 1


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 lm_tiny train step with the flash core: the card (B1-B3)
    against the CPU (their plain versions), same weights and batch."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import TrainState, make_train_step

    toks = np.random.default_rng(0).integers(0, 64, (4, 96)).astype(np.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = lm_tiny(vocab=64, depth=2, dtype=torch.float32, seed=1,
                        attn_fn=attention_core("flash", 32), device=dev)
        opt = optim.momentum(0.05)
        state = TrainState.create(dict(model.named_parameters()), opt)
        state, m = make_train_step(lm_loss_fn(model), opt, guard=True)(
            state, {"tokens": torch.from_numpy(toks).to(dev)})
        out[dev.type] = (m["guard"].cpu(), {k: p.cpu() for k, p in
                                            state.params.items()})
    (gc, pc), (gg, pg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(gg, gc, rtol=1e-5, atol=0)
    for name in pc:
        torch.testing.assert_close(pg[name], pc[name], atol=1e-5, rtol=0)


def _adam_buffers(n, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    p, grad, m = (torch.randn(n, generator=g) for _ in range(3))
    v = torch.randn(n, generator=g).abs() * 1e-2
    return [t.to(dev) for t in (p, grad * 0.1, m * 1e-2, v)]


@pytest.mark.parametrize("n", [1024, 3 * 1024 * 1024 + 4096])
@pytest.mark.parametrize("step", [0, 7])
def test_fused_adam_kernel_bitwise_and_fresh(cuda, n, step):
    """B6 equals its plain version bit for bit; its outputs are new
    buffers and its inputs are left as they were."""
    from fluxdistributed_tpu_torch.ops import fused_adam, fused_adam_plain
    from fluxdistributed_tpu_torch.parallel import fused_adam_update
    from fluxdistributed_tpu_torch.parallel.zero1_fused import _step_scalars

    bufs = _adam_buffers(n, cuda, seed=step)
    keep = [t.clone() for t in bufs]
    before = fused_adam.launches
    out = fused_adam_update(*bufs, step, lr=3e-4)
    sc = _step_scalars(step, 3e-4, 0.9, 0.999).to(cuda)
    ref = fused_adam_plain(*bufs, sc, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 1
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    ptrs = {t.data_ptr() for t in bufs}
    assert all(t.data_ptr() not in ptrs for t in out)
    assert all(torch.equal(a, b) for a, b in zip(bufs, keep))


def test_fused_adam_kernel_refuses_ragged_and_misaligned(cuda):
    from fluxdistributed_tpu_torch.ops import fused_adam
    from fluxdistributed_tpu_torch.parallel import fused_adam_update

    x = torch.zeros(1000, device=cuda)
    with pytest.raises(ValueError, match="pack_tree"):
        fused_adam_update(x, x, x, x, 0)
    with pytest.raises(ValueError, match="divisible by 4"):
        y = torch.zeros(1002, device=cuda)
        fused_adam(y, y, y, y, torch.zeros(3, device=cuda))
    buf = torch.zeros(2048 + 1, device=cuda)
    off = buf[1:1025]  # 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_adam(off, off, off, off, torch.zeros(3, device=cuda))


def test_zero1_fused_step_on_one_nccl_rank_matches_cpu(cuda):
    """One fused ZeRO-1 step of f32 lm_tiny on a one-rank NCCL group
    (B1-B3 and B6 on the card) against the same step on a one-rank gloo
    group on the CPU (plain versions)."""
    import numpy as np

    from fluxdistributed_tpu_torch.mesh import (init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.ops import attention_core, fused_adam
    from fluxdistributed_tpu_torch.parallel import (
        make_train_step_zero1_fused, zero1_fused_state)

    toks = np.random.default_rng(0).integers(0, 64, (4, 96)).astype(np.int32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        mesh = init_distributed(dev.type)
        try:
            model = lm_tiny(vocab=64, depth=2, dtype=torch.float32, seed=1,
                            attn_fn=attention_core("flash", 32), device=dev)
            state = zero1_fused_state(dict(model.named_parameters()), mesh)
            before = fused_adam.launches
            state, m = make_train_step_zero1_fused(
                lm_loss_fn(model), mesh, lr=1e-3)(
                    state, {"tokens": torch.from_numpy(toks).to(dev)})
            launched = fused_adam.launches - before
            out[dev.type] = (m["loss"].item(), {
                k: p.cpu() for k, p in state.params.items()}, launched)
        finally:
            shutdown_distributed()
    (lc, pc, nc), (lg, pg, ng) = out["cpu"], out["cuda"]
    assert (ng, nc) == (1, 0)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for name in pc:
        torch.testing.assert_close(pg[name], pc[name], atol=1e-3 / 10, rtol=0)


def test_adam_on_card_equals_fused_adam_plain_bitwise(cuda):
    """``optim.adam`` on the card divides by its bias corrections as
    tensors on the parameter's device, as the reference divides by
    traced values: its update equals ``fused_adam``'s plain version bit
    for bit (a CPU scalar divisor would be multiplied by its reciprocal
    on CUDA instead)."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.ops import fused_adam_plain
    from fluxdistributed_tpu_torch.parallel.zero1_fused import _step_scalars

    p, g, m, v = _adam_buffers(1 << 20, cuda, seed=3)
    opt = optim.adam(3e-4)
    for step in (0, 7):
        new_p, new_s = opt.update({"w": p}, {"w": g}, {"w": (m, v)}, step)
        sc = _step_scalars(step, 3e-4, 0.9, 0.999).to(cuda)
        ref = fused_adam_plain(p, g, m, v, sc, 0.9, 0.999, 1e-8)
        torch.cuda.synchronize()
        for got, want in zip((new_p["w"], *new_s["w"]), ref):
            assert torch.equal(got, want)


# B2 on the tensor cores (bf16): name -> (B, Tq, Tk, H, Hkv, D, window,
# sinks, with an LSE cotangent), causal
B2_CASES = {
    "main": (8, 1024, 1024, 12, 12, 64, None, 0, False),
    "gqa": (8, 1024, 1024, 12, 4, 64, None, 0, False),
    "window_sinks": (8, 1024, 1024, 12, 12, 64, 256, 4, False),
    "ragged_t1000": (8, 1000, 1000, 12, 12, 64, None, 0, False),
    "lse_cotangent": (8, 384, 1024, 12, 12, 64, None, 0, True),
    "d32": (8, 1024, 1024, 24, 24, 32, None, 0, False),
    "d128": (8, 1024, 1024, 6, 6, 128, None, 0, False),
}


def _b2_inputs(cuda, case, seed=0):
    b, tq, tk, h, hkv, d, window, sinks, with_lse = B2_CASES[case]
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, tq, h, d, generator=g).bfloat16().to(cuda)
             for _ in range(2))
    k, v = (torch.randn(b, tk, hkv, d, generator=g).bfloat16().to(cuda)
            for _ in range(2))
    kw = dict(causal=True, window=window, sinks=sinks)
    out, lse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
    if with_lse:
        delta = delta - torch.randn(delta.shape, generator=g).to(cuda)
    return (q, k, v, do, lse, delta.contiguous()), kw


@pytest.mark.parametrize("case", list(B2_CASES))
def test_b2_tensor_cores_match_plain_version(cuda, case):
    """bf16 dQ (tensor cores) against its plain version, element by
    element within 1e-5 + 1.6e-2 x |ref| (two bf16 ulps of each entry)."""
    args, kw = _b2_inputs(cuda, case)
    before = fa.flash_attention_dq.launches
    dq = fa.flash_attention_dq(*args, **kw)
    ref = fa.flash_attention_dq_reference(*args, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_dq.launches == before + 1
    assert torch.isfinite(dq.float()).all()
    torch.testing.assert_close(dq.float(), ref.float(), atol=1e-5, rtol=1.6e-2)


@pytest.mark.parametrize("case", ["main", "window_sinks", "d128"])
def test_rounding_audit_finds_no_unflagged_mismatch(cuda, case):
    """The audit instantiations of bf16 B2 and B3 sum every live pair in
    the plain order: no pair that the flag let through rounds ds (or, in
    B3, p) to another bf16 value; the audit does not count as a
    launch."""
    args, kw = _b2_inputs(cuda, case, seed=1)
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    counts = fa.rounding_audit(*args, **kw)
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == before
    b, tq, tk, h, hkv = B2_CASES[case][:5]
    for name, c in counts.items():
        assert c["unflagged_differ"] == 0, (name, c)
        assert 0 < c["flagged"] < c["live_pairs"], (name, c)
        assert c["flagged_changed"] <= c["flagged"]
    assert counts["dq"]["live_pairs"] == counts["dkv"]["live_pairs"]


def _paged_case(variant, pages=12, seed=1):
    """The paged kernel's inputs: pages scattered over the pool by a
    seeded permutation, -1 past each cursor and one -1 page inside a live
    range, block size 16 (and 4 for the ring)."""
    g = torch.Generator().manual_seed(seed)
    b, h, hkv, d, bs, nb = 4, 8, 8, 64, 16, 128
    if variant == "gqa":
        hkv = 2
    if variant == "gqa8":  # G = 8: each warp's state in shared memory
        h, hkv = 16, 2
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
    return (q, k, v, pt, idx), kw


def _paged_kernel(cuda, q, k, v, pt, idx, *, splits, slot_pos=None,
                  window=None, sinks=0, k_scale=None, v_scale=None):
    """The paged kernel on the card at a forced split count."""
    fd = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_decode")
    dev = [None if x is None else x.to(cuda)
           for x in (q, k, v, pt, idx, slot_pos, k_scale, v_scale)]
    return fd._launch_paged(*dev[:5], dev[5], window, sinks, *dev[6:],
                            splits=splits)


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("variant", ["f32", "bf16", "gqa", "gqa8", "ring",
                                     "int8", "fp8"])
def test_paged_kernel_split_counts(cuda, variant, splits):
    """The split-KV paged kernel at 1, 2, 3, 7 and 16 (the cluster cap:
    12 runs of one page, the ring's 26 pages in 13 runs of 2) asked
    splits against
    the plain version, and against the plain split-and-merge version on
    the CPU at the same count.  At 7 (6 runs of 2 of the 12 pages; the
    ring's 26 pages in 7 runs of 4) a run boundary falls right after
    slot 3's unbound page 1."""
    args, kw = _paged_case(variant)
    ref = flash_decode_paged_reference(*args, **kw)
    split_ref = flash_decode_paged_split(*args, splits=splits, **kw)
    before = flash_decode_paged.launches
    out = _paged_kernel(cuda, *args, splits=splits, **kw)
    torch.cuda.synchronize()
    assert flash_decode_paged.launches == before + 1
    atol = 2e-5 if variant == "f32" else 2e-2
    torch.testing.assert_close(out.cpu().float(), ref.float(), atol=atol,
                               rtol=0)
    torch.testing.assert_close(out.cpu().float(), split_ref.float(),
                               atol=atol, rtol=0)


def test_paged_kernel_split_boundaries(cuda):
    """Split-boundary cases: a cursor in the first page (every run but the
    first dead), a run that starts on an unbound page, and a slot with no
    bound page at all (exactly 0)."""
    args, kw = _paged_case("bf16", pages=8)
    q, k, v, pt, idx = args
    idx = torch.tensor([5, 63, 64, 127], dtype=torch.int32)
    pt = pt.clone()
    pt[1, 2] = -1  # runs of 2 pages: run 1 starts on an unbound page
    pt[2, :] = -1  # nothing bound: exactly 0
    for splits in (2, 4, 8):
        ref = flash_decode_paged_reference(q, k, v, pt, idx)
        out = _paged_kernel(cuda, q, k, v, pt, idx, splits=splits)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.cpu().float(), ref.float(), atol=2e-2,
                                   rtol=0)
        assert torch.equal(out[2].cpu(), torch.zeros_like(out[2].cpu()))


# ------------------------------------------------- the image path


@pytest.fixture
def no_tf32():
    """f32 convolutions and matmuls in f32 on the card (PyTorch's default
    lets cuDNN run them in TF32), restored afterwards."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _image_batches(n, size, steps, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(n, size, size, 3, generator=g),
             torch.eye(10)[torch.randint(0, 10, (n,), generator=g)])
            for _ in range(steps)]


def test_resnet18_f32_step_on_card_matches_cpu(cuda, no_tf32):
    """Three f32 momentum steps of resnet18 (64², batch 8) on the card
    (cuDNN, TF32 off) and on the CPU from the same seed: losses within
    1e-4 relative, params and running stats within 1e-3 relative and
    1e-5 of each leaf's scale; eval top-1/top-5 equal."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import resnet18
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_eval_step, make_train_step, module_loss_fn)

    batches = _image_batches(8, 64, 4)
    out = {}
    for dev in ("cuda", "cpu"):
        model = resnet18(num_classes=10, dtype=torch.float32, device=dev,
                         seed=1)
        opt = optim.momentum(0.05, 0.9)
        loss_fn = module_loss_fn(model, logitcrossentropy)
        st = TrainState.create(dict(model.named_parameters()), opt,
                               model_state={k: b.clone() for k, b in
                                            model.named_buffers()})
        step = make_train_step(loss_fn, opt)
        losses = []
        for x, y in batches[:3]:
            st, m = step(st, {"image": x.to(dev), "label": y.to(dev)})
            losses.append(m["loss"].item())
        x, y = batches[3]
        _, acc = make_eval_step(loss_fn, topk=(1, 5))(
            st, {"image": x.to(dev), "label": y.to(dev)})
        out[dev] = (losses, {k: v.cpu() for k, v in
                             {**st.params, **st.model_state}.items()},
                    {k: v.item() for k, v in acc.items()})
    (gl, gs, ga), (cl, cs, ca) = out["cuda"], out["cpu"]
    torch.testing.assert_close(torch.tensor(gl), torch.tensor(cl),
                               rtol=1e-4, atol=0)
    for k, v in cs.items():
        torch.testing.assert_close(gs[k], v, rtol=1e-3,
                                   atol=1e-5 * max(1.0, v.abs().max().item()))
    assert ga == ca


def test_resnet50_bf16_step_on_card(cuda):
    """The bf16 resnet50 step at batch 8 and 64²: the stem's output is
    channels-last (the NHWC batch's permute is a view) and the loss is
    finite; the step leaves the model state it was given unchanged."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import resnet50
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (
        TrainState, make_train_step, module_loss_fn)

    model = resnet50(num_classes=10)
    (x, y), = _image_batches(8, 64, 1)
    x, y = x.to(cuda, torch.bfloat16), y.to(cuda)
    with torch.no_grad():
        assert model.stem(x).is_contiguous(memory_format=torch.channels_last)
    opt = optim.momentum(0.01, 0.9)
    ms = {k: b.clone() for k, b in model.named_buffers()}
    before = {k: v.clone() for k, v in ms.items()}
    st = TrainState.create(dict(model.named_parameters()), opt,
                           model_state=ms)
    st, m = make_train_step(module_loss_fn(model, logitcrossentropy), opt)(
        st, {"image": x, "label": y})
    assert torch.isfinite(m["loss"]).item()
    assert all(torch.equal(ms[k], before[k]) for k in ms)
    assert not torch.equal(st.model_state["bn1.running_mean"],
                           before["bn1.running_mean"])
    assert st.params["conv1.weight"].is_contiguous(
        memory_format=torch.channels_last)


def test_module_loss_fn_is_pure_on_card(cuda):
    """``module_loss_fn`` on the card writes nothing into the model state
    it is given, in train and in eval mode."""
    from fluxdistributed_tpu_torch.models import resnet18
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import module_loss_fn

    model = resnet18(num_classes=10, width=16)
    (x, y), = _image_batches(4, 32, 1)
    batch = {"image": x.to(cuda), "label": y.to(cuda)}
    params = {k: p.detach() for k, p in model.named_parameters()}
    ms = {k: b.clone() for k, b in model.named_buffers()}
    before = {k: v.clone() for k, v in ms.items()}
    loss_fn = module_loss_fn(model, logitcrossentropy)
    for train in (True, False):
        _, (new, _) = loss_fn(params, ms, batch, train)
        torch.cuda.synchronize()
        assert all(torch.equal(ms[k], before[k]) for k in ms)
    assert set(new) == set(ms)


def test_sync_batchnorm_on_one_nccl_rank_matches_local(cuda, no_tf32):
    """On a one-rank NCCL group the synchronised BatchNorm (PyTorch's
    SyncBatchNorm kernels and one all-reduce a layer, forward and
    backward) gives the one-device step's loss, gradients and running
    stats: f32 resnet18 at 64², batch 8, within 1e-4 relative (loss)
    and 1e-3 relative and 1e-5 of each leaf's scale."""
    from fluxdistributed_tpu_torch.mesh import (init_distributed,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.models import resnet18
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import local_grads, module_loss_fn

    model = resnet18(num_classes=10, dtype=torch.float32, seed=2)
    (x, y), = _image_batches(8, 64, 1, seed=5)
    batch = {"image": x.to(cuda), "label": y.to(cuda)}
    params = {k: p.detach() for k, p in model.named_parameters()}
    ms = {k: b.clone() for k, b in model.named_buffers()}
    mesh = init_distributed("cuda")
    try:
        out = [local_grads(module_loss_fn(model, logitcrossentropy, m))(
            params, ms, batch, 0) for m in (mesh, None)]
    finally:
        shutdown_distributed()
    (l1, s1, g1), (l0, s0, g0) = out
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=0)
    for a, b in ((g1, g0), (s1, s0)):
        for k, v in b.items():
            torch.testing.assert_close(
                a[k], v, rtol=1e-3, atol=1e-5 * max(1.0, v.abs().max().item()))


# ---------------------------------------------------------- CUDA graphs


def _leaves(tree):
    from fluxdistributed_tpu_torch.tree import leaves

    return leaves(tree)


def _graph_case(case, cuda):
    """(make_state, make_step(k), 2K per-step batches) on the card."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import SimpleCNN, lm_loss_fn
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (TrainState,
                                                    make_train_step,
                                                    module_loss_fn)

    g = torch.Generator().manual_seed(3)
    mesh = None
    if case == "lm_tiny":
        model = lm_tiny(vocab=64, attn_fn=attention_core("flash"),
                        dropout=0.1, seed=1)
        loss_fn = lm_loss_fn(model)
        opt = optim.adam(optim.warmup_cosine(3e-3, 2, 8))
        batches = [{"tokens": torch.randint(0, 64, (4, 128), generator=g,
                                            dtype=torch.int32).to(cuda)}
                   for _ in range(6)]
    else:
        if case == "simplecnn":
            model = SimpleCNN(num_classes=10, seed=1)
            size = 16
        else:
            from fluxdistributed_tpu_torch.mesh import init_distributed
            from fluxdistributed_tpu_torch.models import resnet18

            model, size = resnet18(num_classes=10, seed=1), 64
            mesh = init_distributed("cuda")
        loss_fn = module_loss_fn(model, logitcrossentropy, mesh)
        opt = optim.momentum(0.05, 0.9)
        batches = [{"image": x.to(cuda, torch.bfloat16 if mesh else
                                  torch.float32), "label": y.to(cuda)}
                   for x, y in _image_batches(8, size, 6, seed=4)]

    def make_state():
        return TrainState.create(
            {k: p.detach().clone() for k, p in model.named_parameters()},
            opt, model_state={k: b.clone() for k, b in model.named_buffers()})

    def make_step(k):
        return make_train_step(loss_fn, opt, mesh=mesh, seed=5,
                               steps_per_call=k, guard=True)

    return make_state, make_step, batches


@pytest.mark.parametrize("case", ["simplecnn", "lm_tiny", "resnet18_nccl"])
def test_graphed_steps_equal_eager_steps_bitwise(cuda, case):
    """Two calls of a K=3 step (K eager steps and the capture, then one
    replay) equal 2K eager steps bit for bit; the same replay on a
    zeroed table differs (the graph reads the table)."""
    from fluxdistributed_tpu_torch.mesh import shutdown_distributed
    from fluxdistributed_tpu_torch.tree import tree_map

    try:
        make_state, make_step, batches = _graph_case(case, cuda)
        eager, state, losses = make_step(1), make_state(), []
        for j, b in enumerate(batches):
            state, m = eager(state, b)
            losses.append(m["loss"])
            if j == 2:
                mid = type(state)(*(tree_map(torch.clone, x) for x in (
                    state.params, state.opt_state, state.model_state)),
                    step=state.step)
        graphed = make_step(3)
        stack = [{k: torch.stack([b[k] for b in batches[i:i + 3]])
                  for k in batches[0]} for i in (0, 3)]
        g, m1 = graphed(make_state(), stack[0])
        g, m2 = graphed(g, stack[1])
        assert len(graphed.graphs) == 1
        assert torch.equal(torch.cat([m1["loss"], m2["loss"]]),
                           torch.stack(losses))
        assert g.step == state.step == 6
        for part in ("params", "opt_state", "model_state"):
            for a, b in zip(_leaves(getattr(g, part)),
                            _leaves(getattr(state, part))):
                assert torch.equal(a, b), part
        graphed.table.buffer.zero_()
        c, _ = graphed.run(mid, stack[1], fill=False)
        assert not all(torch.equal(a, b) for a, b in zip(
            _leaves(c.params), _leaves(state.params)))
    finally:
        shutdown_distributed()


def test_launch_counts_exact_under_replay(cuda):
    """B1-B3 count the kernels that ran: the eager call, nothing for the
    capture, each replay's launches."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import TrainState, make_train_step

    fa = importlib.import_module("fluxdistributed_tpu_torch.ops.flash_attention")
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    model = lm_tiny(vocab=64, attn_fn=attention_core("flash"), seed=1)
    opt = optim.adam(1e-3)
    step = make_train_step(lm_loss_fn(model), opt, steps_per_call=2)
    state = TrainState.create(dict(model.named_parameters()), opt)
    toks = torch.randint(0, 64, (2, 2, 128), dtype=torch.int32, device=cuda)
    before = [w.launches for w in wrappers]
    counts = []
    for _ in range(3):
        state, _ = step(state, {"tokens": toks})
        counts.append([w.launches - b for w, b in zip(wrappers, before)])
    d = model.depth
    assert counts == [[2 * d] * 3, [4 * d] * 3, [6 * d] * 3]
    assert step.graphs[0].launches_per_replay == {
        "flash_attention_fwd": 2 * d, "flash_attention_dq": 2 * d,
        "flash_attention_dkv": 2 * d}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_graphed_decode_tokens_equal_eager(cuda, layout):
    """The engine's decode step as a graph replay gives the eager step's
    greedy tokens, and B4/B5 count depth x decode steps."""
    import numpy as np

    model = lm_tiny(vocab=128, seed=2)
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, 128, (n,), generator=g).tolist()
               for n in (5, 17, 40)]
    kern = flash_decode_paged if layout == "paged" else flash_decode
    out = {}
    for graphed in (False, True):
        engine = LMEngine(model, max_slots=3, max_len=96, buckets=(64,),
                          layout=layout, cuda_graph=graphed)
        for s, p in enumerate(prompts):
            engine.prefill(s, p, 0.0, None)
        before = kern.launches
        out[graphed] = np.stack([engine.step_decode() for _ in range(12)])
        assert kern.launches - before == model.depth * 12
        assert engine.compile_stats()["decode_compiles"] == int(graphed)
    np.testing.assert_array_equal(out[True], out[False])


@pytest.mark.parametrize("t", [196, 197])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_attention_at_vit_shapes(cuda, t, dt):
    """B1-B3 non-causal at ViT's sequence lengths (196 patches, 197 with
    the class token: a ragged last tile), 16 heads of 64, q/k/v strided
    views of one [B, T, 3, H, D] projection, which the kernels read in
    place; against the plain versions at the limits above."""
    g = torch.Generator().manual_seed(t)
    q, k, v = torch.randn(4, t, 3, 16, 64, generator=g).to(dt).to(
        cuda).unbind(2)
    do = torch.randn(4, t, 16, 64, generator=g).to(dt).to(cuda)
    assert all(fa._kernel_view(x) is x for x in (q, k, v))
    assert all(a is b for a, b in zip(fa._kernel_views("dq", q, k, v, do),
                                      (q, k, v, do)))
    assert all(a is b for a, b in zip(fa._b1_views(q, k, v), (q, k, v)))
    out, lse = fa.flash_attention_fwd(q, k, v)  # B1 reads them in place
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v)
    delta = (do.float() * ref_out.float()).sum(-1).permute(0, 2, 1)
    args = (q, k, v, do, ref_lse, delta.contiguous())
    got = (fa.flash_attention_dq(*args), *fa.flash_attention_dkv(*args))
    refs = (fa.flash_attention_dq_reference(*args),
            *fa.flash_attention_dkv_reference(*args))
    f32 = dt == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=1e-5 if f32 else 2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    atol, rtol = (1e-4, 0.0) if f32 else (1e-5, 1.6e-2)
    for a, r in zip(got, refs):
        torch.testing.assert_close(a.float(), r.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("t", [256, 257])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_attention_at_vit_h14_shapes(cuda, t, dt):
    """B1-B3 at head dim 80 (ViT-H/14: 1280 / 16), non-causal at 256
    patches and 257 with the class token, q/k/v strided views read in
    place; against the plain versions at the limits above, which take
    the whole sequence as one block (at 128 the last block is one row,
    whose products cuBLAS sums in another order than the sequential one
    the kernels' rounding flag re-sums in)."""
    g = torch.Generator().manual_seed(t)
    q, k, v = torch.randn(4, t, 3, 16, 80, generator=g).to(dt).to(
        cuda).unbind(2)
    do = torch.randn(4, t, 16, 80, generator=g).to(dt).to(cuda)
    assert all(fa._kernel_view(x) is x for x in (q, k, v))
    blk = dict(block_q=512, block_k=512)
    assert all(a is b for a, b in zip(fa._b1_views(q, k, v), (q, k, v)))
    out, lse = fa.flash_attention_fwd(q, k, v)  # B1 reads them in place
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, **blk)
    delta = (do.float() * ref_out.float()).sum(-1).permute(0, 2, 1)
    args = (q, k, v, do, ref_lse, delta.contiguous())
    got = (fa.flash_attention_dq(*args), *fa.flash_attention_dkv(*args))
    refs = (fa.flash_attention_dq_reference(*args, **blk),
            *fa.flash_attention_dkv_reference(*args, **blk))
    f32 = dt == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=1e-5 if f32 else 2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=0)
    atol, rtol = (1e-4, 0.0) if f32 else (1e-5, 1.6e-2)
    for a, r in zip(got, refs):
        torch.testing.assert_close(a.float(), r.float(), atol=atol,
                                   rtol=rtol)


def test_vit_h14_flash_core_refuses_head_dim_80(cuda, no_tf32):
    """ViT-H/14's heads are 1280 / 16 = 80 wide.  The kernels refused
    that head dim until they took it (the name is the test's from then):
    now the flash core's f32 logits and gradients (two blocks, the class
    token's 257 tokens, TF32 off) equal the dense core's on the same
    weights within 1e-4 of the largest logit and 1e-3 of each gradient
    leaf's largest entry, with one launch of each of B1-B3 a block and
    none falling back to the plain versions."""
    from functools import partial

    from fluxdistributed_tpu_torch.models import vit_h14
    from fluxdistributed_tpu_torch.ops import flash_attention
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy

    flash = partial(flash_attention, causal=False)
    model = vit_h14(depth=2, num_classes=10, dtype=torch.float32,
                    use_class_token=True, attn_fn=flash, seed=1)
    x = torch.randn(2, 224, 224, 3, device=cuda)
    y = torch.eye(10, device=cuda)[torch.tensor([3, 7], device=cuda)]
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    out = {}
    for core in (flash, None):
        for blk in model.encoder.layers.values():
            blk.self_attention.attn_fn = core
        model.zero_grad(set_to_none=True)
        before = [w.launches for w in wrappers]
        logits = model(x).float()
        logitcrossentropy(logits, y).backward()
        torch.cuda.synchronize()
        out[core is None] = (logits.detach(), {
            n: p.grad.clone() for n, p in model.named_parameters()},
            [w.launches - b for w, b in zip(wrappers, before)])
    (lf, gf, nf), (ld, gd, nd) = out[False], out[True]
    assert nf == [2, 2, 2] and nd == [0, 0, 0]
    assert (lf - ld).abs().max() <= 1e-4 * ld.abs().max()
    for n in gd:
        assert (gf[n] - gd[n]).abs().max() <= 1e-3 * gd[n].abs().max(), n


@pytest.mark.parametrize("case", ["vit_b16", "convnext_test"])
def test_image_model_graphed_steps_equal_eager_steps_bitwise(cuda, case):
    """ViT-B/16 (224², flash core, dropout 0.1, adamw) and ConvNeXt
    (drop path 0.5, lars) at K = 2: two graphed calls equal four eager
    steps bit for bit; the masks change per step through the table, so
    a replay on a zeroed table differs."""
    from functools import partial

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import convnext_test, vit_b16
    from fluxdistributed_tpu_torch.ops import flash_attention
    from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
    from fluxdistributed_tpu_torch.parallel import (TrainState,
                                                    make_train_step,
                                                    module_loss_fn)

    if case == "vit_b16":
        model = vit_b16(num_classes=10, dropout=0.1, seed=1,
                        attn_fn=partial(flash_attention, causal=False))
        opt, size = optim.adamw(1e-3), 224
    else:
        model = convnext_test(drop_path_rate=0.5, seed=1)
        opt, size = optim.lars(0.1), 64
    loss_fn = module_loss_fn(model, logitcrossentropy)
    batches = [{"image": x.to(cuda, torch.bfloat16), "label": y.to(cuda)}
               for x, y in _image_batches(2, size, 4, seed=6)]

    def make_state():
        return TrainState.create({k: p.detach().clone()
                                  for k, p in model.named_parameters()}, opt)

    eager, state, losses = make_train_step(loss_fn, opt, seed=2), \
        make_state(), []
    for j, b in enumerate(batches):
        state, m = eager(state, b)
        losses.append(m["loss"])
        if j == 1:
            mid = TrainState(params={k: v.clone() for k, v in
                                     state.params.items()},
                             opt_state=_clone_tree(state.opt_state),
                             model_state={}, step=state.step)
    graphed = make_train_step(loss_fn, opt, seed=2, steps_per_call=2)
    stack = [{k: torch.stack([b[k] for b in batches[i:i + 2]])
              for k in batches[0]} for i in (0, 2)]
    g, m1 = graphed(make_state(), stack[0])
    g, m2 = graphed(g, stack[1])
    assert torch.equal(torch.cat([m1["loss"], m2["loss"]]),
                       torch.stack(losses))
    for k, v in state.params.items():
        assert torch.equal(g.params[k], v), k
    graphed.table.buffer.zero_()
    c, _ = graphed.run(mid, stack[1], fill=False)
    assert not all(torch.equal(c.params[k], v)
                   for k, v in state.params.items())


def _clone_tree(tree):
    from fluxdistributed_tpu_torch.tree import tree_map

    return tree_map(torch.clone, tree)


def test_graphed_preempt_and_resume_equal_uninterrupted_bitwise(
        cuda, tmp_path):
    """SimpleCNN at steps_per_call 2 (each call one graph replay): 4
    items uninterrupted against 4 items SIGTERMed by the fault plan at
    item 2, checkpointed and resumed in a fresh task: every loss and
    every state tensor equal."""
    from fluxdistributed_tpu_torch import faults, optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.train import (NullLogger,
                                                 prepare_training,
                                                 resume_training, train)
    from fluxdistributed_tpu_torch.tree import leaves

    def task():
        ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(16, 16, 3))
        return prepare_training(SimpleCNN(num_classes=10, seed=0), ds,
                                optim.momentum(0.05, 0.9), batch_size=8,
                                cycles=8, steps_per_call=2, topk=())

    def state_of(t):
        return leaves((t.state.params, t.state.opt_state,
                       t.state.model_state))

    base = task()
    train(base, print_every=0, eval_every=0, logger=NullLogger())
    assert base.step_fn.graphs
    head = task()
    faults.install_plan(faults.FaultPlan().sigterm_at_step(2))
    try:
        with pytest.raises(faults.Preempted):
            train(head, print_every=0, eval_every=0, logger=NullLogger(),
                  checkpoint_dir=str(tmp_path), checkpoint_every=0,
                  handle_signals=True)
    finally:
        faults.clear_plan()
    tail = task()
    assert resume_training(tail, str(tmp_path))["next_item"] == 2
    train(tail, print_every=0, eval_every=0, logger=NullLogger(),
          checkpoint_dir=str(tmp_path), checkpoint_every=0)
    assert head.losses + tail.losses == base.losses
    assert tail.state.step == base.state.step == 8
    for a, b in zip(state_of(tail), state_of(base)):
        assert torch.equal(a, b)


def _guarded_cnn_task(guard=True, cycles=8):
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.data import SyntheticDataset
    from fluxdistributed_tpu_torch.models import SimpleCNN
    from fluxdistributed_tpu_torch.train import prepare_training

    ds = SyntheticDataset(nsamples=64, nclasses=10, shape=(16, 16, 3))
    return prepare_training(SimpleCNN(num_classes=10, seed=0), ds,
                            optim.momentum(0.05, 0.9), batch_size=8,
                            cycles=cycles, steps_per_call=2, topk=(),
                            guard=guard)


def test_guard_shadow_state_survives_a_poisoned_replay(cuda):
    """A guarded graphed step (steps_per_call 2) keeps the state it is
    given: after a replay on the graph's own tensors the given state
    still holds the pre-step values (the shadow), where an unguarded
    replay marks its state donated.  A guarded run with a NaN planted
    in item 2's gradient sentinel equals the clean run that skips item
    2, bit for bit."""
    from fluxdistributed_tpu_torch import faults
    from fluxdistributed_tpu_torch.parallel.graphs import state_donated
    from fluxdistributed_tpu_torch.train import GuardConfig, NullLogger, train
    from fluxdistributed_tpu_torch.tree import leaves

    def state_of(st):
        return leaves((st.params, st.opt_state, st.model_state))

    t = _guarded_cnn_task()
    batch = next(iter(t.loader))
    st, _ = t.step_fn(t.state, batch)  # eager warm-up, then the capture
    st, _ = t.step_fn(st, batch)       # a replay: st is the graph's own
    before = [x.clone() for x in state_of(st)]
    new, m = t.step_fn(st, batch)
    assert m["guard"].shape == (2, 2) and not state_donated(st)
    assert all(torch.equal(a, b) for a, b in zip(state_of(st), before))
    assert not all(torch.equal(a, b) for a, b in zip(state_of(new), before))
    u = _guarded_cnn_task(guard=False)
    us, _ = u.step_fn(u.state, batch)
    u.step_fn(us, batch)
    assert state_donated(us)

    clean = _guarded_cnn_task()
    train(clean, print_every=0, eval_every=0, logger=NullLogger(),
          guard=GuardConfig(quarantine=(2,)))
    hit = _guarded_cnn_task()
    faults.install_plan(faults.FaultPlan.from_spec({"fail": [
        {"site": "train.grad", "at": 2, "action": "nan"}]}))
    try:
        train(hit, print_every=0, eval_every=0, logger=NullLogger(),
              guard=GuardConfig())
    finally:
        faults.clear_plan()
    assert hit.quarantined_items == [2] and hit.losses == clean.losses
    assert all(torch.equal(a, b) for a, b in zip(state_of(hit.state),
                                                 state_of(clean.state)))


def test_observation_default_issues_no_device_sync(cuda, monkeypatch):
    """Once the graph is captured, a train() with Observation.default()
    calls torch.cuda.synchronize zero times; Observation.full() once an
    item (its device phase)."""
    from fluxdistributed_tpu_torch.obs import Observation, Registry
    from fluxdistributed_tpu_torch.train import NullLogger, train

    t = _guarded_cnn_task(guard=False)
    train(t, print_every=0, eval_every=0, logger=NullLogger())  # captures
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for obs, want in ((Observation.default(), 0),
                      (Observation.full(registry=Registry()), 4)):
        calls.clear()
        t.loader.start = 0
        train(t, print_every=0, eval_every=0, logger=NullLogger(),
              observation=obs)
        assert len(calls) == want


def test_hbm_gauges_read_the_card(cuda):
    from fluxdistributed_tpu_torch.obs import HbmGauges, Registry, memstats

    block = torch.empty(256 << 20, dtype=torch.uint8, device=cuda)
    reg = Registry()
    g = HbmGauges(reg)
    assert g.available and reg.value("fdtpu_hbm_available") == 1
    (dev,) = memstats.hbm_device_stats()
    total = torch.cuda.mem_get_info()[1]
    assert dev["bytes_limit"] == total and dev["bytes_in_use"] >= 256 << 20
    assert dev["peak_bytes_in_use"] >= dev["bytes_in_use"]
    text = reg.prometheus_text()
    assert f'fdtpu_hbm_bytes_in_use{{device="{dev["device"]}"}}' in text
    assert 0.0 < memstats.min_headroom_ratio() < 1.0
    del block
    g.close()


def test_ring_shift_and_all_to_all_send_nothing_on_one_nccl_rank(
        cuda, monkeypatch):
    """On a one-rank NCCL mesh the ring shift, the all_to_all and the
    gradient-carrying mean are the identity and ask NCCL for nothing
    (no send to its own rank); the flash ring over one seq rank is
    ``flash_attention``, forward and gradients bit for bit."""
    import torch.distributed as dist

    from fluxdistributed_tpu_torch.mesh import make_mesh, shutdown_distributed
    from fluxdistributed_tpu_torch.ops import flash_attention
    from fluxdistributed_tpu_torch.parallel.collectives import (
        all_to_all, pmean_grad, ring_shift_start)
    from fluxdistributed_tpu_torch.parallel.context import (
        ring_flash_attention)

    try:
        mesh = make_mesh({"data": 1, "seq": 1}, device="cuda")

        def refuse(*a, **k):
            raise AssertionError("a one-rank group sent something")

        for name in ("batch_isend_irecv", "all_to_all_single", "all_reduce"):
            monkeypatch.setattr(dist, name, refuse)
        x = torch.randn(4, 8, device=cuda, requires_grad=True)
        (y,) = ring_shift_start([x], mesh, "seq").wait()
        assert y is x
        assert all_to_all(x, mesh, "seq", 0, 1) is x
        assert pmean_grad(x, mesh, "seq") is x
        g = torch.Generator().manual_seed(3)
        q, k, v, do = (torch.randn(2, 256, 4, 64, generator=g).bfloat16()
                       .to(cuda) for _ in range(4))
        grads = []
        for fn in (lambda a, b, c: ring_flash_attention(a, b, c, mesh, "seq",
                                                       causal=True),
                   lambda a, b, c: flash_attention(a, b, c, True)):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves)
            out.backward(do)
            grads.append([out.detach()] + [t.grad for t in leaves])
        for a, b in zip(*grads):
            assert torch.equal(a, b)
    finally:
        monkeypatch.undo()
        shutdown_distributed()


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_flash_attention_lse_backward_with_lse_cotangent_matches_plain(
        cuda, dt, monkeypatch):
    """``flash_attention_lse``'s backward with a nonzero LSE cotangent:
    the cotangent reaches ``_backward``, folds into delta, and B2/B3
    (one launch each) equal their plain versions fed the same inputs,
    element by element: bf16 within 1e-5 + two bf16 ulps of each entry,
    f32 within 1e-4."""
    from fluxdistributed_tpu_torch.ops import flash_attention_lse

    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(2, 192, 4, 64, generator=g).to(dt).to(cuda)
                   for _ in range(4))
    gl = torch.randn(2, 4, 192, generator=g).to(cuda)
    seen = []
    inner = fa._backward

    def recording(*args):
        out = inner(*args)
        seen.append((args, out))
        return out

    monkeypatch.setattr(fa, "_backward", recording)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (fa.flash_attention_dq.launches, fa.flash_attention_dkv.launches)
    out, lse = flash_attention_lse(*leaves, True, 64, 64)
    torch.autograd.backward((out, lse), (do, gl))
    torch.cuda.synchronize()
    assert (fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches) == tuple(n + 1 for n in before)
    (q_, k_, v_, o_, lse_, g_, g_lse, cfg), (dq, dk, dv) = seen[0]
    assert torch.equal(g_lse, gl)
    delta = ((g_.float() * o_.float()).sum(-1).permute(0, 2, 1)
             - g_lse.float()).contiguous()
    kw = dict(causal=True, window=None, sinks=0)
    args = (q_, k_, v_, g_, lse_, delta)
    refs = (fa.flash_attention_dq_reference(*args, **kw),
            *fa.flash_attention_dkv_reference(*args, **kw))
    atol, rtol = (1e-4, 0.0) if dt == torch.float32 else (1e-5, 1.6e-2)
    for got, ref, leaf in zip((dq, dk, dv), refs, leaves):
        assert torch.equal(got, leaf.grad)
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), ref.float(), atol=atol,
                                   rtol=rtol)


def test_graph_capture_failure_raises_without_fallback(cuda):
    """A step that synchronises with the host (``.item()``) runs
    eagerly, but its capture raises naming the line; no graph is kept,
    and the card works on.  Last in the file: a failed capture may leave
    the default CUDA generator in capture mode."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.parallel import TrainState, make_train_step

    model = lm_tiny(vocab=64, depth=1, seed=1)
    inner = lm_loss_fn(model)

    def syncing_loss(params, mstate, batch, train, rng=None):
        loss, aux = inner(params, mstate, batch, train, rng)
        if loss.item() < 0:  # a host sync: illegal under capture
            raise AssertionError
        return loss, aux

    opt = optim.momentum(0.05)
    step = make_train_step(syncing_loss, opt, steps_per_call=2)
    state = TrainState.create(dict(model.named_parameters()), opt)
    toks = torch.randint(0, 64, (2, 2, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA graph capture of the train "
                       r"step \(2 steps\) failed at .*loss.item\(\)"):
        step(state, {"tokens": toks})
    assert step.graphs == []
    assert torch.ones(3, device=cuda).sum().item() == 3.0


def _sharded_lm_runs(modes, steps=3, opt=None):
    """lm_tiny (bf16, flash B1-B3; ``opt``, adam 1e-3 by default) from
    one seed through the one-device DP step and, on one NCCL rank,
    through each sharded ``mode`` (``prepare_training`` keywords): each
    run's losses and global params."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import shutdown_distributed
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel.fsdp import gather_state
    from fluxdistributed_tpu_torch.train import prepare_training

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (steps, 4, 128)).astype(np.int64)).cuda()

    class Bank:
        def batch(self, rng, n):
            return rng.integers(0, 256, (n, 128), dtype=np.int32)

    out = {}
    for name, kw in [("dp", {}), *modes]:
        model = lm_tiny(attn_fn=attention_core("flash"), seed=0)
        try:
            mesh = kw.pop("mesh", lambda: None)()
            # the pipeline modes train on their own next-token loss
            own = kw.get("spmd") not in ("pp", "pp_1f1b")
            task = prepare_training(model, Bank(), opt or optim.adam(1e-3),
                                    loss_fn=lm_loss_fn(model) if own
                                    else None, batch_size=4,
                                    cycles=steps, mesh=mesh, **kw)
            state, losses = task.state, []
            for i in range(steps):
                state, m = task.step_fn(state, {"tokens": toks[i]})
                losses.append(m["loss"].item())
            params = state.params if task.specs is None else gather_state(
                state.params, task.specs.params, task.mesh)
            if task.merge_params is not None:  # a pipeline's split tree
                params = task.merge_params(params)
            out[name] = (losses, {k: v.float().cpu()
                                  for k, v in params.items()})
        finally:
            shutdown_distributed()
    return out


def test_fsdp_and_dp_layout_equal_dp_bitwise_on_one_nccl_rank(cuda):
    """FSDP and the all-size-1 dp_fsdp_tp layout on one NCCL rank: every
    collective is a copy, so each equals the one-device step bit for
    bit (losses and params after 3 steps)."""
    from fluxdistributed_tpu_torch.mesh import data_mesh
    from fluxdistributed_tpu_torch.parallel.layout import Layout

    runs = _sharded_lm_runs([
        ("fsdp", {"spmd": "fsdp", "mesh": lambda: data_mesh(device="cuda")}),
        ("layout", {"layout": Layout("dp_fsdp_tp", 1, 1, 1),
                    "device": "cuda"})])
    for name in ("fsdp", "layout"):
        assert runs[name][0] == runs["dp"][0], name
        for k, v in runs["dp"][1].items():
            assert torch.equal(runs[name][1][k], v), (name, k)


def test_tp_on_one_nccl_rank_matches_dp(cuda):
    """``spmd="tp"`` and ``"fsdp_tp"`` on ``{data: 1, model: 1}``: the
    row-parallel bias is added after the (one-term) sum, two bf16
    roundings where DP's fused GEMM bias makes one, so losses within
    1e-2 relative and params within 6 lr (Adam moves an element about
    lr a step)."""
    from fluxdistributed_tpu_torch.mesh import make_mesh

    def mm():
        return make_mesh({"data": 1, "model": 1}, device="cuda")

    runs = _sharded_lm_runs([("tp", {"spmd": "tp", "mesh": mm}),
                             ("fsdp_tp", {"spmd": "fsdp_tp", "mesh": mm})])
    for name in ("tp", "fsdp_tp"):
        for a, b in zip(runs[name][0], runs["dp"][0]):
            assert abs(a - b) <= 1e-2 * abs(b), (name, a, b)
        for k, v in runs["dp"][1].items():
            err = (runs[name][1][k] - v).abs().max().item()
            assert err <= 6e-3, (name, k, err)


def test_sharded_checkpoint_round_trip_on_card(cuda, tmp_path):
    """An FSDP state on one NCCL rank saved at global shapes and
    restored onto the blocks, bit for bit."""
    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import (data_mesh,
                                                shutdown_distributed)
    from fluxdistributed_tpu_torch.parallel import TrainState, fsdp
    from fluxdistributed_tpu_torch.train.checkpoint import (load_checkpoint,
                                                            save_checkpoint)
    from fluxdistributed_tpu_torch.tree import leaves

    model = lm_tiny(seed=0)
    try:
        mesh = data_mesh(device="cuda")
        st = TrainState.create(dict(model.named_parameters()),
                               optim.adam(1e-3))
        specs = fsdp.fsdp_specs(st, mesh)
        st = fsdp.shard_state(st, specs, mesh)
        save_checkpoint(st, str(tmp_path), 0, mesh=mesh, specs=specs)
        back = load_checkpoint(str(tmp_path), st, mesh=mesh, specs=specs)
        for a, b in zip(leaves(st.params) + leaves(st.opt_state),
                        leaves(back.params) + leaves(back.opt_state)):
            assert a.is_cuda and torch.equal(a, b)
    finally:
        shutdown_distributed()


# A probe step descends at this rate, a power of two, so that (p0 - p1)
# / rate is its gradient to f32 rounding; the pipelines' gradients are
# held to DP's within PROBE_RTOL on every leaf by relative norm
PROBE_LR = 1024.0
PROBE_RTOL = 5e-2


def _worst_leaf_rel_err(grads, ref):
    return max(((grads[k].float() - r.float()).norm()
                / r.float().norm()).item() for k, r in ref.items())


def _probe_grads(params, p0):
    return {k: (p0[k] - v.float().cpu()) / PROBE_LR
            for k, v in params.items()}


def _tiny_init():
    return {k: p.detach().float().cpu()
            for k, p in lm_tiny(seed=0).named_parameters()}


def _dp_grads(tokens, M=1):
    """The DP loss's gradient (lm_tiny, bf16, flash; autograd through
    ``lm_loss_fn``) on each of ``M`` row slices of ``tokens``, on the
    CPU in f32."""
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.ops import attention_core

    model = lm_tiny(attn_fn=attention_core("flash"), seed=0)
    fn = lm_loss_fn(model)
    params = {k: p.detach().requires_grad_(True)
              for k, p in model.named_parameters()}
    return [{k: g.float().cpu() for k, g in zip(params, torch.autograd.grad(
        fn(params, {}, {"tokens": rows}, True)[0], list(params.values())))}
        for rows in tokens.chunk(M)]


def _dropped_microbatch_reading(tokens, M):
    """What the probe check reads when a pipeline drops a microbatch:
    the DP loss's gradient on ``M`` row slices of ``tokens``, summed
    over the first M - 1 against all M."""
    gs = _dp_grads(tokens, M)
    return _worst_leaf_rel_err(
        {k: sum(g[k] for g in gs[:-1]) for k in gs[0]},
        {k: sum(g[k] for g in gs) for k in gs[0]})


def test_gpipe_on_one_nccl_rank_matches_dp(cuda):
    """``spmd="pp"`` (GPipe, 2 microbatches) on ``{data: 1, pipe: 1}``
    against the one-device DP step: the half-batch GEMMs and the
    gradient sum over the microbatches round apart in bf16, so losses
    within 1e-4 relative and params within 6 lr after 3 adam steps (a
    cap: Adam moves an element about lr a step), and a probe step's
    gradient within ``PROBE_RTOL`` of DP's, a limit that a dropped
    microbatch's gradient (read here) and a doubled cotangent (1)
    exceed."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import make_mesh

    def pp():
        return ("pp", {
            "spmd": "pp", "num_microbatches": 2,
            "mesh": lambda: make_mesh({"data": 1, "pipe": 1},
                                      device="cuda")})

    runs = _sharded_lm_runs([pp()])
    for a, b in zip(runs["pp"][0], runs["dp"][0]):
        assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    for k, v in runs["dp"][1].items():
        err = (runs["pp"][1][k] - v).abs().max().item()
        assert err <= 6e-3, (k, err)
    probe = _sharded_lm_runs([pp()], steps=1,
                             opt=optim.descent(PROBE_LR))
    p0 = _tiny_init()
    err = _worst_leaf_rel_err(_probe_grads(probe["pp"][1], p0),
                              _probe_grads(probe["dp"][1], p0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 4, 128)).astype(np.int64)).cuda()[0]
    fault = _dropped_microbatch_reading(toks, 2)
    assert err <= PROBE_RTOL < fault, (err, fault)


@pytest.mark.parametrize("interleave", [False, True])
def test_1f1b_and_zb_on_the_local_exchange_bitwise_on_card(cuda, interleave):
    """lm_tiny (bf16, flash) at S = 2, M = 4 with both pipe devices in
    one process: zb equals 1F1B bit for bit over 2 steps, B1-B3 launch
    as the timetable says (4 blocks: 1F1B 32/16/16 a step, zb
    48/32/32), and a 1F1B probe step's gradient is within
    ``PROBE_RTOL`` of DP's, a limit that a dropped microbatch's
    gradient (read here) exceeds."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import lm_pp_1f1b
    from fluxdistributed_tpu_torch.models.transformer_lm import (
        pp_merge_params)
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import (LocalPipe, TrainState,
                                                    make_train_step_1f1b)

    fa = importlib.import_module(
        "fluxdistributed_tpu_torch.ops.flash_attention")

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 8, 128)).astype(np.int64)).cuda()
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_dq,
                fa.flash_attention_dkv)
    out = {}

    def make_step(schedule, opt):
        model = lm_tiny(attn_fn=attention_core("flash"), seed=0)
        w = lm_pp_1f1b(model, LocalPipe(2), interleave=interleave)
        state = TrainState.create(
            w.split_params(dict(model.named_parameters())), opt)
        return state, make_train_step_1f1b(
            *w.fns, opt, LocalPipe(2), num_microbatches=4,
            interleave=w.interleave, schedule=schedule)

    for schedule in ("1f1b", "zb"):
        state, step = make_step(schedule, optim.adam(1e-3))
        for f in wrappers:
            f.launches = 0
        losses = []
        for i in range(2):
            state, m = step(state, {"tokens": toks[i]})
            losses.append(m["loss"].item())
        out[schedule] = (losses, state.params,
                         [f.launches // 2 for f in wrappers])
    assert out["1f1b"][2] == [32, 16, 16]
    assert out["zb"][2] == [48, 32, 32]
    assert out["zb"][0] == out["1f1b"][0]
    for k, v in out["1f1b"][1].items():
        assert torch.equal(out["zb"][1][k], v), k
    state, step = make_step("1f1b", optim.descent(PROBE_LR))
    state, _ = step(state, {"tokens": toks[0]})
    merge = pp_merge_params(lm_tiny(seed=0), 2, interleave=interleave)
    err = _worst_leaf_rel_err(
        _probe_grads(merge(state.params), _tiny_init()), _dp_grads(toks[0])[0])
    fault = _dropped_microbatch_reading(toks[0], 4)
    assert err <= PROBE_RTOL < fault, (err, fault)


def test_fsdp_schedule_posts_the_next_block_early_bitwise(cuda):
    """The FSDP gather schedule on one NCCL rank, with the next block's
    all-gathers posted early on NCCL's stream (the card's default), against
    the gather-everything step (no model): lm_tiny (bf16, flash, every
    leaf of 64 elements or more sharded) 3 adam steps bit for bit; from
    the second step on the live
    gathered bytes stay at or under twice the largest block's plus the
    leaves outside the blocks, and under the gather-all step's."""
    import numpy as np

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import data_mesh, shutdown_distributed
    from fluxdistributed_tpu_torch.models import lm_loss_fn
    from fluxdistributed_tpu_torch.ops import attention_core
    from fluxdistributed_tpu_torch.parallel import TrainState, fsdp

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (3, 4, 128)).astype(np.int64)).cuda()
    out = {}
    mesh = data_mesh(device="cuda")
    try:
        for sched in (False, True):
            m = lm_tiny(attn_fn=attention_core("flash"), seed=0)
            opt = optim.adam(1e-3)
            st = TrainState.create(dict(m.named_parameters()), opt)
            specs = fsdp.fsdp_specs(st, mesh, min_size=64)
            st = fsdp.shard_state(st, specs, mesh)
            step = fsdp.make_train_step_sharded(
                lm_loss_fn(m), opt, mesh, specs, tp_axis=None,
                model=m if sched else None)
            plan = step.gather_plan
            losses, peaks = [], []
            for i in range(3):
                plan.live.peak = plan.live.now
                st, met = step(st, {"tokens": toks[i]})
                losses.append(met["loss"].item())
                peaks.append(plan.live.peak)
            out[sched] = (losses, st.params, peaks, plan)
    finally:
        shutdown_distributed()
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k
    plan, params = out[True][3], out[True][1]
    assert plan.order == [f"blocks.{i}" for i in range(4)]

    def size(k):
        p = params[k]
        return math.prod(plan.global_shape(k, p)) * p.element_size()

    inside = {k for b in plan.order for _, _, k in plan.blocks[b][1]}
    block = max(sum(size(k) for _, _, k in plan.blocks[b][1])
                for b in plan.order)
    rest = sum(size(k) for k in params if plan.gathers.get(k)
               and k not in inside)
    for p in out[True][2][1:]:
        assert p <= 2 * block + rest, (p, block, rest)
        assert p < out[False][2][1], (p, out[False][2])


def test_vit_ring_flash_hops_equal_flash_dp_on_card(cuda):
    """ViT-B/16 (batch 4, 196 tokens, bf16) sequence-sharded on one NCCL
    rank ``{data: 1, seq: 1}`` with the flash ring: its forward equals
    the flash DP ViT's bit for bit and launches B1 once a block; 2 steps
    of ``spmd="sp"`` equal the DP step's (losses and params)."""
    from functools import partial

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.mesh import make_mesh, shutdown_distributed
    from fluxdistributed_tpu_torch.models import vit_b16
    from fluxdistributed_tpu_torch.parallel import make_ring_attention
    from fluxdistributed_tpu_torch.train import prepare_training

    fa = importlib.import_module(
        "fluxdistributed_tpu_torch.ops.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(4, 224, 224, 3, device="cuda", generator=g)
    y = torch.nn.functional.one_hot(
        torch.randint(0, 10, (4,), device="cuda", generator=g), 10).float()

    class Bank:
        nclasses = 10

        def batch(self, rng, n):
            raise AssertionError("the test feeds its own batches")

    out = {}
    try:
        for name in ("dp", "ring"):
            mesh = (make_mesh({"data": 1, "seq": 1}, device="cuda")
                    if name == "ring" else None)
            core = (make_ring_attention(mesh, impl="flash") if mesh
                    else partial(fa.flash_attention, causal=False))
            model = vit_b16(num_classes=10, seed=0, attn_fn=core)
            before = fa.flash_attention_fwd.launches
            with torch.no_grad():
                logits = model(x)
            launches = fa.flash_attention_fwd.launches - before
            task = prepare_training(
                model, Bank(), optim.adamw(), batch_size=4, cycles=2,
                topk=(1,), mesh=mesh,
                **({"spmd": "sp"} if mesh else {"device": "cuda"}))
            state, losses = task.state, []
            for _ in range(2):
                state, m = task.step_fn(state, {"image": x, "label": y})
                losses.append(m["loss"].item())
            out[name] = (logits, launches, losses,
                         {k: v.float().cpu() for k, v in state.params.items()})
            if mesh is not None:
                shutdown_distributed()
    finally:
        shutdown_distributed()
    assert torch.equal(out["ring"][0], out["dp"][0])
    assert out["ring"][1] == out["dp"][1] == 12
    assert out["ring"][2] == out["dp"][2]
    for k, v in out["dp"][3].items():
        assert torch.equal(out["ring"][3][k], v), k


def _kernel_calls(dev):
    """One call of each kernel wrapper at small shapes on ``dev``: B1, B2,
    B3, B4, B5 and B6, with the outputs each returns."""
    fa = importlib.import_module(
        "fluxdistributed_tpu_torch.ops.flash_attention")
    from fluxdistributed_tpu_torch.ops.fused_adam import fused_adam

    bf = torch.bfloat16
    q = torch.zeros(2, 128, 4, 64, dtype=bf, device=dev)
    k = torch.zeros(2, 128, 2, 64, dtype=bf, device=dev)
    v = torch.zeros_like(k)
    lse = torch.zeros(2, 4, 128, dtype=torch.float32, device=dev)
    out = {"B1": fa.flash_attention_fwd(q, k, v, causal=True),
           "B2": fa.flash_attention_dq(q, k, v, torch.zeros_like(q), lse,
                                       torch.zeros_like(lse), causal=True),
           "B3": fa.flash_attention_dkv(q, k, v, torch.zeros_like(q), lse,
                                        torch.zeros_like(lse), causal=True)}
    qd = torch.zeros(2, 1, 4, 64, dtype=bf, device=dev)
    cache = torch.zeros(2, 256, 2, 64, dtype=bf, device=dev)
    idx = torch.full((2,), 100, dtype=torch.int32, device=dev)
    out["B4"] = flash_decode(qd, cache, cache, idx)
    pool = torch.zeros(8, 32, 2, 64, dtype=bf, device=dev)
    table = torch.arange(8, dtype=torch.int32, device=dev).reshape(2, 4)
    out["B5"] = flash_decode_paged(qd, pool, pool, table, idx)
    p = torch.zeros(1024, dtype=torch.float32, device=dev)
    scalars = torch.tensor([1e-3, 0.1, 0.001], device=dev)
    out["B6"] = fused_adam(p, p, p, p, scalars)
    return out


def _launch_counts():
    fa = importlib.import_module(
        "fluxdistributed_tpu_torch.ops.flash_attention")
    from fluxdistributed_tpu_torch.ops.fused_adam import fused_adam

    return [fa.flash_attention_fwd.launches, fa.flash_attention_dq.launches,
            fa.flash_attention_dkv.launches, flash_decode.launches,
            flash_decode_paged.launches, fused_adam.launches]


def test_shape_only_branches_give_the_kernels_outputs(cuda):
    """On fake ``cuda`` tensors (a priced step) every wrapper returns its
    kernel's outputs (B1's O and f32 LSE, B2's dQ, B3's dK and dV, B4/B5's
    output, B6's three buffers), fake, in the kernel's shapes and dtypes,
    with no launch and no count."""
    from fluxdistributed_tpu_torch.fake import is_fake
    from fluxdistributed_tpu_torch.obs.pricing import pricing

    before = _launch_counts()
    with pricing(None, device="cuda") as pr:
        got = _kernel_calls(pr.device)
    assert _launch_counts() == before
    o, lse = got["B1"]
    assert o.shape == (2, 128, 4, 64) and o.dtype == torch.bfloat16
    assert lse.shape == (2, 4, 128) and lse.dtype == torch.float32
    assert got["B2"].shape == (2, 128, 4, 64)
    assert [t.shape for t in got["B3"]] == [(2, 128, 2, 64)] * 2
    assert got["B4"].shape == got["B5"].shape == (2, 1, 4, 64)
    assert got["B4"].dtype == got["B5"].dtype == torch.bfloat16
    assert [t.shape for t in got["B6"]] == [(1024,)] * 3
    flat = [o, lse, got["B2"], *got["B3"], got["B4"], got["B5"], *got["B6"]]
    assert all(is_fake(t) and t.device.type == "cuda" for t in flat)


def test_real_tensors_still_launch_after_pricing(cuda):
    """The same calls on real ``cuda`` tensors launch each kernel once:
    every count rises by 1, and the outputs are real and finite."""
    from fluxdistributed_tpu_torch.fake import is_fake

    before = _launch_counts()
    got = _kernel_calls(cuda)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_launch_counts(), before)] == [1] * 6
    o, lse = got["B1"]
    assert not is_fake(o) and torch.isfinite(o.float()).all()
    assert torch.isfinite(got["B4"].float()).all()


# --------------------------------------------------------------- cold start

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prewarm_restores_the_captured_cache_in_place(cuda, layout):
    """``warmup()`` captures the decode graph over the engine's own cache
    and then zeroes that cache IN PLACE (every buffer keeps its address,
    which the graph holds): decode_compiles is 1 before the first
    request, and a prewarmed engine's greedy tokens equal a fresh
    engine's."""
    import numpy as np

    model = lm_tiny(vocab=128, seed=2)
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, 128, (n,), generator=g).tolist()
               for n in (5, 17, 40)]
    out = {}
    for warm in (False, True):
        engine = LMEngine(model, max_slots=3, max_len=96, buckets=(64,),
                          layout=layout)
        if warm:
            ptrs = [t.data_ptr() for t in engine.cache.buffers()]
            stats = engine.warmup()
            assert [t.data_ptr() for t in engine.cache.buffers()] == ptrs
            assert all(not t.float().abs().sum() for t in
                       engine.cache.buffers())
            assert engine.compile_stats()["decode_compiles"] == 1
            assert stats["compiles"] >= 1 and stats["seconds"] > 0
        for s, p in enumerate(prompts):
            engine.prefill(s, p, 0.0, None)
        out[warm] = np.stack([engine.step_decode() for _ in range(12)])
        assert engine.compile_stats()["decode_compiles"] == 1
    np.testing.assert_array_equal(out[True], out[False])


def test_aot_manifest_names_and_loads_the_kernel_library(cuda, tmp_path):
    """A fresh ``load_or_compile`` runs the callable (which launches B4)
    and saves a manifest naming its library in the build cache; the
    next call loads it without running the callable, and the kernel
    loader finds that library there (nothing would build)."""
    from fluxdistributed_tpu_torch import compilation
    from fluxdistributed_tpu_torch.ops import _build

    (q, k, v, idx), _ = _dense_case("bf16")
    q, k, v, idx = (t.to(cuda) for t in (q, k, v, idx))
    calls = []

    def decode(q, k, v, idx):
        calls.append(1)
        return flash_decode(q, k, v, idx)

    kwargs = dict(directory=str(tmp_path), name="decode",
                  fingerprint=compilation.topology_fingerprint(tag="t"))
    first = compilation.load_or_compile(decode, (q, k, v, idx), **kwargs)
    assert calls == [1] and not first.loaded
    assert set(first.libraries) == {"flash_decode"}
    again = compilation.load_or_compile(decode, (q, k, v, idx), **kwargs)
    assert calls == [1] and again.loaded
    lib = again.libraries["flash_decode"]
    assert lib == _build.library_path("flash_decode") and lib.is_file()
    assert _build._start("flash_decode")[0] is None
    torch.testing.assert_close(again(q, k, v, idx).float(),
                               first(q, k, v, idx).float())


def test_strict_second_call_refuses_a_host_sync_and_a_cpu_operand(cuda):
    """The strict checks' second call: a ``.item()`` (a host sync) and
    an op taking a non-scalar CPU tensor beside CUDA ones (indexing with
    CPU indices) each raise
    RuntimeError naming what they did; the first call checks NaNs only,
    and the third passes straight through."""
    from fluxdistributed_tpu_torch.train.trainer import _StrictFirstCalls

    x = torch.arange(6.0, device=cuda)
    synced = _StrictFirstCalls(lambda t: (t * 2).sum().item(), "step")
    assert synced(x) == 30.0
    with pytest.raises(RuntimeError, match="host sync during the "
                                           "steady-state step"):
        synced(x)
    assert synced(x) == 30.0
    rows = torch.tensor([0, 2])  # CPU indices: an implicit copy a call
    mixed = _StrictFirstCalls(lambda t: t[rows], "step")
    mixed(x)
    with pytest.raises(RuntimeError, match="implicit host->device transfer"):
        mixed(x)
    torch.testing.assert_close(mixed(x), x[rows.to(cuda)])
    assert torch.cuda.get_sync_debug_mode() == 0
