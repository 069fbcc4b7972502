"""The collective ledger (``fluxdistributed_tpu_torch/obs/comms.py``):
the rollups, the bytes of each kind, and the documented signature of
every registered variant, priced once on a fake world of 8 ranks.

The JAX ledger's own tests fail on this jax (``jax.core`` no longer
exports ``ClosedJaxpr``, and the HLO counts drifted: ROADMAP C5), so
the port is held to the module's contract and to closed-form counts:
DP all-reduces the gradients on ``data`` (the JAX pinned count, 7); the
ZeRO-1 signature is reduce-scatter + all-gather on ``data``; the fused
ZeRO-1 step moves one of each; Megatron TP all-reduces ``4 depth + 2``
times on ``model``; 1F1B hops twice a tick of its timetable; the ring
hops ``2 S - 1`` times.  The same DP and FSDP steps recorded on two
real gloo ranks equal their fake-world ledgers, entry for entry.
"""

from __future__ import annotations

import pytest
import torch

from fluxdistributed_tpu_torch.obs import comms
from fluxdistributed_tpu_torch.obs.comms import (collective_signature,
                                                 merge_entries, total_bytes)

import test_torch_port_comms_ranks as ranks


def _by_key(entries):
    return {(e["kind"], tuple(e["axes"]) if e["axes"] else None):
            e["count"] for e in entries}


@pytest.fixture(scope="module")
def priced():
    """Every registered variant priced once (one fake run each) on a fake
    world of 8, and the world closed again: ``{name: (variant, priced)}``
    plus each training variant's param bytes."""
    from fluxdistributed_tpu_torch.analysis.variants import build_variants
    from fluxdistributed_tpu_torch.obs.pricing import price_step, pricing

    names = ["dp", "dp_shardmap", "zero1", "zero1_shardmap", "zero1_fused",
             "fsdp", "tp", "pp_1f1b", "pp_zb", "context"]
    out = {}
    with pricing(8, device="cpu") as pr:
        for v in build_variants(names, pr):
            state = v.args[0]
            pbytes = sum(p.numel() * p.element_size()
                         for p in state.params.values())
            out[v.name] = (price_step(v.fn, v.args, mesh=v.mesh), pbytes,
                           v.mesh)
    return out


# ---- rollups (JAX test_signature_and_merge, test_bytes_accounting) ----------

def test_signature_and_merge():
    a = [{"kind": "all_reduce", "axes": ["data"], "count": 2,
          "bytes": 100, "bytes_per_call": 60}]
    b = [{"kind": "all_reduce", "axes": ["data"], "count": 3,
          "bytes": 50, "bytes_per_call": 50},
         {"kind": "ppermute", "axes": None, "count": 1,
          "bytes": 10, "bytes_per_call": 10}]
    merged = merge_entries(a, b)
    assert _by_key(merged) == {("all_reduce", ("data",)): 5,
                               ("ppermute", None): 1}
    assert collective_signature(merged) == {"all_reduce": 5,
                                            "ppermute": 1}
    ar = next(e for e in merged if e["kind"] == "all_reduce")
    assert ar["bytes"] == 150 and ar["bytes_per_call"] == 60


def test_bytes_accounting():
    """Each kind's buffer: the all-reduced tensor, an all-gather's output,
    a reduce-scatter's input, an all-to-all's buffer, the tensors a hop
    sends, a broadcast's tensor; outside a recording nothing is noted."""
    import torch.distributed as dist

    from fluxdistributed_tpu_torch import mesh as mesh_lib
    from fluxdistributed_tpu_torch.obs.pricing import pricing

    with pricing(8, device="cpu"):
        m = mesh_lib.data_mesh(8, device="cpu")
        x = torch.zeros((4, 8), dtype=torch.float32)
        comms.all_reduce(x.clone())  # not recorded
        with comms.recording(m) as rec:
            comms.all_reduce(x.clone())
        (entry,) = rec.entries()
        assert entry["bytes"] == entry["bytes_per_call"] == 4 * 8 * 4
        assert entry["axes"] == ["data"] and total_bytes([entry]) == 128
        with comms.recording(m) as rec:
            comms.all_gather_into(torch.empty(64), torch.zeros(8))
            comms.reduce_scatter_into(torch.empty(8), torch.zeros(64))
            comms.all_to_all_into(torch.empty(16), torch.zeros(16))
            comms.broadcast(torch.zeros(3), 0)
            p = [dist.P2POp(dist.isend, torch.zeros(5), 1),
                 dist.P2POp(dist.irecv, torch.empty(5), 7)]
            for r in comms.batch_isend_irecv(p):
                r.wait()
        got = {e["kind"]: e["bytes"] for e in rec.entries()}
        assert got == {"all_gather": 256, "reduce_scatter": 256,
                       "all_to_all": 64, "broadcast": 12, "ppermute": 20}
        assert set(got) <= set(comms.KINDS)
        with comms.recording(m):
            with pytest.raises(RuntimeError, match="already open"):
                with comms.recording(m):
                    pass


# ---- the documented signatures on the registered variants --------------------

def test_dp_all_reduce_only_with_the_gradients_bytes(priced):
    """DP: all-reduce on ``data`` and nothing else — one per param leaf
    (6) and the loss, the JAX pinned count — moving the gradients' bytes
    and the f32 loss; ``dp_shardmap`` is the same step."""
    for name in ("dp", "dp_shardmap"):
        p, pbytes, _ = priced[name]
        assert _by_key(p["comms"]) == {("all_reduce", ("data",)): 7}
        assert total_bytes(p["comms"]) == pbytes + 4


def test_zero1_reduce_scatter_all_gather(priced):
    """The ZeRO-1 signature (arXiv:2004.13336): reduce-scatter in,
    all-gather out, one per leaf, the same bytes each way; the only
    all-reduce left is the loss."""
    for name in ("zero1", "zero1_shardmap"):
        entries = priced[name][0]["comms"]
        assert _by_key(entries) == {("reduce_scatter", ("data",)): 6,
                                    ("all_gather", ("data",)): 6,
                                    ("all_reduce", ("data",)): 1}
        per = {e["kind"]: e["bytes"] for e in entries}
        assert per["reduce_scatter"] == per["all_gather"]
        assert per["all_reduce"] == 4


def test_zero1_fused_one_collective_each(priced):
    """The fused packed update: ONE reduce-scatter and ONE all-gather of
    the packed buffer, and the loss."""
    assert _by_key(priced["zero1_fused"][0]["comms"]) == {
        ("reduce_scatter", ("data",)): 1,
        ("all_gather", ("data",)): 1,
        ("all_reduce", ("data",)): 1}


def test_tp_megatron_closed_form(priced):
    """Megatron TP on ``{data: 2, model: 4}``, depth 1: each block's
    attention and MLP all-reduce their row-parallel output forward and
    their column-parallel input's gradient backward (4 a block), the
    vocab-parallel embedding all-reduces its rows and the tied head's
    input its gradient (2), and the head's vocab blocks are gathered
    once; ``data`` all-reduces the 15 gradient leaves and the loss."""
    depth = 1
    assert _by_key(priced["tp"][0]["comms"]) == {
        ("all_reduce", ("model",)): 4 * depth + 2,
        ("all_gather", ("model",)): 1,
        ("all_reduce", ("data",)): 16}


def test_fsdp_signature(priced):
    """The registered fsdp variant (the 8-feature SimpleCNN): no leaf
    reaches FSDP's 2048-element threshold, so it moves what DP moves
    (the JAX HLO pins the same 7 all-reduces for its tiny model)."""
    assert _by_key(priced["fsdp"][0]["comms"]) == {
        ("all_reduce", ("data",)): 7}


def test_fsdp_schedule_gathers_per_block():
    """FSDP's per-block schedule (PR 16) on an LM whose matrices shard,
    over 8 fake ranks: every sharded leaf is all-gathered once up front
    (the embedding) or at its block's forward and once more in the
    backward (the 8 block matrices, regathered for their saved uses),
    and every sharded gradient is reduce-scattered once."""
    from fluxdistributed_tpu_torch import mesh as mesh_lib
    from fluxdistributed_tpu_torch.obs.pricing import price_step, pricing

    model = ranks.lm("cpu")
    with pricing(8, device="cpu") as pr:
        m = mesh_lib.data_mesh(8, device="cpu")
        fn, state, batch = ranks.step_inputs(
            m, pr.module(model), "fsdp",
            lambda arrays, shards: pr.batch(arrays, shards))
        sharded = [k for k, s in fn.gather_plan.gathers.items() if s]
        got = _by_key(price_step(fn, (state, batch), mesh=m)["comms"])
    blocks = [k for k in sharded if k.startswith("blocks.")]
    assert len(sharded) == 9 and len(blocks) == 8
    assert got[("all_gather", ("data",))] == len(sharded) + len(blocks)
    assert got[("reduce_scatter", ("data",))] == len(sharded)


def test_pp_hops_equal_the_timetable(priced):
    """1F1B and zero-bubble on ``{data: 2, pipe: 4}`` (M = 2): every
    tick of the timetable hops an activation forward and a cotangent
    backward on ``pipe`` (idle devices send zeros, as JAX's ppermutes
    do): 2 T ppermutes (1F1B: T = 2 (M + S - 1) = 10, the JAX count
    of 20)."""
    from fluxdistributed_tpu_torch.parallel.pp_1f1b import build_schedule

    for name, sched in (("pp_1f1b", "1f1b"), ("pp_zb", "zb")):
        ticks = build_schedule(4, 2, schedule=sched).is_fwd.shape[0]
        sig = _by_key(priced[name][0]["comms"])
        assert sig[("ppermute", ("pipe",))] == 2 * ticks, name
    assert build_schedule(4, 2).is_fwd.shape[0] == 2 * (2 + 4 - 1)


def test_context_ring_hops(priced):
    """Ring attention over 4 seq ranks: the XLA walk's S forward hops
    (its last rotation included, as JAX runs it) and S - 1 backward ones
    (the last rotation's result feeds nothing), all on ``seq``."""
    S = 4
    sig = _by_key(priced["context"][0]["comms"])
    assert sig[("ppermute", ("seq",))] == 2 * S - 1
    assert {k[0] for k in sig} == {"ppermute", "all_reduce"}


def test_real_two_rank_ledgers_equal_the_fake_world():
    """The DP and FSDP steps recorded on 2 real gloo ranks (one spawn)
    equal the same steps priced on a fake world of 2, entry for entry."""
    from fluxdistributed_tpu_torch import mesh as mesh_lib
    from fluxdistributed_tpu_torch.obs.pricing import price_step, pricing

    real = mesh_lib.run_ranks(ranks.recorded_ledgers, 2, ("jit", "fsdp"))
    model = ranks.lm("cpu")
    for spmd in ("jit", "fsdp"):
        with pricing(2, device="cpu") as pr:
            m = mesh_lib.data_mesh(2, device="cpu")
            fn, state, batch = ranks.step_inputs(
                m, pr.module(model), spmd,
                lambda arrays, shards: pr.batch(arrays, shards))
            fake = price_step(fn, (state, batch), mesh=m)["comms"]
        assert fake, spmd
        for got in real:
            assert got[spmd] == fake, spmd
    kinds = {e["kind"] for e in real[0]["fsdp"]}
    assert kinds == {"all_gather", "reduce_scatter", "all_reduce"}
