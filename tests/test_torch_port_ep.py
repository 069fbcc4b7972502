"""Port parity: MoE expert parallelism (``parallel/ep.py``, the LM's
``MoEDecoderBlock``, ``lm_moe_specs`` and the auxiliary loss) and
``prepare_training(spmd="ep")``, against the JAX package.

Routing is held on shared logits: the discrete dispatch bit for bit,
the combine weights and the load-balance term within 1e-6 relative (the
f32 softmax's ``exp`` rounds by an ulp otherwise in XLA's CPU code than
in PyTorch's, and the means over the tokens add in another order:
ROADMAP Queue C).  ``moe_apply`` runs on 4 gloo CPU ranks
laid out ``{expert: 4}`` and ``{data: 2, expert: 2}``, two experts a
rank (one spawn, bodies in ``test_torch_port_ep_ranks.py``), against
the JAX function under ``shard_map`` over 4 of the conftest's virtual
devices on the same numpy inputs: outputs and aux within 1e-5 (the JAX
file's limit), gradients within 1e-4.  The MoE LM's forward and aux
from the flax weights (one rank, one expert shard) within 1e-5, its
KV-cache decode against its full forward within 2e-4 (the JAX test's);
the ``ep`` trainer (f32, 3 adam steps at lr 3e-3) losses within 1e-5
relative and params within 2 lr.  Each layer- and trainer-level test
asserts every token's top-1/top-2 router probability margin exceeds
1e-4, so a routing flip fails as one.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_ep_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu.data import SyntheticTextDataset as JText
from fluxdistributed_tpu.mesh import make_mesh as jmake_mesh
from fluxdistributed_tpu.models import lm_loss_fn as jlm_loss_fn
from fluxdistributed_tpu.models import moe_expert_fn as jmoe_expert_fn
from fluxdistributed_tpu.models.transformer_lm import TransformerLM as JLM
from fluxdistributed_tpu.parallel import ep as jep
from fluxdistributed_tpu.train import prepare_training as jprepare
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.data import SyntheticTextDataset
from fluxdistributed_tpu_torch.mesh import Mesh
from fluxdistributed_tpu_torch.models import (TransformerLM,
                                              flax_to_state_dict, lm_loss_fn,
                                              lm_moe_specs, lm_tiny,
                                              make_decode_cache,
                                              moe_expert_fn)
from fluxdistributed_tpu_torch.parallel import (moe_apply, router_dispatch,
                                                router_dispatch_expert_choice)
from fluxdistributed_tpu_torch.sharding import P
from fluxdistributed_tpu_torch.train import load_checkpoint, prepare_training

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

N = 4
D = ranks.D


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh(axes):
    return jmake_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])


def _jexpert_fn(p, x):
    return jax.nn.gelu(x @ p["w1"]) @ p["w2"]


def _jmoe_lm(moe_fn):
    return JLM(dtype=jnp.float32, dropout=0.0, moe_fn=moe_fn, **ranks.LM)


def _fake_mesh(axes):
    """A one-rank mesh: every exchange over it is the identity, so no
    process group is needed."""
    names = tuple(axes)
    return Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                axis=names[0], axes=tuple(axes.items()),
                coords=(0,) * len(names))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(0)
    per_expert, router = {}, {}
    for mname, axes in ranks.MOE_MESHES.items():
        e = 2 * axes["expert"]
        per_expert[mname] = [
            {"w1": (rng.normal(size=(D, 2 * D)) * 0.3).astype(np.float32),
             "w2": (rng.normal(size=(2 * D, D)) * 0.3).astype(np.float32)}
            for _ in range(e)]
        router[mname] = rng.normal(size=(D, e)).astype(np.float32)
    xs = {n: rng.normal(size=(ranks.T_PAD if n.startswith("pad")
                              else ranks.T_MOE, D)).astype(np.float32)
          for n in ranks.MOE_CASES}
    g = {"top2": rng.normal(size=(ranks.T_MOE, D)).astype(np.float32)}
    toks = np.random.default_rng(3).integers(
        0, ranks.LM["vocab"], (16, 24)).astype(np.int32)
    mesh = _jmesh({"data": 2, "expert": 2})
    task = jprepare(_jmoe_lm(jep.moe_apply(jmoe_expert_fn, mesh,
                                           capacity_factor=2.0,
                                           batch_axis="data")),
                    JText(vocab=ranks.LM["vocab"], seqlen=24),
                    joptim.adam(ranks.LR), mesh=mesh, batch_size=16,
                    cycles=3, spmd="ep")
    params = _np_tree(task.state.params)
    ckpt = str(tmp_path_factory.mktemp("ep_ckpt"))
    return per_expert, router, xs, g, toks, params, ckpt


@pytest.fixture(scope="module")
def spawn(data):
    """The ranks' run, started before the JAX references compute."""
    per_expert, router, xs, g, toks, params, ckpt = data
    return Spawned(ranks.ep_all, N, per_expert, router, xs, g,
                   flax_to_state_dict(params), toks, ckpt)


def _jax_moe(mesh, mname, name, per_expert, router, xs, g):
    kw = dict(ranks.MOE_CASES[name])
    batch_axis = "data" if "data" in mesh.axis_names else None
    fn = jep.moe_apply(_jexpert_fn, mesh, batch_axis=batch_axis, **kw)
    stacked = jep.stack_expert_params(
        [jax.tree.map(jnp.asarray, p) for p in per_expert[mname]], mesh)
    rw, x = jnp.asarray(router[mname]), jnp.asarray(xs[name])
    if name != "top2":
        out, aux = jax.jit(fn)(stacked, rw, x)
        return {"out": np.asarray(out), "aux": float(aux)}

    def loss(x, rw, st):
        y, a = fn(st, rw, x)
        return (y * jnp.asarray(g[name])).sum() + ranks.AUX_W * a, (y, a)

    # one compile gives the output, the aux and the gradients
    (_, (out, aux)), (dx, drw, dst) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(x, rw, stacked)
    return {"out": np.asarray(out), "aux": float(aux), "dx": np.asarray(dx),
            "drouter": np.asarray(drw), "dexperts": _np_tree(dst)}


@pytest.fixture(scope="module")
def jax_runs(data, spawn):
    per_expert, router, xs, g, toks, params, _ = data
    out = {}
    for mname, axes in ranks.MOE_MESHES.items():
        mesh = _jmesh(axes)
        for name in ranks.MOE_CASES:
            out[f"{mname}/{name}"] = _jax_moe(mesh, mname, name, per_expert,
                                              router, xs, g)
    mesh = _jmesh({"data": 2, "expert": 2})
    model = _jmoe_lm(jep.moe_apply(jmoe_expert_fn, mesh, capacity_factor=2.0,
                                   batch_axis="data"))
    task = jprepare(model, JText(vocab=ranks.LM["vocab"], seqlen=24),
                    joptim.adam(ranks.LR), mesh=mesh, batch_size=16,
                    cycles=3, spmd="ep")
    st = task.state  # the trainer's init: ``data``'s params
    batch = jsharding.shard_batch({"tokens": toks}, mesh)
    losses = []
    for _ in range(3):
        st, m = task.step_fn(st, batch)
        losses.append(float(m["loss"]))
    ev, _ = task.eval_fn(st, batch)
    out["trainer"] = (losses, flax_to_state_dict(_np_tree(st.params)),
                      float(ev))
    return out


@pytest.fixture(scope="module")
def four(spawn):
    return spawn.result()


# ------------------------------------------------------------ routing

ROUTE_CASES = {  # name: (T, E, capacity, k, normalize, dtype)
    "k1": (32, 4, 10, 1, None, np.float32),
    "k2": (32, 4, 12, 2, None, np.float32),
    "k2_unnormalized": (32, 4, 12, 2, False, np.float32),
    "k1_drops": (48, 4, 3, 1, None, np.float32),
    "k3_drops": (40, 8, 4, 3, None, np.float32),
}


def _logits(t, e, seed):
    return np.random.default_rng(seed).normal(0, 1.5, (t, e)).astype(
        np.float32)


def _close_f32(got, ref, what):
    """Within a few f32 ulps (1e-6 relative) of the reference."""
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12,
                               err_msg=what)


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_router_dispatch_matches_jax(case):
    t, e, cap, k, norm, dt = ROUTE_CASES[case]
    lg = _logits(t, e, 11)
    jd, jc, ja = jep.router_dispatch(jnp.asarray(lg), cap, k=k,
                                     normalize=norm)
    d, c, a = router_dispatch(torch.from_numpy(lg), cap, k=k,
                              normalize=norm)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert d.dtype == torch.float32 and c.shape == (t, e, cap)
    _close_f32(c.numpy(), np.asarray(jc), f"{case} combine")
    _close_f32(a.item(), float(ja), f"{case} aux")
    if "drops" in case:
        assert d.numpy().sum() < t * k  # the case does drop tokens


def test_router_dispatch_bf16_long_queue_matches_jax():
    """Queue positions stay exact past 256 tokens of bf16 logits (the
    routing math runs in f32)."""
    t = 400
    lg = np.zeros((t, 2), np.float32)
    lg[:, 0] = 1.0
    jd, jc, ja = jep.router_dispatch(jnp.asarray(lg, jnp.bfloat16),
                                     capacity=t)
    d, c, a = router_dispatch(torch.from_numpy(lg).bfloat16(), capacity=t)
    assert d.dtype == torch.bfloat16
    np.testing.assert_array_equal(d.float().numpy(),
                                  np.asarray(jd, np.float32))
    np.testing.assert_array_equal(d.float().numpy()[:, 0].sum(axis=0),
                                  np.ones(t))
    np.testing.assert_array_equal(c.float().numpy(),
                                  np.asarray(jc, np.float32))
    _close_f32(a.item(), float(ja), "bf16 aux")


@pytest.mark.parametrize("cap", [1, 5, 32])
def test_router_dispatch_expert_choice_matches_jax(cap):
    lg = _logits(32, 4, 12)
    jd, jc, ja = jep.router_dispatch_expert_choice(jnp.asarray(lg), cap)
    d, c, a = router_dispatch_expert_choice(torch.from_numpy(lg), cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(d.numpy().sum(axis=(0, 2)),
                                  np.full(4, float(cap)))
    _close_f32(c.numpy(), np.asarray(jc), "expert-choice combine")
    assert a.item() == float(ja) == 0.0


def test_routing_validations():
    with pytest.raises(ValueError, match="cannot exceed"):
        router_dispatch_expert_choice(torch.zeros(4, 2), capacity=5)
    for k in (0, 3):
        with pytest.raises(ValueError, match=r"top-k \(\d\) must be in"):
            router_dispatch(torch.zeros(4, 2), 4, k=k)
    mesh = _fake_mesh({"expert": 1})
    for kw, msg in (
            (dict(routing="nope"), "unknown routing"),
            (dict(routing="expert_choice", top_k=2), "token-choice"),
            (dict(routing="expert_choice", pad_tokens=True, capacity=4),
             "incompatible with expert_choice"),
            (dict(pad_tokens=True), "needs an explicit capacity"),
            (dict(capacity=0), "capacity must be >= 1")):
        with pytest.raises(ValueError, match=msg):
            moe_apply(ranks.expert_fn, mesh, **kw)
    moe_apply(ranks.expert_fn, _fake_mesh({"data": 1, "expert": 1}),
              batch_axis="data")
    with pytest.raises(ValueError, match="not on the mesh"):
        moe_apply(ranks.expert_fn, mesh, batch_axis="data")


# ------------------------------------------------------------ moe_apply

def test_rank_coordinates_are_jax_devices(four):
    coords = [dict(zip(("data", "expert"), [int(c) for c in np.argwhere(
        _jmesh({"data": 2, "expert": 2}).devices == d)[0]]))
        for d in jax.devices()[:N]]
    for r in range(N):
        assert four[r]["coord"] == coords[r]


@pytest.mark.parametrize("mname", list(ranks.MOE_MESHES))
@pytest.mark.parametrize("name", list(ranks.MOE_CASES))
def test_moe_apply_matches_jax(jax_runs, four, mname, name):
    """Each rank's output rows put together, and its aux, equal the JAX
    function's on the global tokens; each rank holds 2 experts."""
    ref = jax_runs[f"{mname}/{name}"]
    got = np.concatenate([four[r]["moe"][f"{mname}/{name}"]["out"]
                          for r in range(N)])
    np.testing.assert_allclose(got, ref["out"], rtol=1e-5, atol=1e-5)
    for r in range(N):
        res = four[r]["moe"][f"{mname}/{name}"]
        assert res["stacked_rows"] == 2
        np.testing.assert_allclose(res["aux"], ref["aux"], rtol=1e-5)


@pytest.mark.parametrize("mname", list(ranks.MOE_MESHES))
def test_moe_apply_gradients_match_jax(jax_runs, four, mname):
    """Top-2 gradients through both exchanges and the aux mean: each
    rank's token rows, the router's summed over the ranks (each holds
    its part), each expert block summed over the data rows."""
    ref = jax_runs[f"{mname}/top2"]
    res = [four[r]["moe"][f"{mname}/top2"] for r in range(N)]
    np.testing.assert_allclose(np.concatenate([x["dx"] for x in res]),
                               ref["dx"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(x["drouter"] for x in res),
                               ref["drouter"], rtol=1e-4, atol=1e-5)
    e_size = ranks.MOE_MESHES[mname]["expert"]
    for k in ("w1", "w2"):
        blocks = [sum(res[r]["dexperts"][k] for r in range(N)
                      if r % e_size == j) for j in range(e_size)]
        np.testing.assert_allclose(np.concatenate(blocks),
                                   ref["dexperts"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------------------ the MoE LM

def _margin(model_inputs):
    """The smallest top-1/top-2 router probability margin of tokens."""
    x, router = model_inputs
    p = torch.softmax(x.float() @ router.float(), dim=-1)
    top = torch.topk(p, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).min().item()


def test_moe_lm_forward_and_aux_match_jax_from_flax_weights():
    """lm with every 2nd block routed over 8 experts (one expert
    shard): logits and each block's aux from the flax weights, and the
    training loss with the aux term."""
    jmesh = _jmesh({"expert": 1})
    jm = JLM(vocab=32, dim=32, depth=4, num_heads=2, mlp_dim=64,
             dtype=jnp.float32, moe_every=2, num_experts=8,
             moe_fn=jep.moe_apply(jmoe_expert_fn, jmesh,
                                  capacity_factor=2.0))
    toks = np.random.default_rng(21).integers(0, 32, (4, 16)).astype(
        np.int32)
    params = jm.init(jax.random.PRNGKey(1), toks, train=False)["params"]
    jlogits, sown = jm.apply({"params": params}, toks, train=False,
                             mutable=["losses"])
    jaux = [float(a) for a in jax.tree.leaves(sown["losses"])]
    jloss, _ = jlm_loss_fn(jm)(params, {}, {"tokens": toks}, True)
    seen = []

    def record(experts, router_w, x):
        seen.append(_margin((x, router_w)))
        return moe(experts, router_w, x)

    moe = moe_apply(moe_expert_fn, _fake_mesh({"expert": 1}),
                    capacity_factor=2.0)
    pm = TransformerLM(vocab=32, dim=32, depth=4, num_heads=2, mlp_dim=64,
                       dtype=torch.float32, moe_every=2, num_experts=8,
                       moe_fn=record, device="cpu")
    sd = flax_to_state_dict(_np_tree(params))
    assert {k for k in sd if "router" in k} == {"blocks.1.router",
                                                 "blocks.3.router"}
    pm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    aux = []
    logits = pm(torch.from_numpy(toks).long(), moe_aux=aux)
    assert min(seen) > 1e-4, f"routing near a tie: margin {min(seen)}"
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([a.item() for a in aux], jaux, rtol=1e-5)
    loss, _ = lm_loss_fn(pm)(dict(pm.named_parameters()), {},
                             {"tokens": torch.from_numpy(toks).long()}, True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    evl, _ = lm_loss_fn(pm)(dict(pm.named_parameters()), {},
                            {"tokens": torch.from_numpy(toks).long()}, False)
    assert loss.item() > evl.item()  # the aux term rides training only
    specs = lm_moe_specs(dict(pm.named_parameters()))
    assert specs["blocks.1.w1"] == P("expert", None, None)
    assert specs["blocks.1.router"] == P() and specs["blocks.0.fc1.weight"] \
        == P()


def test_moe_lm_decode_matches_full_forward():
    """KV-cache decoding through the MoE blocks reproduces the full
    forward (an explicit capacity, so no step drops a token)."""
    moe = moe_apply(moe_expert_fn, _fake_mesh({"expert": 1}), capacity=64,
                    pad_tokens=True)
    m = lm_tiny(vocab=32, dtype=torch.float32, moe_every=2, num_experts=8,
                moe_fn=moe, device="cpu", seed=3)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, 32, (2, 12))).long()
    with torch.no_grad():
        full = m(toks)
        cache = make_decode_cache(m, 2, 12)
        got = torch.cat([m(toks[:, t:t + 1], cache) for t in range(12)],
                        dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_model_validations():
    moe = moe_apply(moe_expert_fn, _fake_mesh({"expert": 1}))
    with pytest.raises(ValueError, match="moe_every > 0 needs moe_fn"):
        lm_tiny(vocab=32, moe_every=2, num_experts=8, device="cpu")
    with pytest.raises(ValueError, match="moe_every > 0 needs moe_fn"):
        lm_tiny(vocab=32, moe_every=2, moe_fn=moe, device="cpu")
    with pytest.raises(ValueError, match=r"moe_every \(5\) > depth \(4\)"):
        lm_tiny(vocab=32, moe_every=5, num_experts=2, moe_fn=moe,
                device="cpu")
    from fluxdistributed_tpu_torch.serve import LMEngine

    with pytest.raises(ValueError, match="dense models only"):
        LMEngine(lm_tiny(vocab=8, moe_every=1, num_experts=2, moe_fn=moe,
                         device="cpu"), max_slots=1, max_len=8)


# ------------------------------------------------------------ the trainer

def test_ep_trainer_matches_jax(jax_runs, four):
    """``prepare_training(spmd="ep")`` on ``{data: 2, expert: 2}`` from
    the JAX trainer's init: 3 adam steps on the same batch, each rank
    holding 2 of the 4 experts of each MoE block."""
    losses, params, ev = jax_runs["trainer"]
    for r in range(N):
        got = four[r]
        assert got["margin"] > 1e-4, f"routing near a tie: {got['margin']}"
        assert got["local_w1"] == (2, 32, 64)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["eval"], ev, rtol=1e-5, atol=0)
        assert set(got["params"]) == set(params)
        for k in params:
            np.testing.assert_allclose(got["params"][k], params[k], rtol=0,
                                       atol=2 * ranks.LR, err_msg=k)
            np.testing.assert_array_equal(got["params"][k],
                                          four[0]["params"][k])


def test_rank_expert_blocks_are_the_flax_experts(four, data):
    """Each rank's expert leaves before the first step are its block of
    the flax experts, ``flax_to_state_dict(params, experts=(e, 2))``, bit
    for bit; the other leaves are whole."""
    params = data[5]
    for r in range(N):
        e = four[r]["coord"]["expert"]
        want = flax_to_state_dict(params, experts=(e, 2))
        got = four[r]["init_blocks"]
        assert set(got) == {f"blocks.1.{n}" for n in ("w1", "b1", "w2",
                                                       "b2")}
        for k, v in got.items():
            assert v.shape[0] == 2
            np.testing.assert_array_equal(v, want[k])
        whole = flax_to_state_dict(params)
        assert whole["blocks.1.w1"].shape[0] == 4
        assert want["blocks.1.router"].shape == whole["blocks.1.router"].shape


def test_ep_checkpoint_restores_onto_other_rank_counts(four, data):
    """The ``{data: 2, expert: 2}`` checkpoint (global shapes) restored
    onto ``{data: 1, expert: 4}`` (one expert a rank) and onto one
    process with no mesh: the global values each time."""
    ref = four[0]["params"]
    for r in range(N):
        assert four[r]["restored_step"] == 3
        assert four[r]["restored_local_w1"] == (1, 32, 64)
        for k, v in ref.items():
            np.testing.assert_array_equal(four[r]["restored"][k], v)
    model = TransformerLM(dtype=torch.float32, device="cpu",
                          moe_fn=moe_apply(moe_expert_fn,
                                           _fake_mesh({"expert": 1})),
                          **ranks.LM)
    from fluxdistributed_tpu_torch.parallel import TrainState

    target = TrainState.create(dict(model.named_parameters()),
                               optim.adam(ranks.LR))
    one = load_checkpoint(data[-1], target)
    assert one.step == 3
    for k, v in ref.items():
        np.testing.assert_array_equal(one.params[k].numpy(), v)


def test_cli_ep_equals_train(four):
    """``--spmd ep --expert-parallel 2`` on 4 ranks equals
    ``prepare_training`` + ``train`` with the same arguments, bit for
    bit (lm_tiny, every 2nd block routed over 2 experts)."""
    for r in range(N):
        got = four[r]["cli"]
        assert got["mesh"] == {"data": 2, "expert": 2}
        assert (got["moe_every"], got["experts"]) == (2, 2)
        assert len(got["cli"]) == 3 and got["cli"] == got["train"]


def test_cli_ep_refusals_on_ranks(four):
    assert four[0]["cli_refusals"] == {
        "--spmd ep --expert-parallel 2 --experts 3":
            "--experts 3 must be a multiple of the expert axis size 2",
        "--spmd ep --expert-parallel 3":
            "--expert-parallel 3 must be >=2 and divide 4 devices",
        "--spmd ep --expert-parallel 2 --model resnet18 --image-size 8 "
        "--num-classes 4": "--spmd ep needs an lm_* model (MoE blocks)"}


def test_cli_ep_refusals_mirror_the_jax_cli():
    for extra, msg in (
            (["--experts", "4"], "only apply with --spmd ep"),
            (["--moe-every", "2"], "only apply with --spmd ep"),
            (["--expert-parallel", "2"], "only apply with --spmd ep"),
            (["--spmd", "ep"],
             "--expert-parallel 1 must be >=2 and divide 1 devices")):
        with pytest.raises(SystemExit, match=msg):
            cli.run(ranks.CLI_ARGS + extra)


def test_prepare_training_ep_refusals():
    ds = SyntheticTextDataset(vocab=32, seqlen=24)
    mesh = _fake_mesh({"data": 1, "expert": 1})
    moe = moe_apply(moe_expert_fn, mesh, batch_axis="data")
    model = lm_tiny(vocab=32, moe_every=2, num_experts=2, moe_fn=moe,
                    device="cpu")
    dense = lm_tiny(vocab=32, device="cpu")
    for m, kw, msg in (
            (dense, {"mesh": mesh}, "moe_every > 0"),
            (model, {"mesh": mesh, "accum_steps": 2},
             "accum_steps > 1 requires"),
            (model, {"mesh": _fake_mesh({"data": 1})}, "'data' and "
                                                       "'expert' axes"),
            (model, {"device": "cpu"}, "'data' and 'expert' axes"),
            (model, {"mesh": _fake_mesh({"data": 1, "expert": 1,
                                         "model": 1})}, "the step on"),
            (model, {"mesh": mesh, "zero1": True}, "zero1=True applies"),
            (model, {"mesh": mesh, "steps_per_call": 2},
             "steps_per_call > 1 requires")):
        with pytest.raises(ValueError, match=msg):
            prepare_training(m, ds, optim.adam(1e-3), batch_size=16,
                             spmd="ep", **kw)
