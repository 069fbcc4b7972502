"""Port parity: pipeline parallelism's layers (``parallel/pp.py``,
``parallel/pp_1f1b.py``, the LM's ``lm_pp`` and ``lm_pp_1f1b``) against
the JAX package.

* ``pipeline_apply`` on 4 gloo CPU ranks laid out ``{pipe: 4}`` and
  ``{data: 2, pipe: 2}`` (one spawn, bodies in
  ``test_torch_port_pp_ranks.py``) against the JAX function under
  ``shard_map`` over 4 of the conftest's virtual devices, on the same
  numpy inputs: a toy stage, a ``switch_stage`` heterogeneous stage,
  ``chunk_stages`` with and without ``counts`` (the padded chunks'
  gradients stay zero) and ``remat``: forward within rtol 1e-5,
  gradients rtol 1e-4 / atol 1e-5 (``tests/test_pipeline_parallel.py``'s
  limits).
* ``pipeline_grads_1f1b`` at S = 4, M in {4, 8}, V in {1, 2}, both
  schedules, on the local exchange (one process) against JAX's 1F1B;
  ZB equals 1F1B in the port bit for bit (JAX pins the same,
  ``tests/test_pp_zb.py``).  Once on the gloo ranks: ZB interleaved on
  ``{pipe: 4}`` and 1F1B with data parallelism composed on ``{data: 2,
  pipe: 2}``.
* The LM (dim 32, 2 heads, f32) from the flax weights: GPipe tied and
  untied on ``{pipe: 4}``, planned boundaries ``(0, 1, 3, 4, 6)`` on a
  depth-6 stack, and 1F1B blocked, ZB interleaved and ZB planned (with
  data parallelism: ``test_torch_port_pp_trainer.py``).  Every rank's loss, its block of the
  split tree (bit for bit) and of the gradients, and the outer
  gradients are held to JAX's.  This pins the two hand-offs JAX's SPMD
  typing does for free: a cotangent summed over the ranks at the
  last-stage hand-out would make every stage gradient S times JAX's,
  and an embedding gradient left on rank 0 would leave the other ranks'
  embedding gradients short of JAX's lookup part (tied: the lookup plus
  the logits part).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import test_torch_port_pp_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu.mesh import make_mesh as jmake_mesh
from fluxdistributed_tpu.models.transformer_lm import TransformerLM as JLM
from fluxdistributed_tpu.models.transformer_lm import lm_pp as jlm_pp
from fluxdistributed_tpu.models.transformer_lm import lm_pp_1f1b as jlm_pp_1f1b
from fluxdistributed_tpu.parallel import pp as jpp
from fluxdistributed_tpu.parallel import pp_1f1b as jpp1
from fluxdistributed_tpu_torch.models import (flax_split_to_state_dict,
                                              flax_to_state_dict)
from fluxdistributed_tpu_torch.parallel import LocalPipe, pipeline_grads_1f1b

N = 4
S = 4
D = ranks.D


def _close_grad(got, ref, msg=""):
    """A gradient within rtol 1e-4 and atol 1e-5 (the JAX tests'
    limits), the atol scaled by the leaf's largest entry when that
    exceeds 1: the toys' gradients reach |5|, and XLA's and PyTorch's
    tanh GELU and f32 sums round apart by a few ulps of that."""
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=msg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh(axes):
    return jmake_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])


def _jstage(p, x):
    return x + jax.nn.gelu(x @ p["w"] + p["b"])


def _jtanh(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _jembed(o, tok):
    return o["e"][tok]


def _jhead(o, y, lab):
    return jnp.mean((y @ o["h"] - lab) ** 2)


def _layer(rng, lead=()):
    return {"w": (rng.normal(size=lead + (D, D)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=lead + (D,)) * 0.1).astype(np.float32)}


def _interleaved(logical, S, V):
    """``[i, c] = logical stage c S + i`` (V = 1: ``[i] = i``)."""
    if V == 1:
        return {k: np.stack([p[k] for p in logical]) for k in logical[0]}
    return {k: np.stack([np.stack([logical[c * S + i][k] for c in range(V)])
                         for i in range(S)]) for k in logical[0]}


F1B_LOCAL = [(4, 1), (8, 1), (4, 2), (8, 2)]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    toy = {"x": rng.normal(size=(ranks.B, D)).astype(np.float32),
           "g": rng.normal(size=(ranks.B, D)).astype(np.float32)}
    for mname, axes in ranks.MESHES.items():
        s = axes["pipe"]
        for case in ranks.TOY_CASES:
            if case in ("chunk", "counts"):
                per = [_layer(rng, (2,)) for _ in range(s)]
                if case == "counts":
                    for p, c in zip(per, ranks.COUNTS[mname]):
                        for v in p.values():
                            v[c:] = 0.0  # the padded chunks
            else:
                per = [_layer(rng) for _ in range(s)]
            toy[f"{mname}/{case}"] = {"per_device": per}
    toy["outer"] = {"e": rng.normal(size=(16, D)).astype(np.float32),
                    "h": (rng.normal(size=(D, 3)) * 0.5).astype(np.float32)}
    toy["tok"] = rng.integers(0, 16, (16,)).astype(np.int32)
    toy["lab"] = rng.normal(size=(16, 3)).astype(np.float32)
    logical = [_layer(rng) for _ in range(2 * S)]
    for M, V in F1B_LOCAL:
        toy[f"local/{M}/{V}"] = {"stacked": _interleaved(logical[:S * V],
                                                         S, V)}
    for name, (mname, M, V, _) in ranks.F1B_RANK_CASES.items():
        s = ranks.MESHES[mname]["pipe"]
        toy[f"f1b/{name}"] = {"stacked": _interleaved(logical[:s * V], s, V)}
    toks = np.random.default_rng(3).integers(
        0, ranks.LM["vocab"], ranks.LM_TOKENS).astype(np.int32)
    jparams, sds, inits = {}, {}, {}
    for name, (_, depth, tied, *_) in ranks.LM_CASES.items():
        if (depth, tied) not in inits:  # one init a (depth, tied)
            inits[depth, tied] = _np_tree(_jlm(depth, tied).init(
                jax.random.PRNGKey(len(inits)), toks[:1],
                train=False)["params"])
        jparams[name] = inits[depth, tied]
        sds[name] = flax_to_state_dict(jparams[name])
    return toy, toks, jparams, sds


def _jlm(depth, tied):
    return JLM(depth=depth, tie_embeddings=tied, dtype=jnp.float32,
               dropout=0.0, **ranks.LM)


@pytest.fixture(scope="module")
def spawn(data):
    """The ranks' run, started before the JAX references compute."""
    toy, toks, _, sds = data
    return Spawned(ranks.layers_all, N, toy, sds, toks)


def _jax_toy(mname, case, toy):
    mesh = _jmesh(ranks.MESHES[mname])
    batch_axis = "data" if "data" in ranks.MESHES[mname] else None
    fn = {"switch": jpp.switch_stage([_jstage if s % 2 == 0 else _jtanh
                                      for s in range(mesh.shape["pipe"])]),
          "chunk": jpp.chunk_stages(_jstage),
          "counts": jpp.chunk_stages(_jstage, counts=ranks.COUNTS[mname]),
          }.get(case, _jstage)
    fwd = jpp.pipeline_apply(fn, mesh, num_microbatches=ranks.M_TOY,
                             batch_axis=batch_axis, remat=case == "remat")
    stacked = jpp.stack_stage_params(
        [jax.tree.map(jnp.asarray, p)
         for p in toy[f"{mname}/{case}"]["per_device"]], mesh)
    g = jnp.asarray(toy["g"])

    def loss(st, x):
        y = fwd(st, x)
        return jnp.sum(y * g), y

    (_, y), (dst, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(toy["x"]))
    return {"out": np.asarray(y), "dx": np.asarray(dx),
            "dstacked": _np_tree(dst)}


def _jax_1f1b(mesh, M, V, stacked, toy, batch_axis=None):
    run = jpp1.pipeline_grads_1f1b(_jstage, _jembed, _jhead, mesh,
                                   num_microbatches=M, batch_axis=batch_axis,
                                   interleave=V)
    loss, g_st, g_out = jax.jit(run)(
        jax.device_put(jax.tree.map(jnp.asarray, stacked),
                       NamedSharding(mesh, JP("pipe"))),
        jax.tree.map(jnp.asarray, toy["outer"]), jnp.asarray(toy["tok"]),
        jnp.asarray(toy["lab"]))
    return {"loss": float(loss), "stages": _np_tree(g_st),
            "outer": _np_tree(g_out)}


def _jax_lm(name, params, toks):
    mname, depth, tied, sched, M, inter, bounds = ranks.LM_CASES[name]
    mesh = _jmesh(ranks.MESHES[mname])
    batch_axis = "data" if "data" in mesh.shape else None
    jm = _jlm(depth, tied)
    params = jax.tree.map(jnp.asarray, params)
    if sched == "gpipe":
        split, loss_fn, _ = jlm_pp(jm, mesh, batch_axis=batch_axis,
                                   num_microbatches=M, boundaries=bounds)
        tree = split(params)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, {}, {"tokens": jnp.asarray(toks)},
                              True)[0]))(tree)
    else:
        w = jlm_pp_1f1b(jm, mesh, interleave=inter, boundaries=bounds)
        tree = w.split_params(params)
        run = jpp1.pipeline_grads_1f1b(*w.fns, mesh, num_microbatches=M,
                                       batch_axis=batch_axis,
                                       interleave=w.interleave)
        loss, g_st, g_out = jax.jit(run)(tree["stages"], tree["outer"],
                                         jnp.asarray(toks), jnp.asarray(toks))
        grads = {"outer": g_out, "stages": g_st}
    return {"loss": float(loss),
            "split": flax_split_to_state_dict(_np_tree(tree)),
            "grads": flax_split_to_state_dict(_np_tree(grads))}


@pytest.fixture(scope="module")
def jax_runs(data, spawn):
    toy, toks, jparams, _ = data
    out = {}
    for mname in ranks.MESHES:
        for case in ranks.TOY_CASES:
            out[f"{mname}/{case}"] = _jax_toy(mname, case, toy)
    mesh4 = _jmesh({"pipe": 4})
    for M, V in F1B_LOCAL:
        out[f"local/{M}/{V}"] = _jax_1f1b(mesh4, M, V,
                                          toy[f"local/{M}/{V}"]["stacked"],
                                          toy)
    for name, (mname, M, V, _) in ranks.F1B_RANK_CASES.items():
        axes = ranks.MESHES[mname]
        out[f"f1b/{name}"] = _jax_1f1b(
            _jmesh(axes), M, V, toy[f"f1b/{name}"]["stacked"], toy,
            batch_axis="data" if "data" in axes else None)
    for name in ranks.LM_CASES:
        out[f"lm/{name}"] = _jax_lm(name, jparams[name], toks)
    return out


@pytest.fixture(scope="module")
def four(spawn, jax_runs):
    """The ranks' results, joined after the JAX references ran."""
    return spawn.result()


def _coord(r, mname):
    """The (data, pipe) coordinate of rank ``r`` on a mesh of
    ``MESHES`` (row major, as JAX lays devices out)."""
    axes = ranks.MESHES[mname]
    return (r // axes["pipe"], r % axes["pipe"]) if "data" in axes \
        else (0, r)


def _row_slices(mname):
    n = ranks.MESHES[mname].get("data", 1)
    k = ranks.B // n
    return [slice(i * k, (i + 1) * k) for i in range(n)]


def test_rank_coordinates_are_jax_devices(four):
    mesh = _jmesh({"data": 2, "pipe": 2})
    for r, d in enumerate(jax.devices()[:N]):
        data_ix, pipe_ix = (int(c) for c in np.argwhere(mesh.devices == d)[0])
        assert four[r]["coord"] == {"data": data_ix, "pipe": pipe_ix}


@pytest.mark.parametrize("mname", list(ranks.MESHES))
@pytest.mark.parametrize("case", ranks.TOY_CASES)
def test_pipeline_apply_matches_jax(jax_runs, four, mname, case):
    """Each rank's output rows and its rows' input gradient (the same on
    every pipe rank of a data row: the input's cotangent is summed over
    the pipe), and its stage block's gradient summed over the data rows,
    equal the JAX function's."""
    ref = jax_runs[f"{mname}/{case}"]
    rows = _row_slices(mname)
    for r in range(N):
        d, s = _coord(r, mname)
        got = four[r]["toy"][f"{mname}/{case}"]
        np.testing.assert_allclose(got["out"], ref["out"][rows[d]],
                                   rtol=1e-5, atol=1e-6)
        _close_grad(got["dx"], ref["dx"][rows[d]])
    for k in ref["dstacked"]:
        for s in range(ranks.MESHES[mname]["pipe"]):
            block = sum(four[r]["toy"][f"{mname}/{case}"]["dstacked"][k][0]
                        for r in range(N) if _coord(r, mname)[1] == s)
            _close_grad(block, ref["dstacked"][k][s], k)
            if case == "counts":  # the padded chunks are never applied
                c = ranks.COUNTS[mname][s]
                assert not np.any(block[c:]), (k, s)


def test_pp_train_step_loss_falls(four):
    """``make_train_step_pp`` (the JAX ``test_pp_train_step_loss_falls``
    on the port): the loss falls under 0.6 of its first value in 25
    steps, the same on every rank (each holds one stage)."""
    losses = four[0]["train_step"]
    assert losses[-1] < losses[0] * 0.6, losses[::8]
    for r in range(1, N):
        assert four[r]["train_step"] == losses


def test_switch_stage_count_is_held_to_the_pipe_axis():
    from fluxdistributed_tpu_torch.mesh import Mesh
    from fluxdistributed_tpu_torch.parallel import pipeline_apply, switch_stage

    mesh = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                axis="pipe", axes=(("pipe", 4),), coords=(0,))
    with pytest.raises(ValueError, match="switch_stage got 3 stage fns"):
        pipeline_apply(switch_stage([ranks.toy_stage] * 3), mesh)
    with pytest.raises(ValueError, match="not on the mesh"):
        pipeline_apply(ranks.toy_stage, mesh, batch_axis="data")


@pytest.mark.parametrize("M,V", F1B_LOCAL)
@pytest.mark.parametrize("schedule", ["1f1b", "zb"])
def test_1f1b_on_the_local_exchange_matches_jax(jax_runs, data, M, V,
                                                schedule):
    """S = 4 pipe devices in one process: the loss, every stage's
    gradients and the outer gradients against JAX's 1F1B, and ZB bit
    for bit against the port's 1F1B."""
    toy = data[0]
    ref = jax_runs[f"local/{M}/{V}"]
    stacked = {k: torch.from_numpy(v)
               for k, v in toy[f"local/{M}/{V}"]["stacked"].items()}
    args = (stacked, {k: torch.from_numpy(v) for k, v in toy["outer"].items()},
            torch.from_numpy(toy["tok"]), torch.from_numpy(toy["lab"]))

    def run(sched):
        fn = pipeline_grads_1f1b(ranks.toy_stage, ranks.toy_embed,
                                 ranks.toy_head, LocalPipe(S),
                                 num_microbatches=M, interleave=V,
                                 schedule=sched)
        loss, g_st, g_out = fn(*args)
        assert fn.schedule.schedule == sched
        return loss, g_st, g_out

    loss, g_st, g_out = run(schedule)
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)
    for k, v in g_st.items():
        assert v.shape == stacked[k].shape
        _close_grad(v.numpy(), ref["stages"][k], k)
    for k, v in g_out.items():
        _close_grad(v.numpy(), ref["outer"][k], k)
    if schedule == "zb":
        l1, s1, o1 = run("1f1b")
        assert torch.equal(loss, l1)
        for k in s1:
            assert torch.equal(g_st[k], s1[k]), k
        for k in o1:
            assert torch.equal(g_out[k], o1[k]), k


def test_local_exchange_refuses_a_data_axis():
    with pytest.raises(ValueError, match="holds one data row"):
        pipeline_grads_1f1b(ranks.toy_stage, ranks.toy_embed, ranks.toy_head,
                            LocalPipe(2), batch_axis="data")


@pytest.mark.parametrize("name", list(ranks.F1B_RANK_CASES))
def test_1f1b_on_gloo_ranks_matches_jax(jax_runs, four, name):
    """Over the process group: ZB interleaved on ``{pipe: 4}`` and 1F1B
    with the data mean composed on ``{data: 2, pipe: 2}``: every rank's
    loss and outer gradients, and its stage block's gradients."""
    mname = ranks.F1B_RANK_CASES[name][0]
    ref = jax_runs[f"f1b/{name}"]
    for r in range(N):
        _, s = _coord(r, mname)
        got = four[r]["f1b"][name]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for k, v in got["stages"].items():
            _close_grad(v[0], ref["stages"][k][s], k)
        for k, v in got["outer"].items():
            _close_grad(v, ref["outer"][k], k)


@pytest.mark.parametrize("name", list(ranks.LM_CASES))
def test_lm_pipeline_matches_jax(jax_runs, four, name):
    """Each rank's split tree (its stage block, bit for bit), loss and
    gradients from the same flax weights."""
    mname, depth, tied, *_ = ranks.LM_CASES[name]
    ref = jax_runs[f"lm/{name}"]
    for r in range(N):
        _, s = _coord(r, mname)
        got = four[r]["lm"][name]
        assert set(got["split"]) == set(ref["split"])
        for k, v in got["split"].items():
            want = ref["split"][k][s:s + 1] if k.startswith("stages/") \
                else ref["split"][k]
            np.testing.assert_array_equal(v, want, err_msg=k)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        for k, g in got["grads"].items():
            want = ref["grads"][k][s:s + 1] if k.startswith("stages/") \
                else ref["grads"][k]
            _close_grad(g, want, f"rank {r} {k}")
    if tied:
        # the tied embedding's gradient has its lookup part (JAX: the
        # replicated input's psum) on every rank, not on rank 0 alone
        lookup = ref["grads"]["outer/embed.weight"]
        assert np.abs(lookup).max() > 0


def test_lm_pipeline_refusals_match_jax():
    from fluxdistributed_tpu_torch.models import lm_pp, lm_pp_1f1b

    mesh = LocalPipe(4)

    def lm(depth=8, **kw):
        return ranks.lm_model(depth, True, **kw)

    with pytest.raises(ValueError, match="S\\+1"):
        lm_pp_1f1b(lm(), mesh, boundaries=(0, 4, 8))
    with pytest.raises(ValueError, match="span the whole stack"):
        lm_pp_1f1b(lm(), mesh, boundaries=(0, 2, 4, 6, 7))
    with pytest.raises(ValueError, match=">= 1 block"):
        lm_pp_1f1b(lm(), mesh, boundaries=(0, 4, 4, 6, 8))
    with pytest.raises(ValueError, match="interleave"):
        lm_pp_1f1b(lm(), mesh, interleave=True, boundaries=(0, 2, 4, 6, 8))
    with pytest.raises(ValueError, match="pp plan"):
        lm_pp_1f1b(lm(6), mesh)
    with pytest.raises(ValueError, match="use_rope=True"):
        lm_pp_1f1b(lm(use_rope=False, max_len=16), mesh)
    with pytest.raises(ValueError, match="dropout=0 only"):
        lm_pp_1f1b(lm(dropout=0.1), mesh)
    from fluxdistributed_tpu_torch.mesh import Mesh

    one = Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
               axis="pipe", axes=(("pipe", 1),), coords=(0,))
    with pytest.raises(ValueError, match="moe_every > 0"):
        lm_pp(lm(4, moe_every=2, num_experts=2, moe_fn=lambda *a: a), one)
