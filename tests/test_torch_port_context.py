"""Port parity: context parallelism (``parallel/context.py``: ring
attention, XLA walk and flash hops, and Ulysses) and
``prepare_training(spmd="sp")``, against the JAX package.

The port's world is 4 gloo ranks on the CPU (one spawn, bodies in
``test_torch_port_context_ranks.py``), laid out ``{seq: 4}`` and
``{data: 2, seq: 2}``; the JAX side runs the same functions under
``shard_map`` on ``make_mesh`` over 4 of the conftest's virtual CPU
devices (device ``r`` at rank ``r``'s coordinates), on the same numpy
inputs.  The JAX flash ring runs its Pallas kernels in interpret mode;
the port's runs the kernels' plain versions.

Tolerances are the JAX files' own (``tests/test_context_parallel.py``):
outputs 2e-5, gradients 1e-4.  The ``sp`` trainer (f32 lm, 3 adam
steps at lr 3e-3, the port's flash ring and Ulysses against JAX's XLA
ring and Ulysses): losses within 1e-5 relative, params within 2 lr
(Adam's first update is ~lr sign(g), ROADMAP).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_context_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu.data import SyntheticTextDataset as JText
from fluxdistributed_tpu.mesh import make_mesh as jmake_mesh
from fluxdistributed_tpu.models import lm_loss_fn as jlm_loss_fn
from fluxdistributed_tpu.models.transformer_lm import TransformerLM as JLM
from fluxdistributed_tpu.parallel.context import (
    make_ring_attention as jring, make_ulysses_attention as julysses)
from fluxdistributed_tpu.train import prepare_training as jprepare
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.data import SyntheticTextDataset
from fluxdistributed_tpu_torch.mesh import Mesh
from fluxdistributed_tpu_torch.models import (flax_to_state_dict, lm_loss_fn,
                                              lm_tiny)
from fluxdistributed_tpu_torch.parallel import (make_ring_attention,
                                                make_ulysses_attention)
from fluxdistributed_tpu_torch.train import prepare_training

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

N = 4
B, T, H, DH = 2, 32, 8, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jmesh(axes):
    return jmake_mesh(axes, jax.devices()[:N])


def _jlm(attn_fn):
    return JLM(vocab=ranks.VOCAB, dtype=jnp.float32, dropout=0.0,
               attn_fn=attn_fn, **ranks.SMALL)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    qkvg = [rng.normal(size=(B, T, H, DH)).astype(np.float32)
            for _ in range(4)]
    toks = np.random.default_rng(7).integers(
        0, ranks.VOCAB, (8, 16)).astype(np.int32)
    mesh = _jmesh({"data": 2, "seq": 2})
    # the trainer's own init (seed 0), shared by both strategies
    task = jprepare(_jlm(jring(mesh, batch_axis="data", causal=True)),
                    JText(vocab=ranks.VOCAB, seqlen=16),
                    joptim.adam(ranks.LR), mesh=mesh, batch_size=8,
                    cycles=3, spmd="sp", topk=())
    params = _np_tree(task.state.params)
    return qkvg, toks, params


@pytest.fixture(scope="module")
def spawn(data):
    """The ranks' run, started before the JAX references compute."""
    (q, k, v, g), toks, params = data
    return Spawned(ranks.context_all, N, q, k, v, g,
                   flax_to_state_dict(params), toks)


def _attn_ref(mesh, case, q, k, v, g):
    strategy, impl, causal, hkv = ranks.ATTN_CASES[case]
    batch_axis = "data" if "data" in mesh.axis_names else None
    if strategy == "ring":
        fn = jring(mesh, batch_axis=batch_axis, causal=causal, impl=impl,
                   block_q=4, block_k=4)
    else:
        fn = julysses(mesh, batch_axis=batch_axis, causal=causal)
    args = [jnp.asarray(x) for x in (q, k[:, :, :hkv], v[:, :, :hkv])]

    def loss(*a):
        out = fn(*a)
        return (out * jnp.asarray(g)).sum(), out

    # one compile gives the output and the gradients
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _jax_sp_trainer(mesh, attn_fn, toks):
    model = _jlm(attn_fn)
    task = jprepare(model, JText(vocab=ranks.VOCAB, seqlen=16),
                    joptim.adam(ranks.LR), mesh=mesh, batch_size=8,
                    cycles=3, spmd="sp", loss_fn=jlm_loss_fn(model), topk=())
    st = task.state  # the trainer's init: the same params as ``data``'s
    batch = jsharding.shard_batch({"tokens": toks}, mesh)
    losses = []
    for _ in range(3):
        st, m = task.step_fn(st, batch)
        losses.append(float(m["loss"]))
    ev, _ = task.eval_fn(st, batch)
    return losses, flax_to_state_dict(_np_tree(st.params)), float(ev)


@pytest.fixture(scope="module")
def jax_runs(data, spawn):
    (q, k, v, g), toks, params = data
    out = {}
    for mname, axes in ranks.MESHES.items():
        mesh = _jmesh(axes)
        out[f"{mname}_coords"] = [
            dict(zip(mesh.axis_names, np.argwhere(mesh.devices == d)[0]
                     .tolist())) for d in mesh.devices.reshape(-1)]
        for case in ranks.ATTN_CASES:
            out[f"{mname}/{case}"] = _attn_ref(mesh, case, q, k, v, g)
    mesh = _jmesh({"seq": 4})
    try:
        julysses(mesh)(*(jnp.asarray(x[:, :, :6]) for x in (q, k, v)))
    except ValueError as e:
        out["ulysses_refusal"] = str(e)
    mesh = _jmesh({"data": 2, "seq": 2})
    out["ring"] = _jax_sp_trainer(
        mesh, jring(mesh, batch_axis="data", causal=True), toks)
    out["ulysses"] = _jax_sp_trainer(
        mesh, julysses(mesh, batch_axis="data", causal=True), toks)
    return out


@pytest.fixture(scope="module")
def four(spawn):
    return spawn.result()


def _assemble(four, key, coords_key, i):
    """The global array of entry ``i`` of every rank's ``key`` block."""
    shape = {0: (B, T, H, DH)}.get(i)
    blocks = [four[r]["attn"][key][i] for r in range(N)]
    d = max(c.get("data", 0) for c in (four[r]["attn"][coords_key]
                                       for r in range(N))) + 1
    s = N // d
    b, t = blocks[0].shape[:2]
    full = np.zeros((b * d, t * s) + blocks[0].shape[2:], np.float32)
    for r in range(N):
        c = four[r]["attn"][coords_key]
        i0, s0 = c.get("data", 0), c["seq"]
        full[i0 * b:(i0 + 1) * b, s0 * t:(s0 + 1) * t] = blocks[r]
    assert shape is None or full.shape == shape
    return full


def test_rank_coordinates_are_jax_devices(jax_runs, four):
    for mname in ranks.MESHES:
        for r in range(N):
            assert four[r]["attn"][f"{mname}_coord"] == \
                jax_runs[f"{mname}_coords"][r]


@pytest.mark.parametrize("mname", list(ranks.MESHES))
@pytest.mark.parametrize("case", list(ranks.ATTN_CASES))
def test_attention_matches_jax(jax_runs, four, mname, case):
    """Each rank's output block and its q/k/v gradient blocks, put
    together, equal the JAX function's global output and gradients."""
    ref = jax_runs[f"{mname}/{case}"]
    for i, (what, tol) in enumerate((("out", 2e-5), ("dq", 1e-4),
                                     ("dk", 1e-4), ("dv", 1e-4))):
        got = _assemble(four, f"{mname}/{case}", f"{mname}_coord", i)
        np.testing.assert_allclose(got, ref[i], rtol=tol, atol=tol,
                                   err_msg=f"{mname} {case} {what}")


def test_ulysses_head_divisibility_error(jax_runs, four):
    assert four[0]["attn"]["ulysses_refusal"] == jax_runs["ulysses_refusal"]
    assert "divisible by the 'seq' axis size (4)" in \
        four[0]["attn"]["ulysses_refusal"]


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_sp_trainer_matches_jax(jax_runs, four, strategy):
    """``prepare_training(spmd="sp")`` on ``{data: 2, seq: 2}``: 3 adam
    steps from the JAX trainer's init on the same batches; every rank
    holds the same replicated params."""
    ref = jax_runs[strategy]
    for r in range(N):
        losses, params, ev = four[r][strategy]
        np.testing.assert_allclose(losses, ref[0], rtol=1e-5, atol=0)
        np.testing.assert_allclose(ev, ref[2], rtol=1e-5, atol=0)
        assert set(params) == set(ref[1])
        for k in ref[1]:
            np.testing.assert_allclose(params[k], ref[1][k], rtol=0,
                                       atol=2 * ranks.LR, err_msg=k)
            np.testing.assert_array_equal(params[k], four[0][strategy][1][k])


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_each_rank_attends_its_block(four, strategy):
    """Every attention call of a rank gets ``[B/D, T/S, H, Dh]``: 8 rows
    over 2 data ranks, 16 positions over 2 seq ranks, 4 heads of 8."""
    for r in range(N):
        assert four[r][f"{strategy}_seen"] == [(4, 8, 4, 8)]


def test_dropout_shards_draw_one_ranks_masks(four):
    """Dropout 0.1 under ``sp`` on ``{data: 2, seq: 2}`` equals the
    data-parallel step over the data rows with the same seed: each seq
    rank draws its positions' bits of the whole sequence's masks."""
    for r in range(N):
        sp, dp = four[r]["dropout_sp"], four[r]["dropout_dp"]
        np.testing.assert_allclose(sp[0], dp[0], rtol=1e-6, atol=0)
        np.testing.assert_allclose(sp[2], dp[2], rtol=1e-6, atol=0)
        for k in dp[1]:
            np.testing.assert_allclose(sp[1][k], dp[1][k], rtol=0,
                                       atol=1e-5, err_msg=k)


def test_cli_sp_ulysses_equals_train(four):
    """``--spmd sp --seq-parallel 2 --sp-strategy ulysses`` on 4 ranks
    equals ``prepare_training`` + ``train`` with the same arguments, bit
    for bit."""
    for r in range(N):
        got = four[r]["cli"]
        assert got["mesh"] == {"data": 2, "seq": 2}
        assert got["strategy"] == "ulysses"
        assert len(got["cli"]) == 3 and got["cli"] == got["train"]


def test_cli_refusals_on_ranks(four):
    """``bin/driver.py``'s messages where the seq mesh exists."""
    got = four[0]["cli_refusals"]
    assert got == {
        "--spmd sp --window 4": "--window is not supported with --spmd sp "
        "(context-parallel attention is unwindowed)",
        "--spmd sp --attn flash": "--attn conflicts with --spmd sp: sequence "
        "parallelism picks its own attention core (use --sp-strategy)",
        "--spmd sp --seq-parallel 3": "--seq-parallel 3 must be >=2 and "
        "divide 4 devices",
        "--spmd sp --seqlen 15": "--seqlen 15 must be a multiple of the seq "
        "axis size 4"}


def _fake_mesh(axes):
    """A mesh object for refusals raised before any collective."""
    names = tuple(axes)
    return Mesh(group=None, rank=0, size=1, device=torch.device("cpu"),
                axis=names[0], axes=tuple(axes.items()),
                coords=(0,) * len(names))


def test_prepare_training_sp_refusals():
    ds = SyntheticTextDataset(vocab=ranks.VOCAB, seqlen=16)
    seq = _fake_mesh({"data": 1, "seq": 1})
    dense = lm_tiny(vocab=ranks.VOCAB, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh with 'data' and "
                                         "'seq' axes"):
        prepare_training(dense, ds, optim.adam(1e-3), spmd="sp",
                         mesh=_fake_mesh({"data": 1}),
                         loss_fn=lm_loss_fn(dense), topk=())
    with pytest.raises(ValueError, match="needs a mesh with 'data' and "
                                         "'seq' axes"):
        prepare_training(dense, ds, optim.adam(1e-3), spmd="sp",
                         loss_fn=lm_loss_fn(dense), topk=(), device="cpu")
    with pytest.raises(ValueError, match="attn_fn is sequence-parallel"):
        prepare_training(dense, ds, optim.adam(1e-3), spmd="sp", mesh=seq,
                         loss_fn=lm_loss_fn(dense), topk=())
    other = lm_tiny(vocab=ranks.VOCAB, device="cpu", attn_fn=make_ring_attention(
        _fake_mesh({"data": 1, "seq": 1, "model": 1}), batch_axis="data"))
    with pytest.raises(ValueError, match="the step on"):
        prepare_training(other, ds, optim.adam(1e-3), spmd="sp", mesh=seq,
                         loss_fn=lm_loss_fn(other), topk=())
    ring = lm_tiny(vocab=ranks.VOCAB, device="cpu",
                   attn_fn=make_ring_attention(seq, batch_axis="data"))
    for kw, msg in (({"zero1": True}, "zero1=True applies to the DP paths"),
                    ({"steps_per_call": 2}, "steps_per_call > 1 requires"),
                    ({"spmd": "pp"}, "loss_fn override cannot apply")):
        with pytest.raises(ValueError, match=msg):
            prepare_training(ring, ds, optim.adam(1e-3), mesh=seq,
                             loss_fn=lm_loss_fn(ring), topk=(),
                             **{"spmd": "sp", **kw})


def test_context_function_refusals():
    seq = _fake_mesh({"data": 1, "seq": 1})
    with pytest.raises(ValueError, match="impl must be 'xla' or 'flash'"):
        make_ring_attention(seq, impl="pallas")
    with pytest.raises(ValueError, match="not on the mesh"):
        make_ulysses_attention(_fake_mesh({"data": 1}))
    with pytest.raises(ValueError, match="seq_shard applies to the full"):
        from fluxdistributed_tpu_torch.models import make_decode_cache

        m = lm_tiny(vocab=ranks.VOCAB, device="cpu")
        m(torch.zeros((1, 1), dtype=torch.long), make_decode_cache(m, 1, 4),
          seq_shard=(0, 4))


def test_cli_sp_refusals_mirror_the_jax_cli():
    """Refusals before any rank is needed, and ``--spmd sp`` on one rank
    (as ``bin/driver.py`` refuses it on one device)."""
    base = ranks.CLI_ARGS
    for extra, msg in (
            (["--seq-parallel", "2"],
             "--seq-parallel only applies with --spmd sp"),
            (["--sp-strategy", "ulysses"],
             "--sp-strategy only applies with --spmd sp"),
            (["--spmd", "sp"], "--seq-parallel 1 must be >=2 and divide 1 "
                               "devices"),
            (["--model", "resnet18", "--image-size", "8", "--num-classes",
              "4", "--spmd", "sp", "--seq-parallel", "2"],
             "--spmd sp needs an lm_* model")):
        with pytest.raises(SystemExit, match=msg.replace("*", r"\*")):
            cli.run(base + extra)
