"""Port parity: the image-training path (losses, metrics, tree helpers,
LARS and EMA, the small models and the ResNets with their BatchNorm,
the loss adapter, the DP, ZeRO-1 and eval steps, data, trainer and CLI)
against the JAX package, on the same numpy inputs and the same flax
weights (``load_flax_resnet`` / ``load_flax_simple``), f32 unless a test
says otherwise.  The N-rank worlds are gloo ranks on the CPU
(``mesh.run_ranks``, bodies in ``test_torch_port_vision_ranks.py``); the
JAX side runs ``make_train_step`` on ``data_mesh(N)`` over the global
batch, where GSPMD takes BatchNorm statistics over the global batch.

The ResNets' flax weights are random: He-normal kernels, and every
BatchNorm scale, bias and running stat off its init value (a block's
last scale, zero at init, small and positive), so that no residual
branch is cut off and eval mode reads real running stats.

Tolerances: logits and losses rtol 1e-4 / atol 1e-5; gradients, params
and running stats element-wise rtol 1e-3 / atol 1e-5 of the leaf's
scale (its largest entry, at least 1: an entry of a conv gradient sums
thousands of products, whose f32 rounding grows with the leaf's
magnitude, not the entry's); losses and
metrics 1e-6 relative (one f32 log-softmax); LARS and EMA 1e-6 relative
over 5 steps (the JAX op order; LARS norms from two libraries); top-k
accuracies, data and name mappings exactly.

The single-model ResNet parity is held to flax evaluated in float64:
flax's BatchNorm forms the variance as ``E[x²] - E[x]²`` in float32,
which cancels where a channel's mean is large against its spread, and
on the width-8 ResNet-50 that moves flax's own float32 gradients by up
to 2 % of a leaf from the float64 ones, where the port's float32
gradients stay within 1e-5 (ROADMAP C7,
``test_batchnorm_variance_against_flax``).  The multi-step and N-rank
checks use ResNet-18, where flax's float32 stays within the tolerances.
"""

import concurrent.futures
import functools
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_vision_ranks as ranks
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu import tree as jtree
from fluxdistributed_tpu.data.cifar import CIFAR10Dataset as JCIFAR
from fluxdistributed_tpu.data.synthetic import SyntheticDataset as JSynth
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.models import MLP as JMLP
from fluxdistributed_tpu.models import SimpleCNN as JSimpleCNN
from fluxdistributed_tpu.models import import_torch_resnet
from fluxdistributed_tpu.models import resnet18 as jresnet18
from fluxdistributed_tpu.models import resnet50 as jresnet50
from fluxdistributed_tpu.models import s2d_stem_kernel as js2d_kernel
from fluxdistributed_tpu.models import space_to_depth as jspace_to_depth
from fluxdistributed_tpu.ops import crossentropy as jcrossentropy
from fluxdistributed_tpu.ops import logitcrossentropy as jlce
from fluxdistributed_tpu.ops import mse as jmse
from fluxdistributed_tpu.ops import showpreds as jshowpreds
from fluxdistributed_tpu.ops import topkaccuracy as jtopk
from fluxdistributed_tpu.parallel.dp import TrainState as JState
from fluxdistributed_tpu.parallel.dp import flax_loss_fn
from fluxdistributed_tpu.parallel.dp import make_eval_step as jmake_eval
from fluxdistributed_tpu.parallel.dp import make_train_step as jmake_step
from fluxdistributed_tpu_torch import optim, tree
from fluxdistributed_tpu_torch.data import CIFAR10Dataset, SyntheticDataset
from fluxdistributed_tpu_torch.mesh import run_ranks
from fluxdistributed_tpu_torch.models import (MLP, BatchNorm, BatchStats,
                                              SimpleCNN, load_flax_resnet,
                                              load_flax_simple, resnet18,
                                              resnet50, s2d_stem_kernel,
                                              space_to_depth)
from fluxdistributed_tpu_torch.ops.losses import (crossentropy,
                                                  logitcrossentropy, mse)
from fluxdistributed_tpu_torch.ops.metrics import showpreds, topkaccuracy
from fluxdistributed_tpu_torch.parallel import (TrainState, make_eval_step,
                                                make_train_step,
                                                module_loss_fn)
from fluxdistributed_tpu_torch.train import (NullLogger, evaluate,
                                             prepare_training, train)

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

JRESNET = {18: jresnet18, 50: jresnet50}
RESNET = {18: resnet18, 50: resnet50}
SIZE, NCLS = 32, 10
LR = 0.05


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _close_leaf(got, want):
    """A gradient, param or running-stat leaf: rtol 1e-3 and atol 1e-5
    of the leaf's scale (its largest entry, at least 1)."""
    want = np.asarray(want, np.float64)
    _close(got, want, 1e-3, 1e-5 * max(1.0, float(np.abs(want).max())))


def _weights(shapes, seed):
    """Random flax weights for the tree of ``shapes``: kernels He-normal
    over their fan-in, BatchNorm scales, biases and running stats off
    their init values (see the module docstring)."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        shape, key = leaf.shape, jax.tree_util.keystr(path)
        if "'kernel'" in key:
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            return (std * rng.standard_normal(shape)).astype(np.float32)
        if "'scale'" in key:
            last = "BatchNorm_2" in key or (
                "BatchNorm_1" in key and "Basic" in key)
            x = (0.2 * np.abs(rng.standard_normal(shape)) if last
                 else 1.0 + 0.1 * rng.standard_normal(shape))
            return x.astype(np.float32)
        if "'var'" in key:
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, shapes)


def _images(seed, n, size=SIZE):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    y = np.eye(NCLS, dtype=np.float32)[rng.integers(0, NCLS, n)]
    return x, y


def _flax_resnet(depth, s2d=False, seed=0):
    """A flax resnet (width 8, f32) and random weights for it (shapes
    from ``eval_shape``: no init is compiled)."""
    jm = JRESNET[depth](num_classes=NCLS, width=8, dtype=jnp.float32,
                        space_to_depth=s2d)
    x0 = np.zeros((1, SIZE, SIZE, 3), np.float32)
    v = jax.eval_shape(lambda k, x: jm.init(k, x, train=True),
                       jax.random.PRNGKey(0), x0)
    return (jm, _weights(v["params"], seed + 1),
            _weights(v["batch_stats"], seed + 2))


def _port_resnet(depth, params, stats, **kw):
    model = RESNET[depth](num_classes=NCLS, width=8, dtype=torch.float32,
                          device="cpu", **kw)
    return load_flax_resnet(model, jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, stats))


def _port_names(depth, params, stats, s2d=False):
    """A flax (params, batch_stats) pair under the port's names."""
    m = _port_resnet(depth, params, stats, space_to_depth=s2d)
    return {k: v.detach().numpy() for k, v in
            [*m.named_parameters(), *m.named_buffers()]}


def _torch_batch(x, y):
    return {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("onehot", [False, True])
def test_logitcrossentropy(onehot, smoothing):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((6, NCLS))).astype(np.float32)
    ids = rng.integers(0, NCLS, 6).astype(np.int32)
    labels = np.eye(NCLS, dtype=np.float32)[ids] if onehot else ids
    got = logitcrossentropy(torch.from_numpy(logits), torch.from_numpy(labels),
                            label_smoothing=smoothing)
    want = jlce(jnp.asarray(logits), jnp.asarray(labels),
                label_smoothing=smoothing)
    _close(got.item(), want, 1e-6, 0)


def test_crossentropy_and_mse():
    rng = np.random.default_rng(1)
    probs = rng.dirichlet(np.ones(NCLS), 5).astype(np.float32)
    ids = rng.integers(0, NCLS, 5).astype(np.int32)
    for labels in (ids, np.eye(NCLS, dtype=np.float32)[ids]):
        _close(crossentropy(torch.from_numpy(probs),
                            torch.from_numpy(labels)).item(),
               jcrossentropy(jnp.asarray(probs), jnp.asarray(labels)), 1e-6, 0)
    a, b = rng.standard_normal((2, 4, 3)).astype(np.float32)
    _close(mse(torch.from_numpy(a), torch.from_numpy(b)).item(),
           jmse(jnp.asarray(a), jnp.asarray(b)), 1e-6, 0)


@pytest.mark.parametrize("k", [1, 5, 20])
def test_topkaccuracy_and_showpreds(k):
    """Scores without ties (the port's and JAX's top-k orders differ
    only on ties); k = 20 is clipped to the 10 classes."""
    rng = np.random.default_rng(2)
    scores = rng.permuted(np.tile(np.arange(NCLS, dtype=np.float32), (16, 1)),
                          axis=1)
    ids = rng.integers(0, NCLS, 16).astype(np.int32)
    for labels in (ids, np.eye(NCLS, dtype=np.float32)[ids]):
        got = topkaccuracy(torch.from_numpy(scores), torch.from_numpy(labels),
                           k=k)
        assert got.item() == float(jtopk(jnp.asarray(scores),
                                         jnp.asarray(labels), k=k))
    names = [f"c{i}" for i in range(NCLS)]
    for kw in ({}, {"class_names": names, "names": [f"r{i}" for i in
                                                    range(16)]}):
        assert showpreds(torch.from_numpy(scores), k=k, **kw) == jshowpreds(
            scores, k=k, **kw)


# --------------------------------------------------------------- tree


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "sub": {"b": rng.standard_normal(5).astype(np.float32),
                 "i": np.arange(4, dtype=np.int32)}}
    b = {"w": a["w"] + 1e-6, "sub": {"b": a["sub"]["b"] + 1.0,
                                     "i": a["sub"]["i"]}}
    ta = tree.tree_map(torch.from_numpy, a)
    tb = tree.tree_map(torch.from_numpy, b)
    assert tree.count_params(ta) == jtree.count_params(a) == 21
    assert tree.nbytes(ta) == jtree.nbytes(a) == 84
    assert tree.allclose(ta, tb) == jtree.allclose(a, b) is False
    assert tree.allclose(ta, ta) == jtree.allclose(a, a) is True
    bad, jbad = tree.mismatches(ta, tb), jtree.mismatches(a, b)
    assert [r for _, r in bad] == [r for _, r in jbad]
    assert [p for p, _ in bad] == ["sub/b"]
    c = {"w": a["w"][:2], "sub": a["sub"]}
    assert [r for _, r in tree.mismatches(
        tree.tree_map(torch.from_numpy, c), ta)] == [
            r for _, r in jtree.mismatches(c, a)]
    assert tree.mismatches({"x": None}, {"x": ta["w"]}) == [
        ("x", "one side is None")]
    with pytest.raises(AssertionError, match="sub/b"):
        tree.assert_close(ta, tb, msg="m")
    half = tree.cast(ta, torch.bfloat16)
    jhalf = jtree.cast(a, jnp.bfloat16)
    assert half["w"].dtype == torch.bfloat16 and half["sub"]["i"].dtype == (
        torch.int32)
    _close(half["w"].float(), np.asarray(jhalf["w"], np.float32), 0, 0)
    host = tree.to_host(half)
    assert host["w"].device.type == "cpu" and not host["w"].requires_grad


# -------------------------------------------------------------- optim


def _opt_params(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "zero": np.zeros(5, np.float32)}


def _run_opts(opt, jopt, steps=5, seed=4):
    rng = np.random.default_rng(seed)
    p = _opt_params(rng)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p.items()} for _ in range(steps)]
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ts, js = opt.init(tp), jopt.init(jp)
    for i, g in enumerate(grads):
        tp, ts = opt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           ts, i)
        jp, js = jopt.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                            js, i)
    return tp, ts, jp, js


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_lars(wd):
    """The zero leaf has |p| = 0, so its trust ratio is 1."""
    tp, _, jp, _ = _run_opts(optim.lars(0.5, weight_decay=wd),
                             joptim.lars(0.5, weight_decay=wd))
    for k in tp:
        _close(tp[k], jp[k], 1e-6, 1e-7)
    assert tp["zero"].abs().sum() > 0


def test_with_ema_and_ema_params():
    tp, ts, jp, js = _run_opts(optim.with_ema(optim.momentum(0.1), 0.99),
                               joptim.with_ema(joptim.momentum(0.1), 0.99))
    ema, jema = optim.ema_params(ts), joptim.ema_params(js)
    for k in tp:
        _close(tp[k], jp[k], 1e-6, 1e-7)
        _close(ema[k], jema[k], 1e-6, 1e-7)
        assert not torch.equal(ema[k], tp[k])
    with pytest.raises(ValueError, match="EMA"):
        optim.ema_params(optim.momentum(0.1).init(tp))


# ------------------------------------------------------ small models


@pytest.mark.parametrize("size", [8, 9])
def test_simple_models_match_flax(size):
    """SAME padding is asymmetric at stride 2 on an even side."""
    x = np.random.default_rng(5).standard_normal(
        (3, size, size, 3)).astype(np.float32)
    jm = JSimpleCNN(num_classes=NCLS)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    model = load_flax_simple(SimpleCNN(num_classes=NCLS, device="cpu"),
                             jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got, jm.apply({"params": params}, x), 1e-4, 1e-5)
    jmlp = JMLP(features=(16, NCLS))
    mp = jmlp.init(jax.random.PRNGKey(1), x)["params"]
    mlp = load_flax_simple(MLP(size * size * 3, (16, NCLS), device="cpu"),
                           jax.tree.map(np.asarray, mp))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
    _close(got, jmlp.apply({"params": mp}, x), 1e-4, 1e-5)


# ------------------------------------------------------------ ResNets


@functools.lru_cache(maxsize=None)
def _resnet_reference(depth, s2d):
    """Flax in float64 on the perturbed weights: eval logits, and the
    train-mode loss, gradients and new batch_stats on one batch."""
    jm, params, stats = _flax_resnet(depth, s2d)
    x, y = _images(10 + depth + s2d, 8)
    with jax.enable_x64(True):
        jm64 = JRESNET[depth](num_classes=NCLS, width=8, dtype=jnp.float64,
                              space_to_depth=s2d)
        lf = flax_loss_fn(jm64, jlce)

        def fn(p, s, x, y):
            logits = jm64.apply({"params": p, "batch_stats": s}, x,
                                train=False)
            (loss, (ms, _)), g = jax.value_and_grad(
                lambda q: lf(q, {"batch_stats": s}, {"image": x, "label": y},
                             True), has_aux=True)(p)
            return logits, loss, g, ms["batch_stats"]

        f64 = functools.partial(jax.tree.map, lambda a: np.float64(a))
        out = jax.jit(fn)(f64(params), f64(stats), x.astype(np.float64),
                          y.astype(np.float64))
        out = jax.tree.map(np.asarray, out)
    return x, y, params, stats, out


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("depth,s2d", [(18, False), (18, True), (50, False),
                                       (50, True)],
                         ids=["resnet18", "resnet18-s2d", "resnet50",
                              "resnet50-s2d"])
def test_resnet_matches_flax(depth, s2d, remat):
    """Eval logits; train-mode loss, gradients and new running stats
    through ``module_loss_fn``; the model state passed in unchanged."""
    x, y, params, stats, (jlogits, jloss, jgrads, jstats) = (
        _resnet_reference(depth, s2d))
    model = _port_resnet(depth, params, stats, space_to_depth=s2d,
                         remat=remat)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), jlogits, 1e-4, 1e-5)
    P = {k: p.detach().requires_grad_(True)
         for k, p in model.named_parameters()}
    S = {k: b.detach().clone() for k, b in model.named_buffers()}
    S0 = {k: v.clone() for k, v in S.items()}
    loss, (new, _) = module_loss_fn(model, logitcrossentropy)(
        P, S, _torch_batch(x, y), True)
    grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
    _close(loss.item(), jloss, 1e-4, 1e-5)
    ref = _port_names(depth, jgrads, jstats, s2d)
    assert set(grads) | set(new) == set(ref)
    for k, g in grads.items():
        _close_leaf(g, ref[k])
    for k, v in new.items():
        _close_leaf(v, ref[k])
    assert all(torch.equal(S[k], S0[k]) for k in S)  # never written


def test_module_loss_fn_leaves_model_state_unchanged():
    """``torch.nn.BatchNorm2d`` under ``functional_call`` overwrites the
    running stats it is handed; the port's BatchNorm returns new ones."""
    model = resnet18(num_classes=NCLS, width=8, device="cpu")
    S = {k: b.detach().clone() for k, b in model.named_buffers()}
    S0 = {k: v.clone() for k, v in S.items()}
    P = {k: p.detach() for k, p in model.named_parameters()}
    _, (new, _) = module_loss_fn(model, logitcrossentropy)(
        P, S, _torch_batch(*_images(6, 4)), True)
    assert all(torch.equal(S[k], S0[k]) for k in S)
    assert all(new[k] is not S[k] for k in S) and set(new) == set(S)
    assert not torch.equal(new["bn1.running_mean"], S["bn1.running_mean"])
    ref = torch.nn.BatchNorm2d(4)
    before = ref.running_mean.clone()
    torch.func.functional_call(ref, dict(ref.named_buffers()),
                               (torch.randn(2, 4, 3, 3),))
    assert not torch.equal(ref.running_mean, before)


def test_batchnorm_variance_against_flax():
    """ROADMAP C7: with a channel mean large against its spread, flax's
    float32 ``E[x²] - E[x]²`` loses the batch variance, and so the
    normalised output, that the port's BatchNorm keeps; both are held to
    flax in float64.  The running variance starts at 0, so the new one
    is 0.1 x the batch's."""
    rng = np.random.default_rng(7)
    x = (10.0 + 0.01 * rng.standard_normal((8, 5, 5, 4))).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = jax.tree.map(np.asarray, bn.init(jax.random.PRNGKey(0), x))
    v["batch_stats"]["var"] = np.zeros(4, np.float32)
    y32, upd32 = bn.apply(v, x, mutable=["batch_stats"])
    with jax.enable_x64(True):
        y64, upd64 = bn.apply(jax.tree.map(np.float64, v),
                              x.astype(np.float64), mutable=["batch_stats"])
        y64, var64 = np.asarray(y64), np.asarray(upd64["batch_stats"]["var"])
    port = BatchNorm(4)
    port.running_var.zero_()
    stats = BatchStats()
    with torch.no_grad():
        y = port(torch.from_numpy(x).permute(0, 3, 1, 2), True, stats)
    _close(stats.new[port][1], var64, 1e-3, 0)
    # f32 x - mean: one ulp of 10 over the spread 0.01
    _close(y.permute(0, 2, 3, 1), y64, 0, 2e-3)
    flax_var = np.asarray(upd32["batch_stats"]["var"])
    assert np.max(np.abs(flax_var - var64) / var64) > 0.1
    assert np.max(np.abs(np.asarray(y32) - y64)) > 0.1


def test_import_torch_resnet_reads_the_port():
    """The JAX package's torchvision importer reads the port's
    ``state_dict`` back into the flax trees it came from: the names
    agree both ways."""
    for d in (18, 50):
        _, params, stats = _flax_resnet(d, seed=3)
        sd = {k: v.numpy() for k, v in
              _port_resnet(d, params, stats).state_dict().items()}
        back, mstate = import_torch_resnet(sd, depth=d)
        jtree.assert_close(back, params, rtol=0, atol=0)
        jtree.assert_close(mstate["batch_stats"], stats, rtol=0, atol=0)


def test_space_to_depth_helpers_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    _close(space_to_depth(torch.from_numpy(x)), jspace_to_depth(x), 0, 0)
    _close(space_to_depth(x), jspace_to_depth(x), 0, 0)
    w = rng.standard_normal((7, 7, 3, 5)).astype(np.float32)  # flax HWIO
    got = s2d_stem_kernel(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    _close(got.permute(2, 3, 1, 0), js2d_kernel(w), 0, 0)


def test_resnet50_shape_and_macs():
    """The full-width ResNet-50: 25,557,032 params (torchvision's count)
    and 4.09 G multiply-adds a 224² image forward (4.13 G with the
    space-to-depth stem's 4x4 kernel over 12 channels)."""
    model = resnet50(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert model.forward_macs(224) == 4_089_184_256
    s2d = resnet50(device="cpu", space_to_depth=True)
    assert s2d.forward_macs(224) == 4_089_184_256 + 112 * 112 * 64 * (
        12 * 16 - 3 * 49)


# ---------------------------------------------------- steps and eval


def _jax_steps(jm, params, stats, batches, mesh, accum=1):
    opt = joptim.momentum(LR, 0.9)
    step = jmake_step(flax_loss_fn(jm, jlce), opt, mesh, donate=False,
                      accum_steps=accum)
    st = JState.create(jsharding.replicate(params, mesh), opt,
                       model_state=jsharding.replicate(
                           {"batch_stats": stats}, mesh))
    losses = []
    for x, y in batches:
        st, m = step(st, jsharding.shard_batch({"image": x, "label": y},
                                               mesh))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, (st.params,
                                             st.model_state["batch_stats"]))


@pytest.fixture(scope="module")
def resnet18_run():
    """Flax resnet18 (width 8) weights and 3 global batches of 6 images
    of 64²: the last stage is 2x2, so a microbatch or rank of 2 rows
    still normalises over 8 values a channel (at 1x1 over 2 values,
    the normalised output is ±1 whatever the input, and its gradient is
    rounding)."""
    jm, params, stats = _flax_resnet(18, seed=20)
    return jm, params, stats, [_images(30 + i, 6, size=64)
                               for i in range(3)]


@pytest.mark.parametrize("accum", [1, 3])
def test_dp_steps_match_jax(resnet18_run, accum):
    """Three one-device momentum steps (``accum_steps`` microbatches,
    the running stats threaded through them) against the JAX step on
    ``data_mesh(1)``."""
    jm, params, stats, batches = resnet18_run
    jlosses, (jp, js) = _jax_steps(jm, params, stats, batches, jdata_mesh(1),
                                   accum)
    model = _port_resnet(18, params, stats)
    opt = optim.momentum(LR, 0.9)
    st = TrainState.create(dict(model.named_parameters()), opt,
                           model_state={k: b.clone() for k, b in
                                        model.named_buffers()})
    step = make_train_step(module_loss_fn(model, logitcrossentropy), opt,
                           accum_steps=accum)
    losses = []
    for x, y in batches:
        st, m = step(st, _torch_batch(x, y))
        losses.append(m["loss"].item())
    _close(losses, jlosses, 1e-4, 1e-5)
    ref = _port_names(18, jp, js)
    for k, v in {**st.params, **st.model_state}.items():
        _close_leaf(v, ref[k])


def test_eval_step_topk_matches_jax(resnet18_run):
    jm, params, stats, batches = resnet18_run
    x, y = batches[0]
    jloss, jm_ = jmake_eval(flax_loss_fn(jm, jlce), jdata_mesh(1),
                            topk=(1, 5))(
        JState.create(params, joptim.momentum(LR),
                      model_state={"batch_stats": stats}),
        {"image": x, "label": y})
    model = _port_resnet(18, params, stats)
    st = TrainState.create(dict(model.named_parameters()), optim.momentum(LR),
                           model_state=dict(model.named_buffers()))
    loss, m = make_eval_step(module_loss_fn(model, logitcrossentropy),
                             topk=(1, 5))(st, _torch_batch(x, y))
    _close(loss.item(), jloss, 1e-4, 1e-5)
    assert set(m) == {"top1", "top5"}
    for k in (1, 5):
        assert m[f"top{k}"].item() == float(jm_[f"top{k}"])


# ------------------------------------------------------------- ranks


@pytest.fixture(scope="module")
def rank_runs(resnet18_run):
    """The 2- and 3-rank port runs and the JAX references on
    ``data_mesh(2)`` / ``data_mesh(3)`` (two global batches of 6)."""
    jm, params, stats, batches = resnet18_run
    batches = batches[:2]
    sd = _port_names(18, params, stats)
    cnn = JSimpleCNN(num_classes=NCLS)
    x, y = _images(40, 8, size=8)
    cnn_params = cnn.init(jax.random.PRNGKey(2), x)["params"]
    cnn_sd = {k: v.detach().numpy() for k, v in load_flax_simple(
        SimpleCNN(num_classes=NCLS, device="cpu"),
        jax.tree.map(np.asarray, cnn_params)).state_dict().items()}
    mx = (10.0 + 0.01 * np.random.default_rng(41).standard_normal(
        (6, 4, 3, 3))).astype(np.float32)
    # both worlds start together and run while JAX compiles its steps
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(run_ranks, ranks.two_ranks, 2, sd, batches, LR,
                          cnn_sd, x, y, mx)
        three = pool.submit(run_ranks, ranks.resnet_steps, 3, sd, batches,
                            LR, ("sync",))
        ref = {n: _jax_steps(jm, params, stats, batches, jdata_mesh(n))
               for n in (2, 3)}
        return two.result(), three.result(), ref, mx


def _assert_matches_jax(run, jref):
    jlosses, (jp, js) = jref
    _close(run["losses"], jlosses, 1e-4, 1e-5)
    ref = _port_names(18, jp, js)
    for k, v in {**run["params"], **run["stats"]}.items():
        _close_leaf(v, ref[k])


def _assert_replicas_equal(runs, keys=("params", "stats")):
    for r in runs[1:]:
        for part in keys:
            for k, v in r[part].items():
                np.testing.assert_array_equal(v, runs[0][part][k])


@pytest.mark.parametrize("n", [2, 3])
def test_sync_batchnorm_ranks_match_jax_global_batch(rank_runs, n):
    """N gloo ranks with BatchNorm over the global batch equal the JAX
    step on ``data_mesh(N)``; the replicas are bit-equal, and each keeps
    the running stats its BatchNorm computed (no mean over 3 ranks,
    which would round them)."""
    two, three, ref, _ = rank_runs
    runs = ([r["steps"] for r in two] if n == 2 else three)
    for r in runs:
        _assert_matches_jax(r["sync"], ref[n])
        assert r["sync_stats_exact"]
    _assert_replicas_equal([r["sync"] for r in runs])


def test_per_rank_batchnorm_differs_from_jax(rank_runs):
    """The control: BatchNorm over each rank's own rows is a different
    step, and fails the comparison the synchronised one passes."""
    two, _, ref, _ = rank_runs
    with pytest.raises(AssertionError):
        _assert_matches_jax(two[0]["steps"]["local"], ref[2])
    _assert_replicas_equal([r["steps"]["local"] for r in two])


def test_zero1_equals_dp_on_resnet(rank_runs):
    """Composable ZeRO-1 at 2 ranks equals the DP step bit for bit (a
    sum of two is exact in either order)."""
    two, _, _, _ = rank_runs
    for r in two:
        s = r["steps"]
        assert s["zero1"]["losses"] == s["sync"]["losses"]
        for part in ("params", "stats"):
            for k, v in s["zero1"][part].items():
                np.testing.assert_array_equal(v, s["sync"][part][k])


def test_zero1_unflatten_keeps_channels_last():
    """ZeRO-1 hands back each updated leaf in its param's layout, so a
    channels-last conv weight stays channels-last (the GPU's) and the
    next step's convolutions run as the DP step's do."""
    from fluxdistributed_tpu_torch.parallel import zero1, zero1_fused

    w = torch.randn(4, 3, 2, 2).contiguous(memory_format=torch.channels_last)
    tmpl = {"w": w, "b": torch.randn(5)}
    flat = zero1._flatten_tree(tmpl, 3)
    back = zero1._unflatten_like(flat, tmpl)
    packed = zero1_fused.unpack_tree(zero1_fused.pack_tree(tmpl, 2), tmpl)
    for out in (back, packed):
        assert out["w"].is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(out["w"], w) and torch.equal(out["b"], tmpl["b"])


def test_dp_invariants_on_simplecnn(rank_runs):
    """The reference's invariants (``tests/test_dp_invariants.py``) at 2
    ranks: rank-mean gradient = global-batch gradient; DP step = batched
    step, with equal replicas."""
    two, _, _, _ = rank_runs
    for r in two:
        inv = r["invariants"]
        for k in inv["g_global"]:
            _close(inv["g_mean"][k], inv["g_global"][k], 1e-4, 1e-5)
            _close(inv["dp"][k], inv["one"][k], 1e-4, 1e-5)
    _assert_replicas_equal([r["invariants"] for r in two], ("dp",))


def test_sync_moments_are_exact_global_statistics(rank_runs):
    """The all-reduced BatchNorm statistics equal the global batch's in
    float64, where the mean is large against the spread (C7)."""
    two, _, _, mx = rank_runs
    x64 = mx.astype(np.float64)
    for r in two:
        mean, var = r["moments"]
        _close(mean, x64.mean(axis=(0, 2, 3)), 1e-6, 0)
        _close(var, x64.var(axis=(0, 2, 3)), 1e-3, 0)


# ------------------------------------------------ data, trainer, CLI


def test_synthetic_images_match_jax():
    ds, jds = SyntheticDataset(64, 7, (6, 6, 3), seed=3), JSynth(
        64, 7, (6, 6, 3), seed=3)
    for idx in (None, np.arange(5)):
        a = ds.batch(np.random.default_rng(1), 5, indices=idx)
        b = jds.batch(np.random.default_rng(1), 5, indices=idx)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert len(ds) == 64 and ds.nclasses == 7


def test_cifar_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        (tmp_path / name).write_bytes(
            rng.integers(0, 256, (4, 3073), dtype=np.uint8).tobytes())
    for split in ("train", "test"):
        ds, jds = CIFAR10Dataset(str(tmp_path), split), JCIFAR(
            str(tmp_path), split)
        assert len(ds) == len(jds) == (20 if split == "train" else 4)
        idx = np.arange(len(ds))
        for u, v in zip(ds.batch(None, 0, indices=idx),
                        jds.batch(None, 0, indices=idx)):
            np.testing.assert_array_equal(u, v)
    with pytest.raises(FileNotFoundError):
        CIFAR10Dataset(str(tmp_path / "missing"))


def test_trainer_val_slice_topk_and_evaluate():
    """The image trainer: the default adapter, the val slice and top-k
    in the eval log, ``transform`` on every draw (space-to-depth for an
    s2d model), and ``evaluate`` against the model's own forward."""
    ds = SyntheticDataset(24, NCLS, (16, 16, 3), seed=1)
    model = resnet18(num_classes=NCLS, width=8, dtype=torch.float32,
                     space_to_depth=True, device="cpu")

    def s2d(imgs, labels):
        return space_to_depth(imgs), labels

    task = prepare_training(model, ds, optim.momentum(0.05), batch_size=8,
                            cycles=3, device="cpu", val_dataset=ds,
                            val_samples=10, transform=s2d)
    assert task.topk == (1, 5, 10)
    assert task.val_batch["image"].shape == (10, 8, 8, 12)
    logs = []

    class Capture(NullLogger):
        def log(self, metrics, step):
            logs.append(dict(metrics))

    train(task, print_every=0, eval_every=2, logger=Capture())
    keys = set().union(*logs)
    assert {"val_loss", "val_top1", "val_top5", "train_top10"} <= keys
    assert not torch.equal(model.bn1.running_var, torch.ones(8))
    out = evaluate(task, ds, batch_size=8, topk=(1, 5))
    assert out["exact"] and out["samples"] == 24
    rng = np.random.default_rng(0)  # evaluate's draws: blocks of 8
    draws = [ds.batch(rng, 8, indices=np.arange(i, i + 8))
             for i in (0, 8, 16)]
    imgs = np.concatenate([d[0] for d in draws])
    labels = np.concatenate([d[1] for d in draws])
    with torch.no_grad():
        logits = model(torch.from_numpy(space_to_depth(imgs)))
    want = logitcrossentropy(logits, torch.from_numpy(labels)).item()
    assert out["loss"] == pytest.approx(want, rel=1e-5)
    assert out["top1"] == pytest.approx(topkaccuracy(
        logits, torch.from_numpy(labels), 1).item(), abs=1e-6)
    with pytest.raises(KeyError, match="top-3"):
        evaluate(task, ds, batch_size=8, topk=(3,))


def test_cli_trains_resnet18_on_the_cpu(capsys):
    task = cli.run(["--model", "resnet18", "--dataset", "synthetic",
                    "--image-size", "32", "--num-classes", "10",
                    "--batch-size", "8", "--cycles", "12", "--lr", "0.01",
                    "--print-every", "6", "--eval-every", "6",
                    "--device", "cpu"])
    losses = task.losses
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < losses[0] - 0.5
    out = capsys.readouterr().out
    assert "train_top5=" in out and "images_per_sec=" in out
    assert "resnet18 (11.2M params, bfloat16), 10 classes" in out


def test_cli_refuses_the_other_kind_of_data(tmp_path):
    base = ["--cycles", "1", "--device", "cpu"]
    for argv, match in [
            (["--model", "lm_tiny", "--dataset", "synthetic"], "tokens"),
            (["--model", "lm_tiny", "--dataset", "cifar:x"], "tokens"),
            (["--model", "resnet18", "--dataset", "synthetic-text"],
             "token stream"),
            (["--model", "SimpleCNN", "--dataset", "text:x"], "token stream"),
            (["--model", "resnet18", "--dataset", "imagenet"], "registered")]:
        with pytest.raises(SystemExit, match=match):
            cli.run(argv + base)
    args = cli.build_parser().parse_args(["--opt", "lars"])
    assert args.model == "resnet50" and args.dataset is None
    assert args.opt == "lars" and args.image_size == 224
