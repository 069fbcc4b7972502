"""Port parity: the ViT and ConvNeXt families (``models/vit.py``,
``models/convnext.py``, their flax loaders, the loss adapter's dropout
seed, the DP step, the device loop and the CLI) against the JAX package,
on the same numpy inputs and the same flax weights (``load_flax_vit`` /
``load_flax_convnext``).  Narrow configs: ``vit_tiny`` (patch 4, 2
blocks of width 64, 4 heads) and ``convnext_test`` (widths 16-128) on
32² images.  The N-rank world is two gloo ranks on the CPU
(``mesh.run_ranks``, bodies in ``test_torch_port_vit_ranks.py``)
against the JAX step on ``data_mesh(2)``.

The flax weights are random: kernels normal over their fan-in,
LayerNorm scales and biases, biases, the position table and the class
token off their init values, and ConvNeXt's layer scale at ~0.5 (its
1e-6 init would cut every block off).

Tolerances:

* float64 (both models in float64, flax under ``jax.enable_x64``):
  logits and every parameter gradient within 1e-9 relative to the
  tensor's largest entry.  Two pieces of the JAX models do not run in
  float64 whatever the dtype, so the comparison puts them in float64 on
  both sides: the dense attention core contracts with
  ``preferred_element_type=float32`` (both models get the same float64
  softmax attention as ``attn_fn``), and the heads (ViT's ``head``,
  ConvNeXt's ``head_norm`` and ``head``) are ``dtype=float32`` modules,
  which ``flax.linen.intercept_methods`` re-runs as float64 clones of
  themselves on the same params (the logits are read there, before the
  models' closing cast to float32).
* float32 with each package's own dense attention: logits rtol 1e-5 /
  atol 1e-5 of the largest logit; gradients rtol 1e-4 and atol 1e-5 of
  each leaf's largest entry (f32 sums in other orders; LayerNorm's
  ``E[x²] - E[x]²`` in both).
* the port's flash core (its plain versions on the CPU) against the
  JAX ViT wired with the Pallas kernel in interpret mode
  (``block_q = block_k = 16``): logits 1e-5, as
  ``tests/test_pallas_attention.py::test_flash_in_vit`` holds the JAX
  pair; gradients as the float32 case.
* train steps: losses rtol 1e-5; lars params element-wise rtol 1e-4 /
  atol 1e-5 of the leaf's scale; adamw params within 3 lr absolute
  (Adam's first steps move an entry by ~lr sign(g), and a gradient
  near 0 can take the other sign in another summation order).
"""

import functools
import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_vit_ranks as ranks
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu import tree as jtree
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.models import convnext_test as jconvnext_test
from fluxdistributed_tpu.models import import_torch_convnext, import_torch_vit
from fluxdistributed_tpu.models import vit_tiny as jvit_tiny
from fluxdistributed_tpu.ops import logitcrossentropy as jlce
from fluxdistributed_tpu.ops.pallas_attention import flash_attention as jflash
from fluxdistributed_tpu.parallel.dp import TrainState as JState
from fluxdistributed_tpu.parallel.dp import flax_loss_fn
from fluxdistributed_tpu.parallel.dp import make_train_step as jmake_step
from fluxdistributed_tpu_torch import models, optim
from fluxdistributed_tpu_torch.mesh import run_ranks
from fluxdistributed_tpu_torch.models import (ConvNeXt, LayerNorm, ViT,
                                              convnext_test, convnext_tiny,
                                              convnext_xlarge,
                                              load_flax_convnext,
                                              load_flax_vit, vit_b16,
                                              vit_h14, vit_l16, vit_tiny)
from fluxdistributed_tpu_torch.models import from_jax
from fluxdistributed_tpu_torch.models.common import gelu
from fluxdistributed_tpu_torch.ops import flash_attention
from fluxdistributed_tpu_torch.ops.losses import logitcrossentropy
from fluxdistributed_tpu_torch.parallel import (TrainState, make_train_step,
                                                module_loss_fn)

cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")

SIZE, NCLS, BATCH = 32, 10, 4
LR = 1e-3
JFACTORY = {"vit": jvit_tiny, "convnext": jconvnext_test}
#: the flax param trees that run in float32 whatever the model's dtype
F32_HEADS = {"vit": ("head",), "convnext": ("head_norm", "head")}


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _close_scaled(got, want, rtol, scale_tol):
    """``rtol`` element-wise and ``scale_tol`` of the largest entry."""
    want = np.asarray(want, np.float64)
    _close(got, want, rtol, scale_tol * max(float(np.abs(want).max()), 1e-30))


def _weights(shapes, seed):
    """Random flax weights for the tree of ``shapes`` (see the module
    docstring)."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        shape, key = leaf.shape, jax.tree_util.keystr(path)
        if "'kernel'" in key:
            fan = shape[0] if "'qkv'" in key else int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan)).astype(
                np.float32)
        if "'scale'" in key:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if "'layer_scale'" in key:
            return (0.5 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, shapes)


def _images(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)
    y = np.eye(NCLS, dtype=np.float32)[rng.integers(0, NCLS, n)]
    return x, y


def _flax(kind, seed=0, **kw):
    """A flax model (f32 unless ``kw`` says otherwise) and random weights
    for it (shapes from ``eval_shape``: nothing is compiled)."""
    jm = JFACTORY[kind](num_classes=NCLS, **{"dtype": jnp.float32, **kw})
    x0 = np.zeros((1, SIZE, SIZE, 3), np.float32)
    v = jax.eval_shape(lambda k, x: jm.init(k, x, train=False),
                       jax.random.PRNGKey(0), x0)
    return jm, _weights(v["params"], seed + 1)


def _port(kind, params, dtype=torch.float32, **kw):
    """The port's model of ``kind`` filled with the flax ``params``."""
    if kind == "vit":
        m = vit_tiny(num_classes=NCLS, image_size=SIZE, dtype=dtype,
                     device="cpu", **kw)
        return load_flax_vit(m, jax.tree.map(np.asarray, params))
    m = convnext_test(num_classes=NCLS, dtype=dtype, device="cpu", **kw)
    return load_flax_convnext(m, jax.tree.map(np.asarray, params))


def _port_names(kind, tree):
    """A flax tree (params or their gradients) under the port's names,
    in the tree's own dtype."""
    sd = {}
    fill = from_jax._fill
    from_jax._fill = lambda model, d: sd.update(d) or model
    try:
        loader = load_flax_vit if kind == "vit" else load_flax_convnext
        model = (vit_tiny(num_classes=NCLS, image_size=SIZE, device="cpu")
                 if kind == "vit" else
                 convnext_test(num_classes=NCLS, device="cpu"))
        loader(model, jax.tree.map(np.asarray, tree))
    finally:
        from_jax._fill = fill
    return sd


def _torch_batch(x, y):
    return {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}


# a float64 softmax attention for both packages (see the module docstring)
def _jattn64(q, k, v):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


def _tattn64(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _flax_logits(jm, kind, params, x, dtype):
    """``jm``'s logits, its float32 head modules (``F32_HEADS``) re-run
    in ``dtype`` and the logits read from the head before the model's
    closing cast."""
    out, busy = {}, []

    def icpt(next_fun, args, kwargs, ctx):
        if busy or ctx.module.name not in F32_HEADS[kind] or \
                ctx.method_name != "__call__":
            return next_fun(*args, **kwargs)
        clone = ctx.module.clone(parent=None, dtype=dtype)
        busy.append(1)
        try:
            y = clone.apply({"params": ctx.module.variables["params"]},
                            *args, **kwargs)
        finally:
            busy.pop()
        out[ctx.module.name] = y
        return y

    with fnn.intercept_methods(icpt):
        jm.apply({"params": params}, x, train=False)
    return out["head"]


@functools.lru_cache(maxsize=None)
def _reference64(kind, cls, exact):
    """flax in float64: logits and the gradient of ``sum(logits * w)``."""
    extra = {"use_class_token": cls} if kind == "vit" else {}
    _, params = _flax(kind, seed=10 * cls + exact, gelu_exact=exact, **extra)
    x, _ = _images(3)
    w = np.random.default_rng(4).standard_normal((BATCH, NCLS))
    with jax.enable_x64(True):
        if kind == "vit":
            extra["attn_fn"] = _jattn64
        jm = JFACTORY[kind](num_classes=NCLS, dtype=jnp.float64,
                            gelu_exact=exact, **extra)
        p64 = jax.tree.map(np.float64, params)

        def fn(p, x):
            return _flax_logits(jm, kind, p, x, jnp.float64)

        logits, vjp = jax.vjp(jax.jit(fn), p64, x.astype(np.float64))
        grads = vjp(w)[0]
        logits, grads = jax.tree.map(np.asarray, (logits, grads))
    return params, x, w, logits, grads


CASES64 = [("vit", cls, exact) for cls in (False, True)
           for exact in (False, True)] + [("convnext", False, e)
                                          for e in (False, True)]


@pytest.mark.parametrize("kind,cls,exact", CASES64,
                         ids=[f"{k}-{'cls' if c else 'mean'}-"
                              f"{'erf' if e else 'tanh'}"
                              for k, c, e in CASES64])
def test_matches_flax_float64(kind, cls, exact):
    """Logits and every parameter gradient, both models in float64."""
    params, x, w, jlogits, jgrads = _reference64(kind, cls, exact)
    kw = {"gelu_exact": exact}
    if kind == "vit":
        kw.update(use_class_token=cls, attn_fn=_tattn64)
    model = _port(kind, params, dtype=torch.float64, **kw).double()
    logits = model(torch.from_numpy(x).double())
    assert logits.dtype == torch.float64
    _close_scaled(logits.detach(), jlogits, 1e-9, 1e-9)
    (logits * torch.from_numpy(w)).sum().backward()
    ref = _port_names(kind, jgrads)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(ref)
    for k, g in grads.items():
        _close_scaled(g, ref[k], 1e-9, 1e-9)


def _flax_loss_grads(jm, params, x, y):
    """The JAX loss adapter's train-mode loss, logits and gradients."""
    return jax.jit(jax.value_and_grad(
        lambda p: flax_loss_fn(jm, jlce)(p, {}, {"image": x, "label": y},
                                         True), has_aux=True))(params)


CASES32 = [("vit", False), ("vit", True), ("convnext", False)]


@pytest.mark.parametrize("kind,cls", CASES32,
                         ids=["vit-mean", "vit-cls", "convnext"])
def test_matches_flax_float32(kind, cls):
    """float32, each package's own dense attention and f32 heads:
    eval logits, and the train-mode loss and gradients through the loss
    adapters (dropout 0)."""
    extra = {"use_class_token": cls} if kind == "vit" else {}
    jm, params = _flax(kind, seed=5, **extra)
    x, y = _images(6)
    (jloss, (_, jlogits)), jgrads = _flax_loss_grads(jm, params, x, y)
    model = _port(kind, params, **extra)
    P = {k: p.detach().requires_grad_(True)
         for k, p in model.named_parameters()}
    loss, (_, logits) = module_loss_fn(model, logitcrossentropy)(
        P, {}, _torch_batch(x, y), True, rng=7)
    _close_scaled(logits.detach(), jlogits, 1e-5, 1e-5)
    _close(loss.item(), jloss, 1e-5, 0)
    grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
    ref = _port_names(kind, jgrads)
    for k, g in grads.items():
        _close_scaled(g, ref[k], 1e-4, 1e-5)


def test_vit_flash_core_matches_jax_pallas():
    """The port's ViT with ``partial(flash_attention, causal=False)``
    (its plain versions on the CPU) against the JAX ViT wired with the
    Pallas kernel in interpret mode: logits and gradients."""
    jm, params = _flax("vit", seed=8,
                       attn_fn=functools.partial(jflash, block_q=16,
                                                 block_k=16))
    x, y = _images(9)
    (jloss, (_, jlogits)), jgrads = _flax_loss_grads(jm, params, x, y)
    model = _port("vit", params, attn_fn=functools.partial(
        flash_attention, causal=False, block_q=16, block_k=16))
    P = {k: p.detach().requires_grad_(True)
         for k, p in model.named_parameters()}
    loss, (_, logits) = module_loss_fn(model, logitcrossentropy)(
        P, {}, _torch_batch(x, y), True)
    _close(logits.detach(), jlogits, 1e-5, 1e-5)
    _close(loss.item(), jloss, 1e-5, 0)
    grads = dict(zip(P, torch.autograd.grad(loss, list(P.values()))))
    ref = _port_names("vit", jgrads)
    for k, g in grads.items():
        _close_scaled(g, ref[k], 1e-4, 1e-5)


def test_vit_flash_core_equals_dense_core():
    """In the port, the flash core (plain versions) and the dense core
    give the same ViT at T = 65 (class token: a ragged last block)."""
    x, _ = _images(11)
    dense = vit_tiny(num_classes=NCLS, image_size=SIZE, dtype=torch.float32,
                     use_class_token=True, device="cpu", seed=3)
    flash = vit_tiny(num_classes=NCLS, image_size=SIZE, dtype=torch.float32,
                     use_class_token=True, device="cpu", seed=3,
                     attn_fn=functools.partial(flash_attention, causal=False,
                                               block_q=16, block_k=16))
    assert dense.tokens(SIZE) == 65
    with torch.no_grad():
        _close(flash(torch.from_numpy(x)), dense(torch.from_numpy(x)),
               1e-5, 1e-5)


# ------------------------------------------------------------ names


def test_import_torch_vit_reads_the_port():
    """The JAX package's torchvision importer reads the port's
    ``state_dict`` (class-token form: it reads ``class_token``) back
    into the flax tree it came from."""
    _, params = _flax("vit", seed=12, use_class_token=True)
    sd = {k: v.numpy() for k, v in
          _port("vit", params, use_class_token=True).state_dict().items()}
    back, mstate = import_torch_vit(sd, num_heads=4)
    assert mstate == {}
    jtree.assert_close(back, params, rtol=0, atol=0)


def test_import_torch_convnext_reads_the_port():
    _, params = _flax("convnext", seed=13)
    sd = {k: v.numpy() for k, v in
          _port("convnext", params).state_dict().items()}
    back, mstate = import_torch_convnext(sd)
    assert mstate == {}
    jtree.assert_close(back, params, rtol=0, atol=0)


def test_flax_loaders_refuse_a_tree_that_does_not_fit():
    _, params = _flax("vit", seed=14)
    with pytest.raises(KeyError, match="class_token"):
        _port("vit", params, use_class_token=True)
    _, cparams = _flax("convnext", seed=14)
    extra = dict(cparams, extra={"kernel": np.zeros(1, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        _port("convnext", extra)


def test_torchvision_names():
    """The parameter names the JAX importers read."""
    names = set(dict(vit_tiny(image_size=SIZE, use_class_token=True,
                              device="cpu").named_parameters()))
    layer = "encoder.layers.encoder_layer_1"
    for n in ("conv_proj.weight", "conv_proj.bias", "class_token",
              "encoder.pos_embedding", "encoder.ln.weight",
              "heads.head.weight", f"{layer}.ln_1.bias",
              f"{layer}.self_attention.in_proj_weight",
              f"{layer}.self_attention.in_proj_bias",
              f"{layer}.self_attention.out_proj.weight",
              f"{layer}.ln_2.weight", f"{layer}.mlp.0.weight",
              f"{layer}.mlp.3.bias"):
        assert n in names, n
    cn = set(dict(convnext_test(device="cpu").named_parameters()))
    for n in ("downsample_layers.0.0.weight", "downsample_layers.0.1.bias",
              "downsample_layers.3.0.weight", "downsample_layers.3.1.bias",
              "stages.2.1.dwconv.weight", "stages.2.1.norm.weight",
              "stages.2.1.pwconv1.weight", "stages.2.1.pwconv2.bias",
              "stages.2.1.gamma", "norm.weight", "head.bias"):
        assert n in cn, n


# ------------------------------------------------------------ pieces


def test_layernorm_is_flax_layernorm():
    """bf16 in, bf16 out, the f32 statistics and eps 1e-6 of flax's
    ``LayerNorm(dtype=bfloat16)``, and its ``E[x²] - E[x]²`` variance
    (which cancels at a mean far above the spread, ROADMAP C7)."""
    rng = np.random.default_rng(15)
    x = (3.0 + rng.standard_normal((5, 7, 32))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ln = fnn.LayerNorm(dtype=jnp.bfloat16)
    want = ln.apply({"params": {"scale": scale, "bias": bias}}, xb)
    port = LayerNorm(32)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        got = port(torch.tensor(np.asarray(xb.astype(jnp.float32))).to(
            torch.bfloat16))
    assert got.dtype == torch.bfloat16 and port.eps == 1e-6
    # one bf16 rounding of the same f32 value, or its neighbour
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 8e-3, 0)
    # float64 in, float64 statistics: flax's formula at a mean far above
    # the spread
    hi = 1e3 + 0.01 * rng.standard_normal((3, 64))
    with jax.enable_x64(True):
        ln64 = fnn.LayerNorm(dtype=jnp.float64, param_dtype=jnp.float64)
        want64 = np.asarray(ln64.apply(ln64.init(jax.random.PRNGKey(0), hi),
                                       hi))
    with torch.no_grad():
        _close(LayerNorm(64).double()(torch.from_numpy(hi)), want64, 1e-9,
               1e-9)


@pytest.mark.parametrize("exact", [False, True], ids=["tanh", "erf"])
def test_gelu_forms(exact):
    x = np.linspace(-6, 6, 101)
    with jax.enable_x64(True):
        want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=not exact))
    _close(gelu(torch.from_numpy(x), exact), want, 1e-12, 1e-15)


def test_convnext_same_padding_matches_flax_at_odd_sizes():
    """flax's ``SAME`` padding of the 4x4/4 stem and the 2x2/2
    downsampling at a side that is not a multiple of 32."""
    jm, params = _flax("convnext", seed=16)
    x = np.random.default_rng(17).standard_normal(
        (2, 37, 30, 3)).astype(np.float32)
    model = _port("convnext", params)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), jax.jit(
            lambda p, x: jm.apply({"params": p}, x, train=False))(params, x),
            1e-5, 1e-5)


def test_drop_path_rates_rise_linearly():
    m = convnext_test(drop_path_rate=0.4, device="cpu")
    rates = [b.drop_path for b in m.blocks()]
    assert rates == pytest.approx([0.0, 0.1, 0.2, 0.3, 0.4])


def test_drop_path_keeps_or_drops_whole_samples():
    """Training with drop path: a block's residual branch is dropped for
    whole samples, the kept ones scaled by 1 / (1 - rate); the step seed
    picks the samples, and eval mode ignores the rate."""
    from fluxdistributed_tpu_torch.models.convnext import ConvNeXtBlock

    blk = ConvNeXtBlock(16, drop_path=0.5).double()
    with torch.no_grad():
        blk.gamma.fill_(1.0)
    x = torch.randn(64, 4, 4, 16, dtype=torch.float64)
    with torch.no_grad():
        full = blk(x, torch.float64) - x
        got = blk(x, torch.float64, True, 12345) - x
    kept = got.abs().flatten(1).amax(1) > 0
    assert 10 < int(kept.sum()) < 54
    torch.testing.assert_close(got[kept], 2.0 * full[kept])
    assert torch.equal(got[~kept], torch.zeros_like(got[~kept]))
    with torch.no_grad():
        other = blk(x, torch.float64, True, 54321) - x
    assert not torch.equal(other, got)
    with pytest.raises(ValueError, match="seed"):
        blk(x, torch.float64, True, None)


def _stochastic(kind, seed=0, **kw):
    """f32 ``vit_tiny`` with dropout 0.2 or ``convnext_test`` with drop
    path 0.5 (its layer scale raised to 0.5, so a dropped branch shows
    in the loss)."""
    if kind == "vit":
        return vit_tiny(image_size=SIZE, dropout=0.2, device="cpu",
                        dtype=torch.float32, seed=seed, **kw)
    m = convnext_test(drop_path_rate=0.5, device="cpu", dtype=torch.float32,
                      seed=seed, **kw)
    with torch.no_grad():
        for blk in m.blocks():
            blk.gamma.fill_(0.5)
    return m


@pytest.mark.parametrize("kind", ["vit", "convnext"])
def test_dropout_seed_reaches_the_model(kind):
    """``module_loss_fn(..., rng)``: in train mode the seed picks the
    masks (the same seed the same loss, another seed another), in eval
    mode nothing is dropped, and a stochastic model without a seed
    raises."""
    model = _stochastic(kind)
    P = dict(model.named_parameters())
    b = _torch_batch(*_images(18))
    fn = module_loss_fn(model, logitcrossentropy)
    with torch.no_grad():
        l1 = fn(P, {}, b, True, rng=1)[0]
        l1b = fn(P, {}, b, True, rng=torch.tensor(1))[0]
        l2 = fn(P, {}, b, True, rng=2)[0]
        ev = fn(P, {}, b, False, rng=1)[0]
        ev0 = fn(P, {}, b, False)[0]
    assert torch.equal(l1, l1b) and not torch.equal(l1, l2)
    assert torch.equal(ev, ev0) and not torch.equal(ev, l1)
    with pytest.raises(ValueError, match="seed"), torch.no_grad():
        fn(P, {}, b, True)


@pytest.mark.parametrize("kind", ["vit", "convnext"])
def test_remat_equals_no_remat_with_dropout(kind):
    """Remat recomputes each block in the backward with the same masks:
    the loss and gradients equal those without remat, bit for bit (the
    ROADMAP's "remat on equal to remat off with dropout")."""
    out = []
    for remat in (False, True):
        model = _stochastic(kind, seed=4, remat=remat)
        P = {k: p.detach().requires_grad_(True)
             for k, p in model.named_parameters()}
        loss = module_loss_fn(model, logitcrossentropy)(
            P, {}, _torch_batch(*_images(19)), True, rng=5)[0]
        out.append((loss, torch.autograd.grad(loss, list(P.values()))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("kind", ["vit", "convnext"])
def test_steps_per_call_equals_eager_steps(kind):
    """``steps_per_call=2`` on the CPU (a plain loop over the step
    table's rows) equals two K = 1 steps, dropout on."""
    def run(k):
        model = _stochastic(kind, seed=6)
        opt = optim.adamw(LR)
        st = TrainState.create(dict(model.named_parameters()), opt)
        step = make_train_step(module_loss_fn(model, logitcrossentropy), opt,
                               seed=3, steps_per_call=k)
        bs = [_torch_batch(*_images(20 + i)) for i in range(2)]
        if k == 1:
            losses = []
            for b in bs:
                st, m = step(st, b)
                losses.append(m["loss"])
            return torch.stack(losses), st
        st, m = step(st, {n: torch.stack([b[n] for b in bs]) for n in bs[0]})
        return m["loss"], st

    (l1, s1), (l2, s2) = run(1), run(2)
    assert torch.equal(l1, l2) and s1.step == s2.step == 2
    for k, v in s1.params.items():
        assert torch.equal(v, s2.params[k]), k


# ------------------------------------------------------------ steps


def _jax_steps(jm, params, opt, batches, mesh):
    step = jmake_step(flax_loss_fn(jm, jlce), opt, mesh, donate=False)
    st = JState.create(jsharding.replicate(params, mesh), opt)
    losses = []
    for x, y in batches:
        st, m = step(st, jsharding.shard_batch({"image": x, "label": y},
                                               mesh))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, st.params)


@pytest.fixture(scope="module")
def step_setup():
    """Weights of both models and 3 global batches of 4 images."""
    return ({kind: _flax(kind, seed=30 + i)
             for i, kind in enumerate(("vit", "convnext"))},
            [_images(40 + i) for i in range(3)])


OPTS = {"vit": ("adamw", joptim.adamw, optim.adamw),
        "convnext": ("lars", joptim.lars, optim.lars)}


def _assert_steps_match(kind, losses, params, jref):
    jlosses, jp = jref
    _close(losses, jlosses, 1e-5, 0)
    ref = _port_names(kind, jp)
    for k, v in params.items():
        if kind == "vit":  # adamw: see the module docstring
            _close(v, ref[k], 0, 3 * LR)
        else:
            _close_scaled(v, ref[k], 1e-4, 1e-5)


@pytest.mark.parametrize("kind", ["vit", "convnext"])
def test_train_steps_match_jax(step_setup, kind):
    """Three one-device steps (ViT under adamw, ConvNeXt under lars)
    against the JAX step on ``data_mesh(1)``."""
    flax_models, batches = step_setup
    jm, params = flax_models[kind]
    _, jopt, topt = OPTS[kind]
    jref = _jax_steps(jm, params, jopt(LR), batches, jdata_mesh(1))
    model = _port(kind, params)
    opt = topt(LR)
    st = TrainState.create(dict(model.named_parameters()), opt)
    step = make_train_step(module_loss_fn(model, logitcrossentropy), opt)
    losses = []
    for x, y in batches:
        st, m = step(st, _torch_batch(x, y))
        losses.append(m["loss"].item())
    _assert_steps_match(kind, losses, st.params, jref)


@pytest.fixture(scope="module")
def rank_run(step_setup):
    flax_models, batches = step_setup
    sds = {kind: {k: v.detach().numpy() for k, v in
                  _port(kind, params).state_dict().items()}
           for kind, (_, params) in flax_models.items()}
    got = run_ranks(ranks.vit_and_convnext_steps, 2, sds["vit"],
                    sds["convnext"], batches[:2], LR)
    return got, flax_models, batches[:2]


@pytest.mark.parametrize("kind", ["vit", "convnext"])
def test_two_ranks_match_jax_data_mesh(rank_run, kind):
    """Two gloo ranks, each with half of every global batch, against the
    JAX step on ``data_mesh(2)``; the replicas are bit-equal."""
    got, flax_models, batches = rank_run
    jm, params = flax_models[kind]
    _, jopt, _ = OPTS[kind]
    jref = _jax_steps(jm, params, jopt(LR), batches, jdata_mesh(2))
    for r in got:
        _assert_steps_match(kind, r[kind]["losses"], r[kind]["params"], jref)
    for k, v in got[1][kind]["params"].items():
        np.testing.assert_array_equal(v, got[0][kind]["params"][k])


# ------------------------------------------------------- shapes, MACs


def _vit_macs(patch, depth, dim, mlp, size, classes=1000, cls=False):
    """The hand count: patch conv, per block QKV, QKᵀ, PV, out, MLP,
    then the head."""
    p = (size // patch) ** 2
    t = p + cls
    block = 3 * t * dim * dim + 2 * t * t * dim + t * dim * dim \
        + 2 * t * dim * mlp
    return p * dim * 3 * patch * patch + depth * block + dim * classes


@pytest.mark.parametrize("name,cls,want", [
    ("vit_b16", False, 17_471_649_792), ("vit_b16", True, 17_563_828_224),
    ("vit_l16", False, 61_233_405_952), ("vit_l16", True, 61_554_712_576),
    ("vit_h14", False, 166_623_938_560), ("vit_h14", True, 167_295_109_120),
])
def test_vit_forward_macs_pinned(name, cls, want):
    """The class-token counts are torchvision's published GFLOPS for
    ViT-B/16, L/16 and H/14 (17.56, 61.55, 167.29)."""
    cfg = {"vit_b16": (16, 12, 768, 3072), "vit_l16": (16, 24, 1024, 4096),
           "vit_h14": (14, 32, 1280, 5120)}[name]
    assert _vit_macs(*cfg, 224, cls=cls) == want
    with torch.device("meta"):
        model = getattr(models, name)(use_class_token=cls, device="meta")
    assert model.forward_macs(224) == want


@pytest.mark.parametrize("name,want", [
    ("convnext_tiny", 4_455_531_264), ("convnext_xlarge", 60_921_030_656)])
def test_convnext_forward_macs_pinned(name, want):
    """Hand count: stem 56²·C0·48; per block h²·C·(49 + 8C); each
    downsample (h/2)²·C·C_prev·4; the head (4.5 and 60.9 G in the
    ConvNeXt paper's table)."""
    depths, dims = (((3, 3, 9, 3), (96, 192, 384, 768))
                    if name == "convnext_tiny" else
                    ((3, 3, 27, 3), (256, 512, 1024, 2048)))
    h, total = 56, 56 * 56 * dims[0] * 48
    for s, (n, c) in enumerate(zip(depths, dims)):
        if s:
            h //= 2
            total += h * h * c * dims[s - 1] * 4
        total += n * h * h * c * (49 + 8 * c)
    total += dims[-1] * 1000
    assert total == want
    with torch.device("meta"):
        assert getattr(models, name)(device="meta").forward_macs(224) == want


def test_published_widths():
    """Parameter counts of the published configs (torchvision: ViT-B/16
    86,567,656, ViT-L/16 304,326,632, ViT-H/14 632,045,800 with the
    class token; ConvNeXt-T 28,589,128 and -XL 350,196,968 in the
    official release)."""
    def n(factory, **kw):
        with torch.device("meta"):
            m = factory(device="meta", **kw)
        return sum(p.numel() for p in m.parameters())

    assert n(vit_b16, use_class_token=True) == 86_567_656
    assert n(vit_l16, use_class_token=True) == 304_326_632
    assert n(vit_h14, use_class_token=True) == 632_045_800
    assert n(convnext_tiny) == 28_589_128
    assert n(convnext_xlarge) == 350_196_968
    with torch.device("meta"):
        h14, l16 = vit_h14(device="meta"), vit_l16(device="meta")
    assert h14.dim // h14.num_heads == 80  # the kernels' refused head dim
    assert l16.tokens(224) == 196


def test_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    for factory in (vit_tiny, convnext_test):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory()


def test_vit_refuses_another_image_size():
    m = vit_tiny(image_size=SIZE, device="cpu")
    with pytest.raises(ValueError, match="32"):
        m(torch.zeros(1, 64, 64, 3))
    with pytest.raises(ValueError, match="multiple"):
        ViT(patch=16, image_size=100, device="cpu")
    with pytest.raises(ValueError, match="differ"):
        ConvNeXt(depths=(1, 1), dims=(8,), device="cpu")


# ---------------------------------------------------------------- CLI


@pytest.mark.parametrize("model", ["vit_tiny", "convnext_test"])
def test_cli_trains_on_the_cpu(model, capsys):
    task = cli.run(["--model", model, "--image-size", "32", "--num-classes",
                    "10", "--batch-size", "8", "--cycles", "12",
                    "--eval-every", "6", "--opt", "adamw", "--lr", "3e-3",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(task.losses) == 12
    assert np.mean(task.losses[-3:]) < task.losses[0]
    assert "train_top1" in out and "train_top5" in out
    assert isinstance(task.model, ViT if model == "vit_tiny" else ConvNeXt)


@pytest.mark.parametrize("flag", [["--attn", "flash"], ["--window", "8"],
                                  ["--kv-heads", "2"]])
def test_cli_keeps_lm_flags_for_lms(flag):
    """As in ``bin/driver.py``: ``--attn``, ``--window`` and
    ``--kv-heads`` apply only to ``lm_*`` models (the CLI's ViT is
    dense)."""
    with pytest.raises(SystemExit, match="lm_"):
        cli.run(["--model", "vit_tiny", "--image-size", "32", "--cycles",
                 "1", "--device", "cpu", *flag])
