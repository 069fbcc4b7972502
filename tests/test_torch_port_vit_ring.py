"""Port parity: the sequence-sharded ViT (``models/vit.py`` with a
sequence-parallel ``attn_fn`` from ``parallel/context.py``) against the
JAX ViT with ``make_ring_attention`` (``tests/test_context_parallel.py``'s
``test_vit_with_ring_attention``).

``vit_tiny`` in float32 on 4 gloo ranks (one spawn, bodies in
``test_torch_port_vit_ring_ranks.py``), as ``{data: 2, seq: 2}`` and
``{seq: 4}``, with the ring (``impl="xla"``, and ``"flash"``: the
kernels' plain versions on the CPU) and Ulysses: each rank's logits
(its rows) within 2e-5 of the JAX ring ViT under ``shard_map`` on the
same mesh of virtual CPU devices (the JAX test's own tolerance; the
flash ring is held to JAX's ``impl="xla"`` ring, the same sums, since
JAX's flash ring interprets its Pallas kernels on the CPU), and
the gradient of ``sum(logits ** 2)`` over the batch within rtol 1e-4 /
atol 1e-5 of ``jax.grad`` of the same (f32 sums taken in other
orders).  The class-token readout at 28² (50 tokens over 2 seq ranks),
and the refusal of a token count that does not divide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_vit_ring_ranks as ranks
from torch_port_spawn import Spawned
from fluxdistributed_tpu.mesh import make_mesh as jmake_mesh
from fluxdistributed_tpu.models import vit_tiny as jvit_tiny
from fluxdistributed_tpu.parallel.context import (
    make_ring_attention as jring, make_ulysses_attention as julysses)
from fluxdistributed_tpu_torch import models
from fluxdistributed_tpu_torch.mesh import Mesh
from fluxdistributed_tpu_torch.models.from_jax import flax_vit_to_state_dict
from fluxdistributed_tpu_torch.parallel import make_ring_attention

N = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 32, 32, 3)))
    xc = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (4, 28, 28, 3)))
    params = jvit_tiny(num_classes=10, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), x, train=False)["params"]
    cls = jvit_tiny(num_classes=10, dtype=jnp.float32, use_class_token=True)
    cparams = cls.init(jax.random.PRNGKey(3), xc, train=False)["params"]
    # a nonzero class token, so its readout is not a zero row
    cparams = dict(cparams)
    cparams["cls_token"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(4), cparams["cls_token"].shape)
    spawn = Spawned(ranks.vit_ring, N, _np(params), x, _np(cparams), xc)
    return params, x, cparams, xc, spawn


@pytest.fixture(scope="module")
def jax_ref(setup):
    """Per mesh and core: the JAX ring ViT's logits and gradient."""
    params, x, cparams, xc, _ = setup
    out = {}
    for name, axes in ranks.MESHES.items():
        mesh = jmake_mesh(axes, jax.devices()[:N])
        batch = "data" if "data" in axes else None
        for core in ("xla", "ulysses"):
            attn = (julysses(mesh, batch_axis=batch) if core == "ulysses"
                    else jring(mesh, batch_axis=batch))
            m = jvit_tiny(num_classes=10, dtype=jnp.float32, attn_fn=attn)

            def loss(p):
                y = m.apply({"params": p}, x, train=False)
                return (y ** 2).sum(), y

            (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                params)
            out[(name, core)] = (np.asarray(y),
                                 flax_vit_to_state_dict(_np(g)))
        # the port's flash ring is held to the JAX ring's blockwise walk:
        # JAX's own flash ring runs its Pallas kernels interpreted here
        out[(name, "flash")] = out[(name, "xla")]
    mesh = jmake_mesh(ranks.MESHES["data_seq"], jax.devices()[:N])
    m = jvit_tiny(num_classes=10, dtype=jnp.float32, use_class_token=True,
                  attn_fn=jring(mesh, batch_axis="data"))
    ref = jvit_tiny(num_classes=10, dtype=jnp.float32, use_class_token=True)
    out["class_token"] = np.asarray(m.apply({"params": cparams}, xc,
                                            train=False))
    out["class_token_dense"] = np.asarray(ref.apply({"params": cparams}, xc,
                                                    train=False))
    return out


@pytest.fixture(scope="module")
def four(setup):
    return setup[-1].result()


@pytest.mark.parametrize("core", ranks.CORES)
@pytest.mark.parametrize("mesh", list(ranks.MESHES))
def test_forward_matches_jax_ring_vit(four, jax_ref, mesh, core):
    ref = jax_ref[(mesh, core)][0]
    n = ranks.MESHES[mesh].get("data", 1)
    b = ref.shape[0] // n
    for r, out in enumerate(four):
        d = _coord(r, mesh).get("data", 0)
        rows = slice(d * b, (d + 1) * b)
        np.testing.assert_allclose(out[(mesh, core)][0], ref[rows],
                                   rtol=2e-5, atol=2e-5, err_msg=f"rank {r}")


@pytest.mark.parametrize("core", ranks.CORES)
@pytest.mark.parametrize("mesh", list(ranks.MESHES))
def test_gradient_matches_jax(four, jax_ref, mesh, core):
    ref = jax_ref[(mesh, core)][1]
    for r, out in enumerate(four):
        got = out[(mesh, core)][1]
        assert set(got) == set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {k}")


def _coord(r: int, mesh: str) -> dict:
    """Rank ``r``'s coordinates on the mesh (row major, the last axis
    fastest: JAX device ``r``'s)."""
    axes = ranks.MESHES[mesh]
    if "data" in axes:
        return {"data": r // axes["seq"], "seq": r % axes["seq"]}
    return {"seq": r}


def test_class_token_readout(four, jax_ref):
    ref = jax_ref["class_token"]
    np.testing.assert_allclose(ref, jax_ref["class_token_dense"], rtol=2e-5,
                               atol=2e-5)
    for r, out in enumerate(four):
        assert out["coord"] == _coord(r, "data_seq")
        d = out["coord"]["data"]
        np.testing.assert_allclose(out["class_token"], ref[2 * d:2 * d + 2],
                                   rtol=2e-5, atol=2e-5, err_msg=f"rank {r}")


def test_tokens_that_do_not_divide_raise():
    """65 tokens (64 patches and the class token) over 2 seq ranks: the
    error names both, before any exchange (a hand-built mesh with no
    group)."""
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"),
                axis="seq", axes=(("seq", 2),), coords=(0,))
    m = models.vit_tiny(num_classes=10, dtype=torch.float32,
                        use_class_token=True, image_size=32, device="cpu",
                        attn_fn=make_ring_attention(mesh))
    with pytest.raises(ValueError, match="65 tokens do not split over the 2"):
        m(torch.zeros(2, 32, 32, 3))
