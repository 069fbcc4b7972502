"""Port parity: division by a constant, bit for bit with the JAX package
(ROADMAP Queue C1).

Under ``jit`` XLA turns a division by a compile-time constant into a
product with its f32 reciprocal, which differs from a true division in
about a third of the entries when the constant is not a power of two;
a division by a traced value stays true.  The port follows the same
rule (``optim.div_const``), so its steps match the reference bit for
bit at 3 microbatches and at 3 ranks.

The loss ``sum(w * rows' sum of x) + sum(y)`` has the sum of the rows
of x as its gradient and, at w = 0, the sum of y as its value.  Inputs
are small dyadic numbers, so every sum (over rows, microbatches and
ranks, in any order) is exact, and the division by 3 is the only
rounding: a true division where the reference multiplies by
``float32(1/3)`` fails these tests.  The params start at 0, because XLA
fuses ``w - lr * (g / 3)`` into one FMA with the folded constant
``lr / 3``; from 0 that FMA rounds once, as the port's product does, so
the update shows the division and nothing else.

References: the JAX one-device step with ``accum_steps=3``; the JAX
shard_map DP step (per-device gradients, ``tree.div`` by the shard
count, ``pmean`` of the loss) on ``data_mesh(3)``; the JAX GSPMD DP and
ZeRO-1 steps on the loss divided by the rank count (the mean over the
ranks, a constant there too); and the JAX fused schedule (``jit`` of
that loss's gradient, ``pack_tree``, ``fused_adam_update(impl="xla")``,
``unpack_tree``), since the JAX fused step itself does not sum the
ranks' gradients with this jax (ROADMAP C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_zero1_ranks as ranks
from fluxdistributed_tpu import optim as joptim
from fluxdistributed_tpu import sharding as jsharding
from fluxdistributed_tpu.mesh import data_mesh as jdata_mesh
from fluxdistributed_tpu.parallel import zero1 as jzero1
from fluxdistributed_tpu.parallel import zero1_fused as jzf
from fluxdistributed_tpu.parallel.dp import (TrainState as JState,
                                             make_train_step as jmake_step,
                                             make_train_step_shardmap as
                                             jmake_shardmap)
from fluxdistributed_tpu_torch import optim
from fluxdistributed_tpu_torch.mesh import run_ranks
from fluxdistributed_tpu_torch.parallel import TrainState, make_train_step

N, F, LR = 3, 3072, 0.5  # ranks (and microbatches), features, step size


def _inputs(rows=2 * N, seed=0):
    """w = 0, and dyadic rows x and y (|x|, |y| < 8): their sums are
    exact in f32."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-512, 512, (rows, F)) / 64).astype(np.float32)
    y = (rng.integers(-512, 512, (rows, 5)) / 64).astype(np.float32)
    return np.zeros(F, np.float32), x, y


def _jloss(params, mstate, batch, train):
    loss = jnp.sum(params["w"] * jnp.sum(batch["x"], 0)) + jnp.sum(batch["y"])
    return loss, (mstate, None)


def _jloss_rank_mean(params, mstate, batch, train):
    """The global loss as the mean of the ranks' losses: the reference's
    division by the rank count is a division by a constant."""
    return _jloss(params, mstate, batch, train)[0] / N, (mstate, None)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want), (
        f"{np.count_nonzero(got != want)} of {got.size} entries differ")


def _jax_step(step, state, batch, mesh):
    state, m = step(state, jsharding.shard_batch(batch, mesh))
    return float(m["loss"]), np.asarray(state.params["w"])


def test_div_const_is_xlas_division_by_a_constant():
    """``div_const`` equals a jitted JAX division by a Python constant in
    f32 and bf16, and differs from a true division where the constant
    is not a power of two."""
    x = np.random.default_rng(1).normal(size=4096).astype(np.float32)
    for n in (3, 7, 12, 4):
        want = np.asarray(jax.jit(lambda a: a / n)(x))
        _same(optim.div_const(torch.from_numpy(x), n).numpy(), want)
        xb = jnp.asarray(x, jnp.bfloat16)
        _same(optim.div_const(torch.from_numpy(x).bfloat16(), n).float(),
              np.asarray(jax.jit(lambda a: a / n)(xb)).astype(np.float32))
        exact = (x / np.float32(n)).astype(np.float32)
        assert np.array_equal(want, exact) == (n == 4)


def test_accum_steps_3_bitwise_with_jax():
    """The one-device step at ``accum_steps=3``: the mean over the
    microbatches of gradients and losses, then descent."""
    w, x, y = _inputs()
    mesh = jdata_mesh(1)
    opt = joptim.descent(LR)
    jstep = jmake_step(_jloss, opt, mesh, donate=False, accum_steps=N)
    jl, jw = _jax_step(jstep, JState.create(
        jsharding.replicate({"w": jnp.asarray(w)}, mesh), opt),
        {"x": x, "y": y}, mesh)
    topt = optim.descent(LR)
    step = make_train_step(ranks.linear_loss, topt, accum_steps=N)
    st, m = step(TrainState.create({"w": torch.from_numpy(w)}, topt),
                 {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    assert m["loss"].item() == jl
    _same(st.params["w"].numpy(), jw)


@pytest.fixture(scope="module")
def three_ranks():
    """The port's DP, composable ZeRO-1 and fused ZeRO-1 steps on 3 gloo
    ranks, one step each."""
    w, x, y = _inputs()
    return w, {"x": x, "y": y}, run_ranks(ranks.division_steps, N, w, x, y,
                                          LR)


def test_dp_3_ranks_bitwise_with_jax(three_ranks):
    """3-rank DP: the all-reduced gradient and the loss divided by 3 as
    the JAX shard_map step divides them, and as the GSPMD step divides
    the mean over the ranks."""
    w, x, outs = three_ranks
    mesh = jdata_mesh(N)
    opt = joptim.descent(LR)
    state = lambda: JState.create(  # noqa: E731
        jsharding.replicate({"w": jnp.asarray(w)}, mesh), opt)
    refs = [_jax_step(jmake_shardmap(_jloss, opt, mesh, donate=False),
                      state(), x, mesh),
            _jax_step(jmake_step(_jloss_rank_mean, opt, mesh, donate=False),
                      state(), x, mesh)]
    for jl, jw in refs:
        for loss, params in (o["dp"] for o in outs):
            assert loss == jl
            _same(params["w"], jw)


def test_zero1_3_ranks_bitwise_with_jax(three_ranks):
    """3-rank composable ZeRO-1: the reduce-scattered gradient divided by
    3 as the JAX GSPMD ZeRO-1 step divides the mean over the ranks."""
    w, x, outs = three_ranks
    mesh = jdata_mesh(N)
    opt = joptim.descent(LR)
    zstate, sh = jzero1.zero1_state({"w": jnp.asarray(w)}, opt, mesh)
    jl, jw = _jax_step(jzero1.make_train_step_zero1(
        _jloss_rank_mean, opt, mesh, sh, donate=False), zstate, x, mesh)
    for loss, params in (o["zero1"] for o in outs):
        assert loss == jl
        _same(params["w"], jw)


def test_zero1_fused_3_ranks_bitwise_with_jax_schedule(three_ranks):
    """3-rank fused ZeRO-1 (adam): the optimizer chunks (m' = (1 - b1) g
    and v' = (1 - b2) g^2 from zero state, so they carry the divided
    gradient) equal the JAX fused schedule over the rank-mean gradient
    bit for bit.  The params hold at the update's own tolerance, rtol
    1e-6 (``test_torch_port_zero1.py``): XLA contracts the jitted
    ``"xla"`` update's products into FMAs, which the eager port does not."""
    w, x, outs = three_ranks
    params = {"w": jnp.asarray(w)}
    (jl, _), g = jax.jit(jax.value_and_grad(
        lambda p: _jloss_rank_mean(p, {}, x, True),
        has_aux=True))(params)
    size = jzf.packed_size(params, N)
    c = size // N
    fg, fp = jzf.pack_tree(g, N), jzf.pack_tree(params, N)
    zero = jnp.zeros((c,), jnp.float32)
    chunks = [jzf.fused_adam_update(fp[i * c:(i + 1) * c],
                                    fg[i * c:(i + 1) * c], zero, zero, 0,
                                    lr=LR, impl="xla") for i in range(N)]
    jw = jzf.unpack_tree(jnp.concatenate([o[0] for o in chunks]), params)
    for r, o in enumerate(outs):
        loss, p = o["fused"]
        assert loss == float(jl)
        np.testing.assert_allclose(p["w"], np.asarray(jw["w"]), rtol=1e-6,
                                   atol=1e-8)
        _same(o["fused_mv"][0], chunks[r][1])
        _same(o["fused_mv"][1], chunks[r][2])
