"""The FSDP gather schedule (``parallel/fsdp.py``: each block's sharded
leaves gathered at its forward, dropped after it, gathered again for
its backward, the next block's posted before it runs) against
today's gather-everything step.

On 4 gloo ranks (one spawn, bodies in
``test_torch_port_fsdp_schedule_ranks.py``): lm_tiny (depth 4, Adam)
under ``fsdp`` (``{data: 4}``) and ``fsdp_tp`` (``{data: 2, model:
2}``), and ResNet-18 (momentum,
global-batch BatchNorm) under ``fsdp``, 3 steps each from one seed,
every leaf of 64 elements or more sharded.  The schedule moves the
gathers in time and nothing else, so the losses, the parameters and
the optimizer state must be bit-equal (``torch.equal``) to the step
that gathers every leaf up front, held in the rank module as a plain
copy of the former ``view``.  The first step gathers up front while it
learns the blocks' order; from the second on, the peak of live
gathered bytes (counted by the plan, per storage, with
``weakref.finalize``) stays at or under twice the largest block's
gathered bytes plus the leaves outside the blocks, and under the
gather-all view's.  The JAX package's FSDP step is held to the port's
in ``test_torch_port_fsdp.py``; this step equals that one bit for bit.
"""

import pytest
import torch

import test_torch_port_fsdp_schedule_ranks as ranks
from fluxdistributed_tpu_torch import models
from fluxdistributed_tpu_torch.mesh import run_ranks
from fluxdistributed_tpu_torch.parallel.fsdp import model_blocks

N = 4
CASES = [("lm_tiny", "fsdp"), ("lm_tiny", "fsdp_tp"), ("resnet18", "fsdp")]


@pytest.fixture(scope="module")
def four():
    return run_ranks(ranks.schedule, N, CASES)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_schedule_is_bit_equal_to_gather_all(four, case):
    for r, out in enumerate(four):
        assert out[case]["equal"], f"rank {r}"
    for out in four[1:]:  # the loss is the batch group's mean
        assert (out[case]["losses"] == four[0][case]["losses"]).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_live_gathered_bytes_stay_under_two_blocks(four, case):
    for r, out in enumerate(four):
        o = out[case]
        assert o["blocks"] == (4 if case[0] == "lm_tiny" else 8)
        assert o["peaks"][0] >= o["all"]  # the first step gathers it all
        bound = 2 * o["block"] + o["rest"]
        for p in o["peaks"][1:]:
            assert p <= bound, (r, p, bound)
            assert p < o["all"], (r, p, o["all"])


def test_model_blocks():
    lm = models.lm_tiny(vocab=64, device="cpu")
    assert [n for n, _ in model_blocks(lm)] == [f"blocks.{i}"
                                                for i in range(4)]
    rn = models.resnet18(num_classes=10, device="cpu")
    assert [n for n, _ in model_blocks(rn)] == [
        f"layer{i}.{j}" for i in range(1, 5) for j in range(2)]
    vit = models.vit_tiny(num_classes=10, device="cpu", image_size=32)
    names = [n for n, _ in model_blocks(vit)]
    assert names[:2] == ["encoder.layers.encoder_layer_0",
                         "encoder.layers.encoder_layer_1"]
    # the head's ModuleDict holds a block the forward never calls: the
    # schedule learns the order from the first call and leaves it alone
    assert names[2:] == ["heads.head"]
    assert model_blocks(torch.nn.Linear(2, 2)) == []
