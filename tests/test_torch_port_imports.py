"""The port stands alone: no module of ``fluxdistributed_tpu_torch``, nor
``chip_smoke.py``, imports ``jax``, ``flax`` or the JAX package.

A static (AST) scan: the test process itself has JAX loaded already, so
a ``sys.modules`` check could not tell.  Imports inside functions count
too.  The entry points default to ``cuda``: without a card (this box)
they raise rather than run on the CPU unasked.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "fluxdistributed_tpu"}
FILES = sorted((ROOT / "fluxdistributed_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_has_modules_to_scan():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "fluxdistributed_tpu_torch/ops/flash_decode.py" in names
    assert "fluxdistributed_tpu_torch/ops/flash_attention.py" in names
    assert "fluxdistributed_tpu_torch/train/trainer.py" in names
    assert "fluxdistributed_tpu_torch/mesh.py" in names
    assert "fluxdistributed_tpu_torch/ops/fused_adam.py" in names
    assert "fluxdistributed_tpu_torch/parallel/zero1_fused.py" in names
    assert "fluxdistributed_tpu_torch/models/resnet.py" in names
    assert "fluxdistributed_tpu_torch/models/norm.py" in names
    assert "fluxdistributed_tpu_torch/data/cifar.py" in names
    assert "fluxdistributed_tpu_torch/tree.py" in names
    for mod in ("models/vit.py", "models/convnext.py", "data/imagenet.py",
                "data/native.py", "data/preprocess.py", "data/registry.py",
                "data/sources.py", "faults.py", "train/checkpoint.py",
                "serve/vision.py", "infer.py", "train/guard.py",
                "train/model_selection.py", "train/logging.py",
                "obs/spans.py", "obs/watchdog.py", "obs/flight.py",
                "obs/server.py", "obs/memstats.py", "obs/runs.py",
                "obs/__init__.py", "parallel/fsdp.py", "parallel/tp.py",
                "parallel/rules.py", "parallel/layout.py", "sharding.py",
                "parallel/context.py", "parallel/ep.py",
                "parallel/collectives.py", "parallel/pp.py",
                "parallel/pp_1f1b.py", "parallel/pp_plan.py",
                "parallel/multihost.py", "supervise.py", "generate.py",
                "models/gpt2.py", "serve/router.py", "serve/testing.py",
                "obs/trends.py", "obs/comms.py", "obs/pricing.py",
                "obs/profile.py", "analysis/variants.py", "fit.py",
                "fake.py", "compilation.py", "obs/jaxmon.py", "lint.py",
                "analysis/concurrency.py", "analysis/schedules.py",
                "analysis/findings.py", "analysis/engine.py",
                "analysis/rules_ast.py"):
        assert f"fluxdistributed_tpu_torch/{mod}" in names
    assert "chip_smoke.py" in names and (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_new_entry_points_default_to_cuda():
    """prepare_model_selection, replay_item (through the CLI's
    --replay-step) and the CLI with the guard and observation flags run
    on ``cuda`` unless asked for the CPU."""
    import functools

    from fluxdistributed_tpu_torch import optim
    from fluxdistributed_tpu_torch.models import MLP
    from fluxdistributed_tpu_torch.train import prepare_model_selection

    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    assert inspect.signature(prepare_model_selection).parameters[
        "device"].default is None
    assert cli.build_parser().parse_args([]).device is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_model_selection(functools.partial(MLP, 192, (4,)),
                                optim.descent(), replicas=2,
                                input_shape=(8, 8, 3))
    for extra in (["--guard", "--metrics-port", "0"],
                  ["--guard", "--replay-step", "0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.run(["--model", "SimpleCNN", "--image-size", "8",
                     "--num-classes", "4", "--batch-size", "8",
                     "--cycles", "2", *extra])


def test_pipeline_entry_points_default_to_cuda():
    """The CLI's pipeline modes and ``lm_pp``'s model run on ``cuda``
    unless asked for the CPU."""
    cli = importlib.import_module("fluxdistributed_tpu_torch.train.__main__")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for spmd in ("pp", "pp_1f1b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.run(["--model", "lm_tiny", "--cycles", "1", "--spmd", spmd])


def test_pricing_entry_points_default_to_cuda():
    """The fit checker, the pricing context, the layout picker and the
    planner's fresh costs put their fake tensors on ``cuda`` unless asked
    for the CPU: without a card they raise before anything is priced."""
    from fluxdistributed_tpu_torch import fit
    from fluxdistributed_tpu_torch.models import lm_tiny
    from fluxdistributed_tpu_torch.obs import pricing, profile
    from fluxdistributed_tpu_torch.parallel import layout, pp_plan

    assert fit.build_parser().parse_args([]).device is None
    for fn in (pricing.pricing, profile.lm_layer_costs, layout.price_layouts,
               layout.pick, pp_plan.plan_from_model, pp_plan.resolve_plan):
        assert inspect.signature(fn).parameters["device"].default is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit.main(["--collect", "unused.json", "--variants", "dp"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp_plan.plan_from_model(lm_tiny(vocab=16, device="cpu"), 2, 2,
                                batch_size=2, seqlen=8)


def test_generate_supervise_and_multihost_default_to_cuda():
    """The sampling CLI, the supervisor's smokes and a multi-process
    group run on ``cuda`` unless asked for the CPU: without a card they
    raise before anything runs."""
    from fluxdistributed_tpu_torch import generate, supervise
    from fluxdistributed_tpu_torch.parallel import multihost

    assert generate.build_parser().parse_args([]).device is None
    assert supervise.build_parser().parse_args(["--smoke"]).device is None
    assert inspect.signature(multihost.initialize).parameters[
        "device"].default is None
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--model", "lm_tiny", "--vocab", "16",
                       "--prompt-tokens", "1", "--length", "3"])
    for flag in ("--smoke", "--crash-smoke"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            supervise.main([flag, "--quiet"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 2, 0)


def test_serve_and_infer_platform_default_to_cuda():
    """The serve and infer CLIs' ``--platform`` (``bin/serve.py``'s and
    ``bin/infer.py``'s) folds into ``--device``: unset, and ``gpu``, run
    on ``cuda``; ``tpu`` is refused."""
    from fluxdistributed_tpu_torch import infer
    from fluxdistributed_tpu_torch.serve import __main__ as serve_cli

    for cli in (serve_cli, infer):
        args = cli.build_parser().parse_args([])
        assert args.platform is None and args.device is None
        with pytest.raises(SystemExit, match="--platform tpu"):
            cli.main(["--platform", "tpu"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    for argv in ([], ["--platform", "gpu"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer.main(["--model", "resnet18", "--num-classes", "4", *argv])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.main(["--model", "lm_tiny", "--vocab", "16",
                            "--prewarm", *argv])
