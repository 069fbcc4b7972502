"""The port stands alone: no module of ``fluxdistributed_tpu_torch``, nor
``chip_smoke.py``, imports ``jax``, ``flax`` or the JAX package.

A static (AST) scan: the test process itself has JAX loaded already, so
a ``sys.modules`` check could not tell.  Imports inside functions count
too.
"""

import ast
from pathlib import Path

import pytest

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
    assert "chip_smoke.py" in names and (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
