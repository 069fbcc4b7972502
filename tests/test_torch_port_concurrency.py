"""The port's concurrency rules (FDT301-FDT305,
``fluxdistributed_tpu_torch/analysis/concurrency.py``) against the JAX
package's ``run_concurrency_checks``.

* every fixture of ``tests/fixtures_analysis`` (test data, not the JAX
  package): the port finds what the JAX package finds, rule, line,
  severity and baseline detail for each;
* the JAX suite's targeted semantics (the severity split, the
  wholly-locked callee, Lock re-entry, chained ``set_function``
  receivers) on the same inline sources, both packages side by side;
* the port's own scan (its package and ``chip_smoke.py``) is clean
  against its empty committed baseline, and ``lint_verdict`` carries
  the layer counts.
"""

import json
import os
import textwrap

import pytest

from fluxdistributed_tpu.analysis import concurrency as jconc
from fluxdistributed_tpu_torch import analysis
from fluxdistributed_tpu_torch.analysis import concurrency

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures_analysis")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))


def _key(findings):
    return [(f.rule, f.file, f.line, f.severity, f.detail) for f in findings]


def test_registry_equals_the_jax_registry():
    assert [r.id for r in concurrency.CONC_RULES] == [
        r.id for r in jconc.CONC_RULES] == [f"FDT30{i}" for i in range(1, 6)]
    assert [(r.name, r.severity) for r in concurrency.CONC_RULES] == [
        (r.name, r.severity) for r in jconc.CONC_RULES]


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_equal_the_jax_package(name):
    path = os.path.join(FIXTURES, name)
    got = concurrency.run_concurrency_checks([path], root=ROOT)
    want = jconc.run_concurrency_checks([path], root=ROOT)
    assert _key(got) == _key(want)
    rid = name.split("_")[0].upper()
    if name.endswith("_pos.py") and rid.startswith("FDT3"):
        assert got and {f.rule for f in got} == {rid}
    if name.endswith("_neg.py") or name.startswith("toy_"):
        assert got == []


SOURCES = {
    "wholly_locked_callee": """
        import threading

        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = []

            def put(self, x):
                with self._lock:
                    self._put_locked(x)

            def _put_locked(self, x):
                self.items.append(x)

            def racy(self, x):
                self.items.append(x)
        """,
    "read_then_assign": """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def safe(self):
                with self._lock:
                    self.n = self.n + 1

            def racy(self):
                cur = self.n
                self.n = cur + 1
        """,
    "lock_reentry": """
        import threading

        class R:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                with self._lock:
                    self.inner()

            def inner(self):
                with self._lock:
                    pass
        """,
    "chained_set_function": """
        class G:
            def __init__(self, registry):
                self.registry = registry
                self.registry.gauge("fdtpu_x", "x").set_function(self.value)

            def value(self):
                return 1.0
        """,
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_targeted_semantics_equal_the_jax_package(name, tmp_path):
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(SOURCES[name]))
    got = concurrency.run_concurrency_checks([str(path)], root=str(tmp_path))
    want = jconc.run_concurrency_checks([str(path)], root=str(tmp_path))
    assert got, name  # each source holds one hazard
    assert _key(got) == _key(want)


def test_the_ports_scan_is_clean_against_its_empty_baseline():
    assert json.load(open(analysis.default_baseline_path())) == []
    roots = [os.path.relpath(p, ROOT) for p in analysis.default_roots()]
    assert roots == ["fluxdistributed_tpu_torch", "chip_smoke.py"]
    findings = concurrency.run_concurrency_checks()
    assert findings == [], [analysis.format_finding(f) for f in findings]


def test_lint_verdict_has_layer_counts():
    v = analysis.lint_verdict()
    assert v["new"] == 0 and v["findings"] == 0 and v["baseline"] == 0
    assert v["layers"] == {"ast": 0, "concurrency": 0}
