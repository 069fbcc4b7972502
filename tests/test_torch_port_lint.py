"""The port's AST rules (FDT105 axis literals, FDT106 metric names) and
its lint CLI, ``python -m fluxdistributed_tpu_torch.lint``.

* On every fixture of ``tests/fixtures_analysis`` the port's FDT105 and
  FDT106 find what the JAX package's two rules find (rule, line,
  severity, detail); the JAX package's other AST rules are about jit
  tracing and have no counterpart.
* FDT105 reads the port's ``mesh.py`` as the declarations (the JAX
  rule, which knows only its own package's file, would flag them), and
  the port's whole AST scan is clean.
* The CLI: ``--check`` exits 0 on the port and 1 on a positive fixture,
  the layer switch, ``--json``, the ``--update-baseline`` keep rule,
  and the JAX CLI's jaxpr flags accepted with nothing to run.
"""

import json
import os
import subprocess
import sys

import pytest

from fluxdistributed_tpu.analysis import engine as jengine
from fluxdistributed_tpu.analysis import rules_ast as jrules
from fluxdistributed_tpu_torch import analysis, lint
from fluxdistributed_tpu_torch.analysis import engine, rules_ast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures_analysis")
FIXTURE_FILES = sorted(f for f in os.listdir(FIXTURES) if f.endswith(".py"))
PORTED = ("FDT105", "FDT106")


def _key(findings):
    return [(f.rule, f.file, f.line, f.severity, f.detail) for f in findings]


def test_the_ast_registry_holds_the_two_ported_rules():
    assert [r.id for r in rules_ast.AST_RULES] == list(PORTED)
    for r in rules_ast.AST_RULES:
        j = next(x for x in jrules.AST_RULES if x.id == r.id)
        assert (r.name, r.severity) == (j.name, j.severity)
    assert rules_ast.declared_mesh_axes() == jrules.declared_mesh_axes()


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_fixture_findings_equal_the_jax_package(name):
    path = os.path.join(FIXTURES, name)
    jx = [r for r in jrules.AST_RULES if r.id in PORTED]
    got = engine.scan_paths([path], root=ROOT)
    want = jengine.scan_paths([path], root=ROOT, rules=jx)
    assert _key(got) == _key(want)
    rid = name.split("_")[0].upper()
    if rid in PORTED:
        assert bool(got) == name.endswith("_pos.py")


def test_fdt105_reads_the_ports_mesh_as_its_declarations():
    mesh = os.path.join(ROOT, "fluxdistributed_tpu_torch", "mesh.py")
    assert engine.scan_paths([mesh], root=ROOT) == []
    # the JAX rule skips only its own mesh.py: the port's declarations
    # are hardcoded copies of the same axes to it
    flagged = jengine.scan_paths(
        [mesh], root=ROOT,
        rules=[r for r in jrules.AST_RULES if r.id == "FDT105"])
    assert {f.detail for f in flagged} >= {"<module>:DATA_AXIS",
                                           "<module>:PIPE_AXIS"}


def test_the_ports_ast_scan_is_clean():
    findings = analysis.scan_repo()
    assert findings == [], [analysis.format_finding(f) for f in findings]


def _cli(*args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "fluxdistributed_tpu_torch.lint", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_cli_check_passes_on_the_port():
    p = _cli("--check")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 new vs baseline (0 entries)" in p.stdout


@pytest.mark.parametrize("rid", ["FDT105", "FDT106", "FDT301"])
def test_cli_check_fails_on_a_positive_fixture(rid, capsys):
    fixture = os.path.join("tests", "fixtures_analysis",
                           f"{rid.lower()}_pos.py")
    assert lint.main([os.path.join(ROOT, fixture), "--check"]) == 1
    out = capsys.readouterr().out
    assert f"[{rid}]" in out and "fixtures_analysis" in out


def test_cli_layer_switch_json_and_jaxpr_flags(capsys):
    fixture = os.path.join(FIXTURES, "fdt301_pos.py")
    assert lint.main([fixture, "--check", "--no-concurrency"]) == 0
    assert lint.main([fixture, "--json", "--jaxpr", "--variants", "dp",
                      "--execute", "--no-jaxpr"]) == 0
    out = capsys.readouterr().out
    blob = json.loads(out[out.index("{"):])
    assert blob["summary"]["by_rule"] == {"FDT301": 2}
    assert {f["rule"] for f in blob["new"]} == {"FDT301"}
    assert lint.main(["--check", "--baseline", "no/such.json"]) == 2


def test_cli_flags_are_the_jax_clis():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_lint_cli", os.path.join(ROOT, "bin", "lint.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in parser._actions}

    assert flags(lint.build_parser()) == flags(jcli.build_parser())


def test_cli_update_baseline_keeps_fdt3xx_when_layer_off(tmp_path):
    baseline = str(tmp_path / "baseline.json")
    fixture = os.path.join(FIXTURES, "fdt301_pos.py")
    assert lint.main([fixture, "--update-baseline",
                      "--baseline", baseline]) == 0
    assert {e["rule"] for e in json.load(open(baseline))} == {"FDT301"}
    # layer off: the FDT3xx entries survive an in-scope re-update
    assert lint.main([fixture, "--update-baseline", "--no-concurrency",
                      "--baseline", baseline]) == 0
    assert {e["rule"] for e in json.load(open(baseline))} == {"FDT301"}
    assert lint.main([fixture, "--check", "--baseline", baseline]) == 0
