"""The port's static analysis, and the registry of step variants.

* **AST rules** (:mod:`.rules_ast`, run by :mod:`.engine`) — FDT105
  (mesh-axis literals not sourced from ``mesh.py``) and FDT106 (metric
  names off the ``fdtpu_*`` convention): stdlib-``ast``, milliseconds.
* **concurrency rules** (:mod:`.concurrency`, FDT301-FDT305) —
  lock-coverage inference, a cross-module lock-order graph with cycle
  detection, blocking-while-locked, thread-lifecycle and
  global-mutation-in-thread audits over the host-side orchestration
  (the scheduler, the router, the watchdog, the flight recorder, the
  request tracer, the loader, the supervisor, the fault plan); paired
  with the deterministic-schedule race harness (:mod:`.schedules`).

These are copies of the JAX package's ``analysis`` modules, rooted at
the port.  Its jit-tracing AST rules (FDT101-FDT104, FDT107) and its
jaxpr layer (FDT2xx) check what only a traced JAX program has; the port
has no counterpart.  ``python -m fluxdistributed_tpu_torch.lint`` is the
CLI; ``baseline.json`` allowlists findings so a check fails only on new
ones (it is empty).

:mod:`.variants` is the registry of step variants the pricing sweeps,
with the committed memory baseline (``memory_baseline.json``).
"""

from __future__ import annotations

import os
from typing import Optional

from .findings import (  # noqa: F401
    Finding,
    SEVERITIES,
    baseline_key,
    diff_findings,
    format_finding,
    load_baseline,
    save_baseline,
    severity_rank,
    summarize,
)
from .engine import (  # noqa: F401
    default_roots,
    repo_root,
    scan_paths,
    scan_repo,
    scanned_files,
)
from .rules_ast import AST_RULES, declared_mesh_axes  # noqa: F401
from .concurrency import CONC_RULES, run_concurrency_checks  # noqa: F401

__all__ = [
    "AST_RULES",
    "CONC_RULES",
    "run_concurrency_checks",
    "Finding",
    "SEVERITIES",
    "baseline_key",
    "declared_mesh_axes",
    "default_baseline_path",
    "diff_findings",
    "format_finding",
    "lint_verdict",
    "load_baseline",
    "repo_root",
    "save_baseline",
    "scan_paths",
    "scan_repo",
    "scanned_files",
    "severity_rank",
    "summarize",
]


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def lint_verdict(baseline: Optional[str] = None) -> dict:
    """The static-health stamp (the supervisor's postmortem carries it):
    the AST-layer + concurrency-layer rule-count summary plus how many
    findings are NEW against the checked-in baseline.  It must cost
    seconds at most."""
    ast_findings = scan_repo()
    conc_findings = run_concurrency_checks()
    findings = sorted(ast_findings + conc_findings,
                      key=lambda f: (f.file, f.line, f.rule))
    base = load_baseline(baseline or default_baseline_path())
    new, _ = diff_findings(findings, base)
    out = summarize(findings, new)
    out["baseline"] = len(base)
    out["layers"] = {"ast": len(ast_findings),
                     "concurrency": len(conc_findings)}
    return out
