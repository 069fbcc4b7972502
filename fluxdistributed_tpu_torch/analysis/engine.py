"""The port's lint scanner: walk source trees, run the AST rules, diff
the baseline (a copy of the JAX package's ``analysis/engine.py``).

It parses every ``.py`` file under the given roots with stdlib ``ast``
and runs the :data:`.rules_ast.AST_RULES` registry over each module.
Default roots are the port's package and ``chip_smoke.py`` — the code
that runs on the card; tests are deliberately out of scope (they
host-branch and wall-clock freely, by design).
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence, Set

from .findings import Finding
from .rules_ast import AST_RULES, ModuleContext, run_ast_rules

__all__ = [
    "repo_root",
    "default_roots",
    "iter_py_files",
    "scan_file",
    "scan_paths",
    "scan_repo",
]

#: directories never descended into
_SKIP_DIRS = {"__pycache__", ".git", "node_modules", ".venv", "venv",
              "site", "build", "dist"}


def repo_root() -> str:
    """The repository root — the parent of the
    ``fluxdistributed_tpu_torch`` package directory.  Findings report
    paths relative to it."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_roots() -> List[str]:
    """What a bare ``python -m fluxdistributed_tpu_torch.lint`` scans:
    the port's package (its CLIs are ``__main__`` modules inside it) and
    ``chip_smoke.py``, the port's proof on the card."""
    root = repo_root()
    out = [os.path.join(root, "fluxdistributed_tpu_torch"),
           os.path.join(root, "chip_smoke.py")]
    return [p for p in out if os.path.exists(p)]


def iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    seen: Set[str] = set()
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            if p.endswith(".py") and p not in seen:
                seen.add(p)
                files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                full = os.path.join(dirpath, fn)
                if fn.endswith(".py") and full not in seen:
                    seen.add(full)
                    files.append(full)
    return files


def _relpath(path: str, root: Optional[str] = None) -> str:
    root = root or repo_root()
    try:
        rel = os.path.relpath(path, root)
    except ValueError:  # different drive (windows)
        rel = path
    if rel.startswith(".."):
        rel = path
    return rel.replace(os.sep, "/")


def scan_file(path: str, root: Optional[str] = None,
              rules=None) -> List[Finding]:
    """AST-lint one file.  A file that does not parse yields the single
    finding ``FDT000`` (parse-error) — a broken file must fail the lint
    gate, not crash it."""
    rel = _relpath(path, root)
    try:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError) as e:
        line = getattr(e, "lineno", 0) or 0
        return [Finding(
            rule="FDT000", severity="error", file=rel, line=line,
            message=f"file does not parse: {type(e).__name__}: {e}",
            hint="fix the syntax error", detail=type(e).__name__)]
    ctx = ModuleContext(path, rel, source, tree)
    return run_ast_rules(ctx, rules)


def scanned_files(paths: Optional[Sequence[str]] = None,
                  root: Optional[str] = None) -> List[str]:
    """Repo-relative paths a scan of ``paths`` (default: the full
    default roots) covers — including clean files that yield no
    findings.  ``--update-baseline`` uses this to know which baseline
    entries the scan could have re-observed."""
    return [_relpath(f, root)
            for f in iter_py_files(paths or default_roots())]


def scan_paths(paths: Sequence[str], root: Optional[str] = None,
               rules=None) -> List[Finding]:
    out: List[Finding] = []
    for f in iter_py_files(paths):
        out.extend(scan_file(f, root=root, rules=rules))
    out.sort(key=lambda f: (f.file, f.line, f.rule))
    return out


def scan_repo(rules=None) -> List[Finding]:
    """The full default AST scan (the package + chip_smoke.py)."""
    return scan_paths(default_roots(), rules=rules)
