"""Finding / severity / baseline machinery for the port's lint suite
(a copy of the JAX package's ``analysis/findings.py``).

A :class:`Finding` is one detected hazard: rule id, severity, location
(``file:line``), a one-line message, and a fix hint.  Findings also
carry a ``detail`` key — a short, *stable* identifier (a function name,
an axis literal, a variant name) used for baseline matching instead of
the line number, so a checked-in allowlist survives unrelated edits to
the same file.

The baseline workflow (GSPMD-style "correctness as compile-time
metadata", arXiv:2004.13336, applied to the lint layer itself):

* ``analysis/baseline.json`` allowlists the findings that existed when
  the suite landed (or that are reviewed-and-accepted);
* ``python -m fluxdistributed_tpu_torch.lint --check`` fails on any
  finding NOT in the baseline —
  new hazards fail CI from day one without demanding a flag-day fix of
  every historical one;
* fixing a finding and shrinking the baseline is always safe: stale
  baseline entries are reported (not fatal) so the allowlist ratchets
  toward empty.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "SEVERITIES",
    "Finding",
    "severity_rank",
    "format_finding",
    "load_baseline",
    "save_baseline",
    "baseline_key",
    "diff_findings",
    "summarize",
]

#: ordered low → high; ``--check`` fails on any NEW finding regardless
#: of severity, but reports and summaries sort by it
SEVERITIES = ("info", "warning", "error")


def severity_rank(sev: str) -> int:
    try:
        return SEVERITIES.index(sev)
    except ValueError:
        return len(SEVERITIES)  # unknown sorts worst — fail loudly


@dataclasses.dataclass(frozen=True)
class Finding:
    """One detected hazard.  ``detail`` is the stable baseline key part
    (see module docstring); ``hint`` is the actionable fix."""

    rule: str
    severity: str
    file: str
    line: int
    message: str
    hint: str = ""
    detail: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def format_finding(f: Finding, hint: bool = True) -> str:
    """``file:line: severity [RULE] message`` — the grep-able report
    line (rule id + file:line is what the acceptance gate and CI logs
    key on)."""
    s = f"{f.file}:{f.line}: {f.severity} [{f.rule}] {f.message}"
    if hint and f.hint:
        s += f"\n    hint: {f.hint}"
    return s


def baseline_key(f: Finding) -> Tuple[str, str, str]:
    """Line-number-free identity: (rule, file, detail).  Two findings of
    one rule in one file need distinct ``detail`` values to be
    individually baselined — rules set it to the offending symbol."""
    return (f.rule, f.file.replace(os.sep, "/"), f.detail)


def load_baseline(path: str) -> List[dict]:
    """The checked-in allowlist: a JSON list of ``{"rule", "file",
    "detail", ...}`` entries (extra keys like ``note`` are carried but
    ignored for matching).  A missing file is an empty baseline."""
    if not path or not os.path.exists(path):
        return []
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, list):
        raise ValueError(
            f"baseline {path} must be a JSON list of entries, got "
            f"{type(data).__name__}")
    return data


def save_baseline(path: str, findings: Sequence[Finding],
                  keep: Iterable[dict] = ()) -> None:
    """Write the allowlist: the given findings plus any ``keep`` entries
    (prior baseline entries a partial-scope scan could not have
    re-observed — a scoped ``--update-baseline`` must not silently erase
    the rest of the allowlist).  Deduplicated on the baseline key."""
    entries = [
        {"rule": f.rule, "file": f.file.replace(os.sep, "/"),
         "detail": f.detail, "message": f.message}
        for f in findings
    ]
    seen = {(e["rule"], e["file"], e["detail"]) for e in entries}
    for e in keep:
        k = (e.get("rule", ""), e.get("file", ""), e.get("detail", ""))
        if k not in seen:
            seen.add(k)
            entries.append(dict(e))
    entries.sort(key=lambda e: (e["rule"], e["file"], e["detail"]))
    with open(path, "w") as fh:
        json.dump(entries, fh, indent=2)
        fh.write("\n")


def diff_findings(
    findings: Sequence[Finding], baseline: Iterable[dict]
) -> Tuple[List[Finding], List[dict]]:
    """Split against the allowlist: ``(new, stale)`` where ``new`` are
    findings with no baseline entry (CI-fatal under ``--check``) and
    ``stale`` are baseline entries whose finding no longer fires (safe;
    reported so the allowlist shrinks)."""
    base_keys = {
        (e.get("rule", ""), e.get("file", ""), e.get("detail", ""))
        for e in baseline
    }
    found_keys = {baseline_key(f) for f in findings}
    new = [f for f in findings if baseline_key(f) not in base_keys]
    stale = [
        e for e in baseline
        if (e.get("rule", ""), e.get("file", ""), e.get("detail", ""))
        not in found_keys
    ]
    return new, stale


def summarize(findings: Sequence[Finding],
              new: Optional[Sequence[Finding]] = None) -> dict:
    """Rule-count summary — the static-health stamp
    :func:`..analysis.lint_verdict` returns."""
    by_rule: dict = {}
    by_sev = {s: 0 for s in SEVERITIES}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        by_sev[f.severity] = by_sev.get(f.severity, 0) + 1
    out = {
        "findings": len(findings),
        "by_severity": {k: v for k, v in by_sev.items() if v},
        "by_rule": dict(sorted(by_rule.items())),
    }
    if new is not None:
        out["new"] = len(new)
    return out
