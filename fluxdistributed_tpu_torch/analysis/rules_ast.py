"""AST rules that are not about JAX: FDT105 (mesh-axis literals) and
FDT106 (metric names), with the registry machinery of the JAX
package's ``analysis/rules_ast.py``, copied.

========  ======================================================
FDT105    mesh-axis name literals not sourced from the port's
          ``mesh.py`` declarations (unknown literal = error; a
          hardcoded copy of a declared axis = warning — renames drift
          silently)
FDT106    metric names off the byte-pinned ``fdtpu_*`` convention
          (the obs exposition parity tests pin it byte-for-byte)
========  ======================================================

The JAX package's other AST rules (FDT101-FDT104 and FDT107) check jit
tracing, weak-typed scalars, trace-time captures and donation; the port
traces nothing, so they have no counterpart here.  The engine is
stdlib-``ast`` only: rules run anywhere, in milliseconds.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

from .findings import Finding

__all__ = [
    "AstRule",
    "AST_RULES",
    "ModuleContext",
    "ast_rule",
    "declared_mesh_axes",
    "run_ast_rules",
]

#: the serving/training metric-name convention, byte-pinned by the obs
#: parity tests — see obs/metrics.py
_METRIC_NAME_RE = re.compile(r"^fdtpu_[a-z0-9_]+$")


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, '' for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""



class ModuleContext:
    """One parsed module and the mesh-axis declarations the rules
    share."""

    def __init__(self, path: str, relpath: str, source: str,
                 tree: ast.Module, axes: Optional[Set[str]] = None):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.axes = axes if axes is not None else declared_mesh_axes()



_AXES_CACHE: Optional[Set[str]] = None


def declared_mesh_axes(mesh_path: Optional[str] = None) -> Set[str]:
    """The axis-name literals declared as ``*_AXIS = "..."`` in
    ``mesh.py`` — THE source of truth every other axis mention must
    derive from.  Parsed from source (not imported), so the linter
    imports nothing of what it scans."""
    global _AXES_CACHE
    if mesh_path is None and _AXES_CACHE is not None:
        return _AXES_CACHE
    import os

    path = mesh_path or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "mesh.py")
    axes: Set[str] = set()
    try:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError, ValueError):
        # axes UNKNOWN (mesh.py unreadable/mid-edit) — FDT105 must then
        # stand down entirely rather than call every literal undeclared;
        # the empty set signals that (and FDT000 reports the parse error)
        return set()
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.endswith("_AXIS")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            axes.add(node.value.value)
    if mesh_path is None:
        _AXES_CACHE = axes
    return axes


# -- rule registry --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AstRule:
    id: str
    name: str
    severity: str
    description: str
    hint: str
    check: Callable[[ModuleContext], Iterable[Finding]]


AST_RULES: List[AstRule] = []


def ast_rule(id: str, name: str, severity: str, description: str, hint: str):
    """Register an AST rule.  ``check(ctx)`` yields findings; the
    decorator fills rule id / severity / hint so rule bodies only state
    locations and messages."""

    def deco(fn):
        rule = AstRule(id, name, severity, description, hint, fn)
        AST_RULES.append(rule)
        return fn

    return deco


def _finding(rule: AstRule, ctx: ModuleContext, node: ast.AST,
             message: str, detail: str, severity: Optional[str] = None,
             hint: Optional[str] = None) -> Finding:
    return Finding(
        rule=rule.id,
        severity=severity or rule.severity,
        file=ctx.relpath,
        line=getattr(node, "lineno", 0),
        message=message,
        hint=hint if hint is not None else rule.hint,
        detail=detail,
    )


def _rule_by_id(rid: str) -> AstRule:
    return next(r for r in AST_RULES if r.id == rid)


def run_ast_rules(ctx: ModuleContext,
                  rules: Optional[Sequence[AstRule]] = None) -> List[Finding]:
    out: List[Finding] = []
    for rule in (rules or AST_RULES):
        out.extend(rule.check(ctx))
    return out


# -- FDT101: tracer branch -------------------------------------------------


# -- FDT105: axis-name literals -------------------------------------------

def _axis_literal_findings(ctx: ModuleContext, rule: AstRule):
    if ctx.relpath.replace("\\", "/").endswith(
            "fluxdistributed_tpu_torch/mesh.py"):
        return  # the declarations themselves
    axes = ctx.axes
    if not axes:
        return  # axes unknown (mesh.py unparseable) is not axes invalid
    func_stack: List[str] = []

    def fname() -> str:
        return func_stack[-1] if func_stack else "<module>"

    def walk(node: ast.AST):
        is_func = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        if is_func:
            func_stack.append(node.name)
            # (c) parameter defaults for *axis* parameters
            a = node.args
            pos = a.posonlyargs + a.args
            for arg, default in zip(pos[len(pos) - len(a.defaults):],
                                    a.defaults):
                if arg.arg.endswith("axis") and isinstance(default, ast.Constant) \
                        and isinstance(default.value, str) and default.value in axes:
                    yield _finding(
                        rule, ctx, default,
                        f"default {arg.arg}={default.value!r} hardcodes a "
                        "mesh axis name",
                        detail=f"{node.name}:{arg.arg}={default.value}",
                        severity="warning",
                        hint="default it to the mesh constant "
                             "(mesh.DATA_AXIS / MODEL_AXIS / ...) so a "
                             "rename cannot drift")
            for kwarg, default in zip(a.kwonlyargs, a.kw_defaults):
                if default is not None and kwarg.arg.endswith("axis") \
                        and isinstance(default, ast.Constant) \
                        and isinstance(default.value, str) and default.value in axes:
                    yield _finding(
                        rule, ctx, default,
                        f"default {kwarg.arg}={default.value!r} hardcodes a "
                        "mesh axis name",
                        detail=f"{node.name}:{kwarg.arg}={default.value}",
                        severity="warning",
                        hint="default it to the mesh constant so a rename "
                             "cannot drift")
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d.split(".")[-1] == "ShardLargest":
                # (e) shape-driven rule values in declarative rule
                # tables (parallel/rules.py): the axis argument is a
                # mesh axis name exactly like a P() entry
                cands = list(node.args[:1]) + [
                    kw.value for kw in node.keywords if kw.arg == "axis"]
                for e in cands:
                    if isinstance(e, ast.Constant) and isinstance(e.value, str):
                        if e.value not in axes:
                            yield _finding(
                                rule, ctx, e,
                                f"ShardLargest axis {e.value!r} is not "
                                "declared in mesh.py — rule resolution "
                                "rejects it on any real mesh",
                                detail=f"{fname()}:ShardLargest:{e.value}")
                        else:
                            yield _finding(
                                rule, ctx, e,
                                f"ShardLargest hardcodes axis "
                                f"{e.value!r} as a string literal",
                                detail=f"{fname()}:ShardLargest:{e.value}",
                                severity="warning",
                                hint="use the mesh constant "
                                     "(mesh.FSDP_AXIS / ...) instead "
                                     "of the literal")
            if d.split(".")[-1] in ("P", "PartitionSpec"):
                # (a) P()/PartitionSpec() arguments, including tuples
                for arg in node.args:
                    elts = arg.elts if isinstance(arg, ast.Tuple) else [arg]
                    for e in elts:
                        if isinstance(e, ast.Constant) and isinstance(e.value, str):
                            if e.value not in axes:
                                yield _finding(
                                    rule, ctx, e,
                                    f"PartitionSpec axis {e.value!r} is not "
                                    "declared in mesh.py — no mesh "
                                    "has it, so sharding refuses it on "
                                    "any real mesh",
                                    detail=f"{fname()}:P:{e.value}")
                            else:
                                yield _finding(
                                    rule, ctx, e,
                                    f"PartitionSpec hardcodes axis "
                                    f"{e.value!r} as a string literal",
                                    detail=f"{fname()}:P:{e.value}",
                                    severity="warning",
                                    hint="use the mesh constant "
                                         "(mesh.DATA_AXIS / ...) instead "
                                         "of the literal")
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id.endswith("_AXIS") \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str) \
                and node.value.value in axes:
            # (b) a duplicate declaration of a mesh.py axis
            yield _finding(
                rule, ctx, node,
                f"{node.targets[0].id} = {node.value.value!r} re-declares "
                "a mesh.py axis literal — renames drift silently",
                detail=f"{fname()}:{node.targets[0].id}",
                severity="warning",
                hint="import the constant from fluxdistributed_tpu_torch.mesh "
                     "instead of re-declaring the literal")
        if isinstance(node, ast.Subscript) \
                and isinstance(node.value, ast.Attribute) \
                and node.value.attr == "shape" \
                and isinstance(node.slice, ast.Constant) \
                and isinstance(node.slice.value, str) \
                and node.slice.value in axes:
            # (d) mesh.shape["pipe"]-style lookups
            yield _finding(
                rule, ctx, node,
                f".shape[{node.slice.value!r}] hardcodes a mesh axis name",
                detail=f"{fname()}:shape:{node.slice.value}",
                severity="warning",
                hint="index with the mesh constant (mesh.PIPE_AXIS / ...)")
        for child in ast.iter_child_nodes(node):
            yield from walk(child)
        if is_func:
            func_stack.pop()

    yield from walk(ctx.tree)


@ast_rule(
    "FDT105", "axis-literal", "error",
    "mesh-axis name literals not sourced from mesh.py's declarations — "
    "in PartitionSpecs, axis-parameter defaults, mesh.shape lookups AND "
    "declarative rule tables (ShardLargest axis arguments): an unknown "
    "literal names no axis of any mesh; a hardcoded copy of a declared "
    "axis drifts silently on rename.",
    "source axis names from fluxdistributed_tpu_torch.mesh constants")
def _check_axis_literal(ctx: ModuleContext) -> Iterable[Finding]:
    yield from _axis_literal_findings(ctx, _rule_by_id("FDT105"))


# -- FDT106: metric-name convention ---------------------------------------

def _str_bindings(tree: ast.Module) -> Dict[str, str]:
    """Names that resolve to exactly ONE compile-time string across the
    whole module — the registration-prefix idiom (``METRIC_PREFIX =
    "fdtpu_serve_"``; ``r, p = self.registry, METRIC_PREFIX``) that
    FDT106 must see through.  Conservative on purpose: a name that is
    ever a function parameter, a loop target, or assigned anything
    unresolvable never resolves (a false "covered" is worse than a
    skipped dynamic name)."""
    raw: Dict[str, list] = {}

    def poison(target) -> None:
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                raw.setdefault(n.id, []).append(None)

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            pairs = []
            for t in node.targets:
                if isinstance(t, ast.Tuple) and isinstance(
                        node.value, ast.Tuple) and len(t.elts) == len(
                        node.value.elts):
                    pairs.extend(zip(t.elts, node.value.elts))
                else:
                    pairs.append((t, node.value))
            for t, v in pairs:
                if isinstance(t, ast.Name):
                    raw.setdefault(t.id, []).append(v)
                else:
                    poison(t)
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            raw.setdefault(node.target.id, []).append(node.value)
        elif isinstance(node, ast.AugAssign):
            # PREFIX += "..." rebinds to a value this resolver does not
            # model — the stale original must not keep resolving
            poison(node.target)
        elif isinstance(node, ast.NamedExpr):
            poison(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            poison(node.target)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None:
                    poison(item.optional_vars)
        elif isinstance(node, ast.ExceptHandler) and node.name:
            raw.setdefault(node.name, []).append(None)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                raw.setdefault(alias.asname or alias.name.split(".")[0],
                               []).append(None)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            a = node.args
            for arg in (*a.posonlyargs, *a.args, *a.kwonlyargs,
                        *((a.vararg,) if a.vararg else ()),
                        *((a.kwarg,) if a.kwarg else ())):
                raw.setdefault(arg.arg, []).append(None)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                poison(gen.target)
    resolved: Dict[str, str] = {}
    for _ in range(4):  # fixpoint: aliases of aliases settle in passes
        changed = False
        for name, vals in raw.items():
            if name in resolved:
                continue
            out = set()
            for v in vals:
                s = _const_str(v, resolved) if v is not None else None
                if s is None:
                    out = None
                    break
                out.add(s)
            if out and len(out) == 1:
                resolved[name] = out.pop()
                changed = True
        if not changed:
            break
    return resolved


def _const_str(node, bindings: Dict[str, str]) -> Optional[str]:
    """Resolve an expression to a compile-time string (literal, resolved
    name, ``+`` concatenation, f-string of resolvable parts) or None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return bindings.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _const_str(node.left, bindings)
        right = _const_str(node.right, bindings)
        return left + right if left is not None and right is not None else None
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            elif isinstance(v, ast.FormattedValue):
                if v.format_spec is not None or v.conversion != -1:
                    return None
                s = _const_str(v.value, bindings)
                if s is None:
                    return None
                parts.append(s)
            else:
                return None
        return "".join(parts)
    return None


@ast_rule(
    "FDT106", "metric-name", "warning",
    "a metric registered off the byte-pinned `fdtpu_*` snake_case "
    "convention — dashboards and the obs/ exposition parity tests key "
    "on the prefix.  Prefix-constant concatenations (`METRIC_PREFIX + "
    "\"queue_depth\"`) are resolved; truly dynamic names stay out of "
    "scope.",
    "name it fdtpu_<subsystem>_<what>_<unit> (e.g. "
    "fdtpu_train_step_seconds)")
def _check_metric_names(ctx: ModuleContext) -> Iterable[Finding]:
    rule = _rule_by_id("FDT106")
    bindings = _str_bindings(ctx.tree)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr not in ("counter", "gauge", "histogram"):
            continue
        if not node.args:
            continue
        name = _const_str(node.args[0], bindings)
        if name is None:
            continue
        if not _METRIC_NAME_RE.match(name):
            yield _finding(
                rule, ctx, node,
                f"metric name {name!r} violates the fdtpu_* convention",
                detail=name)


