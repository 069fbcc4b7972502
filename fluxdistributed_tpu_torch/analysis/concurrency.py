"""Concurrency rules: race/deadlock hazards in the host-side
orchestration, detectable from source alone (a copy of the JAX
package's ``analysis/concurrency.py``, run over the port).

The serve router/scheduler, obs watchdog/flight/reqtrace, the
supervisor, the fault plan and the prefetch loader form a genuinely
multi-threaded system, and its
worst historical bugs were all races caught by hand in review (the
double-locked tracer path, unlocked read-then-increment fault indices).
This layer makes that review mechanical:

========  ======================================================
FDT301    lock-coverage inference — an attribute a class protects with
          ``with self._lock:`` somewhere but WRITES outside any lock
          elsewhere.  Read-modify-write (``+=``, read-then-assign,
          ``.append``/``.update`` mutation) is an error; a plain
          flag-store is a warning
FDT302    lock-order graph across classes/modules with cycle
          detection — an A→B lock edge in one path and B→A in another
          is a potential deadlock; so is re-acquiring a non-reentrant
          ``Lock`` through a same-class call chain
FDT303    blocking call while holding a lock — HTTP requests,
          ``subprocess`` execution, or ``join``/``wait``/``.get()``/
          ``time.sleep`` WITHOUT a timeout inside a lock region
          serializes every other thread behind an unbounded wait
FDT304    thread-lifecycle audit — a non-daemon Thread/Timer that no
          code path ever joins (leaks and blocks interpreter exit);
          a class registering scrape-time callback gauges
          (``set_function``) with no close/stop path that unregisters
          them (pins the object forever on shared registries)
FDT305    a module global mutated from a thread-target function with
          no lock held
========  ======================================================

The engine is stdlib-``ast`` only (milliseconds) and errs toward
*precision*: coverage is inferred per class from the
locks the class itself constructs, method-call edges resolve only
unambiguous names, and driver-thread-only state that is never
lock-covered is deliberately out of scope.  Findings ride the same
:mod:`.findings` baseline workflow as FDT105/FDT106; the rules live
in their own :data:`CONC_RULES` registry.

The dynamic counterpart is :mod:`.schedules` — a deterministic
lock-interposition harness that *reproduces* the interleavings these
rules predict.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

from .findings import Finding

__all__ = [
    "ConcRule",
    "CONC_RULES",
    "conc_rule",
    "run_concurrency_checks",
]

#: constructors (leaf name) that make an attribute a *lock* — the
#: region marker FDT301/302/303 coverage keys on
_LOCK_CTORS = {"Lock": "Lock", "RLock": "RLock", "Condition": "Condition",
               "Semaphore": "Semaphore", "BoundedSemaphore": "Semaphore"}

#: methods whose writes are construction, not racing mutation
_INIT_METHODS = {"__init__", "__post_init__", "__new__", "__del__"}

#: container-mutating method names — a call through a covered attribute
#: is a read-modify-write of the shared object
_MUTATORS = {"append", "extend", "appendleft", "pop", "popleft", "remove",
             "add", "discard", "update", "clear", "insert", "setdefault",
             "sort", "reverse", "popitem"}

#: dotted-call prefixes that are *always* blocking (no timeout can help)
_BLOCKING_PREFIXES = ("requests.", "urllib.request.", "subprocess.")
_BLOCKING_LEAVES_ALWAYS = {"urlopen", "check_output", "check_call",
                           "run", "call", "communicate"}
#: leaf calls blocking only when no timeout is passed: ``q.get()``,
#: ``t.join()``, ``ev.wait()``, ``time.sleep(...)`` (sleep's duration
#: arg IS the bound, so bare ``sleep`` with args still counts as
#: bounded only when the literal is small — we flag sleep regardless:
#: any deliberate sleep under a lock serializes the system)
_BLOCKING_LEAVES_TIMEOUT = {"get", "join", "wait", "acquire"}

#: method names too generic to resolve cross-class call edges through
#: (``.get()`` is every dict, ``.close()`` is every resource, ...)
_AMBIGUOUS_METHODS = {"get", "set", "put", "close", "open", "stop",
                      "start", "run", "join", "wait", "update", "clear",
                      "pop", "append", "items", "keys", "values", "read",
                      "write", "send", "record", "event"}


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _self_attr(node: ast.AST) -> Optional[str]:
    """``X`` for a ``self.X`` attribute node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_ctor_kind(node: ast.AST) -> Optional[str]:
    """``"Lock"``/``"RLock"``/... when ``node`` is a
    ``threading.Lock()``-style constructor call."""
    if isinstance(node, ast.Call):
        leaf = _dotted(node.func).split(".")[-1]
        return _LOCK_CTORS.get(leaf)
    return None


# -- per-method walk -------------------------------------------------------


@dataclasses.dataclass
class _Access:
    attr: str
    kind: str  # read | assign | aug | mutcall | substore
    node: ast.AST
    held: Tuple[str, ...]
    in_nested: bool  # inside a nested def (closure/thread target body)


@dataclasses.dataclass
class _CallSite:
    callee: str  # dotted call target ("self._emit", "rep.probe", ...)
    node: ast.Call
    held: Tuple[str, ...]
    has_timeout: bool


@dataclasses.dataclass
class _MethodModel:
    name: str
    node: ast.AST
    acquires: Set[str] = dataclasses.field(default_factory=set)
    accesses: List[_Access] = dataclasses.field(default_factory=list)
    calls: List[_CallSite] = dataclasses.field(default_factory=list)
    #: non-empty once propagation decides every call site of this
    #: (private, lock-free) method already holds these locks
    wholly_locked: Tuple[str, ...] = ()


def _with_self_locks(node: ast.With, lock_attrs: Set[str]) -> List[str]:
    """Lock attrs a ``with`` statement acquires (``with self._lock:``,
    ``with self._lock, open(...):``)."""
    out = []
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr in lock_attrs:
            out.append(attr)
    return out


def _call_has_timeout(call: ast.Call) -> bool:
    if call.args:
        return True  # join(5) / wait(0.05) / get(key, default)
    return any(k.arg == "timeout" for k in call.keywords)


def _walk_method(node: ast.AST, lock_attrs: Set[str]) -> _MethodModel:
    mm = _MethodModel(name=node.name, node=node)

    def visit(n: ast.AST, held: Tuple[str, ...], nested: bool) -> None:
        if isinstance(n, ast.With):
            got = _with_self_locks(n, lock_attrs)
            mm.acquires.update(got)
            inner = held + tuple(a for a in got if a not in held)
            for item in n.items:
                visit(item.context_expr, held, nested)
                if item.optional_vars is not None:
                    visit(item.optional_vars, held, nested)
            for child in n.body:
                visit(child, inner, nested)
            return
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and n is not node:
            # a nested def's BODY does not run under the enclosing
            # with — it is typically a thread target or callback, the
            # least-synchronized code in the class
            for child in ast.iter_child_nodes(n):
                visit(child, (), True)
            return
        if isinstance(n, ast.Lambda):
            visit(n.body, (), True)
            return
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (n.targets if isinstance(n, ast.Assign)
                       else [n.target])
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    kind = "aug" if isinstance(n, ast.AugAssign) else "assign"
                    mm.accesses.append(_Access(attr, kind, n, held, nested))
                elif (isinstance(t, ast.Subscript)):
                    base = _self_attr(t.value)
                    if base is not None:
                        mm.accesses.append(
                            _Access(base, "substore", n, held, nested))
                    else:
                        visit(t, held, nested)
                else:
                    visit(t, held, nested)
            if n.value is not None:
                visit(n.value, held, nested)
            return
        if isinstance(n, ast.Call):
            # chained receivers (`registry.gauge(...).set_function(...)`)
            # break the dotted chain — fall back to the attribute leaf
            # so method-name-keyed rules still see the call
            d = _dotted(n.func) or (
                n.func.attr if isinstance(n.func, ast.Attribute) else "")
            if d:
                mm.calls.append(_CallSite(d, n, held, _call_has_timeout(n)))
            if isinstance(n.func, ast.Attribute) and n.func.attr in _MUTATORS:
                base = _self_attr(n.func.value)
                if base is not None:
                    mm.accesses.append(
                        _Access(base, "mutcall", n, held, nested))
            for child in ast.iter_child_nodes(n):
                visit(child, held, nested)
            return
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
            attr = _self_attr(n)
            if attr is not None:
                mm.accesses.append(_Access(attr, "read", n, held, nested))
            visit(n.value, held, nested)
            return
        for child in ast.iter_child_nodes(n):
            visit(child, held, nested)

    for child in ast.iter_child_nodes(node):
        visit(child, (), False)
    return mm


# -- per-class / per-module models ----------------------------------------


@dataclasses.dataclass
class _ClassModel:
    name: str
    node: ast.ClassDef
    relpath: str
    lock_attrs: Dict[str, str]  # attr -> ctor kind (Lock/RLock/...)
    methods: Dict[str, _MethodModel]
    defines_set_function: bool = False

    def effective_held(self, mm: _MethodModel,
                       held: Tuple[str, ...]) -> Tuple[str, ...]:
        return held if held else mm.wholly_locked


@dataclasses.dataclass
class _ModuleModel:
    relpath: str
    tree: ast.Module
    classes: List[_ClassModel]
    module_locks: Set[str]
    module_globals: Set[str]
    thread_targets: Set[str]
    functions: Dict[str, List[ast.AST]]  # every def anywhere, by name
    thread_sites: List[Tuple[ast.Call, Optional[str], Optional[ast.AST]]]
    # (call node, enclosing class name, enclosing def node)


def _build_class(node: ast.ClassDef, relpath: str) -> _ClassModel:
    lock_attrs: Dict[str, str] = {}
    defines_sf = False
    method_nodes = [n for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for m in method_nodes:
        if m.name == "set_function":
            defines_sf = True
        for n in ast.walk(m):
            if isinstance(n, ast.Assign):
                kind = _lock_ctor_kind(n.value)
                if kind:
                    for t in n.targets:
                        attr = _self_attr(t)
                        if attr is not None:
                            lock_attrs[attr] = kind
    methods = {m.name: _walk_method(m, set(lock_attrs)) for m in method_nodes}
    cls = _ClassModel(node.name, node, relpath, lock_attrs, methods,
                      defines_sf)
    _propagate_wholly_locked(cls)
    return cls


def _propagate_wholly_locked(cls: _ClassModel) -> None:
    """A private lock-free method whose every in-class call site holds a
    lock runs with that lock held by contract (the repo's documented
    "lock held by caller" idiom) — treat its body as one lock region."""
    sites: Dict[str, List[Tuple[_MethodModel, Tuple[str, ...]]]] = {}
    for mm in cls.methods.values():
        for call in mm.calls:
            if call.callee.startswith("self."):
                parts = call.callee.split(".")
                if len(parts) == 2:
                    sites.setdefault(parts[1], []).append((mm, call.held))
    changed = True
    while changed:
        changed = False
        for name, mm in cls.methods.items():
            if (mm.wholly_locked or not name.startswith("_")
                    or name in _INIT_METHODS or mm.acquires):
                continue
            ss = sites.get(name)
            if not ss:
                continue
            held_sets = []
            ok = True
            for caller, held in ss:
                eff = held if held else caller.wholly_locked
                if not eff:
                    ok = False
                    break
                held_sets.append(eff)
            if ok:
                mm.wholly_locked = held_sets[0]
                changed = True


def _module_level_locks_and_globals(
        tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    locks: Set[str] = set()
    mutables: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if _lock_ctor_kind(node.value):
                locks.add(name)
            elif isinstance(node.value, (ast.Dict, ast.List, ast.Set,
                                         ast.ListComp, ast.DictComp,
                                         ast.SetComp, ast.Call)):
                mutables.add(name)
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            if _lock_ctor_kind(node.value):
                locks.add(node.target.id)
            elif isinstance(node.value, (ast.Dict, ast.List, ast.Set,
                                         ast.Call)):
                mutables.add(node.target.id)
    return locks, mutables


def _is_thread_ctor(call: ast.Call) -> Optional[str]:
    leaf = _dotted(call.func).split(".")[-1]
    return leaf if leaf in ("Thread", "Timer") else None


def _build_module(path: str, relpath: str,
                  tree: ast.Module) -> _ModuleModel:
    classes = [_build_class(n, relpath) for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef)]
    module_locks, module_globals = _module_level_locks_and_globals(tree)

    functions: Dict[str, List[ast.AST]] = {}
    thread_targets: Set[str] = set()
    thread_sites: List[Tuple[ast.Call, Optional[str], Optional[ast.AST]]] = []

    # one pass with an explicit (class, function) scope stack
    def scan(node: ast.AST, cls: Optional[str],
             fn: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                scan(child, child.name, fn)
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                functions.setdefault(child.name, []).append(child)
                scan(child, cls, child)
                continue
            if isinstance(child, ast.Call) and _is_thread_ctor(child):
                thread_sites.append((child, cls, fn))
                for k in child.keywords:
                    if k.arg == "target":
                        d = _dotted(k.value)
                        if d:
                            thread_targets.add(d.split(".")[-1])
            scan(child, cls, fn)

    scan(tree, None, None)
    return _ModuleModel(relpath, tree, classes, module_locks,
                        module_globals, thread_targets, functions,
                        thread_sites)


class CorpusContext:
    """Every scanned module, parsed and modeled — FDT302's lock-order
    graph is global across modules, so unlike the AST rules the concurrency
    rules see the whole corpus at once."""

    def __init__(self, modules: Sequence[_ModuleModel]):
        self.modules = list(modules)
        #: method name -> [(class, method model)] for every class method
        #: that acquires at least one of its own locks — the cross-class
        #: edge resolution index
        self.locking_methods: Dict[str, List[Tuple[_ClassModel,
                                                   _MethodModel]]] = {}
        for mod in self.modules:
            for cls in mod.classes:
                if not cls.lock_attrs:
                    continue
                for name, mm in cls.methods.items():
                    if mm.acquires:
                        self.locking_methods.setdefault(name, []).append(
                            (cls, mm))


# -- rule registry ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConcRule:
    id: str
    name: str
    severity: str
    description: str
    hint: str
    check: Callable[[CorpusContext], Iterable[Finding]]


CONC_RULES: List[ConcRule] = []


def conc_rule(id: str, name: str, severity: str, description: str,
              hint: str):
    """Register a concurrency rule.  ``check(corpus)`` yields findings
    over the whole scanned corpus (FDT302 is inherently cross-module;
    the others iterate per module for locality)."""

    def deco(fn):
        CONC_RULES.append(ConcRule(id, name, severity, description,
                                   hint, fn))
        return fn

    return deco


def _rule_by_id(rid: str) -> ConcRule:
    return next(r for r in CONC_RULES if r.id == rid)


def _finding(rule: ConcRule, relpath: str, node: ast.AST, message: str,
             detail: str, severity: Optional[str] = None,
             hint: Optional[str] = None) -> Finding:
    return Finding(
        rule=rule.id,
        severity=severity or rule.severity,
        file=relpath,
        line=getattr(node, "lineno", 0),
        message=message,
        hint=hint if hint is not None else rule.hint,
        detail=detail,
    )


# -- FDT301: lock-coverage inference --------------------------------------


@conc_rule(
    "FDT301", "lock-coverage", "warning",
    "An attribute the class accesses under its own lock is written "
    "elsewhere with NO lock held — two threads can interleave around "
    "the unlocked write.",
    "take the same `with self._lock:` around the unlocked write (keep "
    "callbacks/tracing OUTSIDE the region), or stop locking the "
    "attribute anywhere if it is genuinely single-thread state")
def _check_lock_coverage(corpus: CorpusContext) -> Iterable[Finding]:
    rule = _rule_by_id("FDT301")
    for mod in corpus.modules:
        for cls in mod.classes:
            if not cls.lock_attrs:
                continue
            # coverage: attr -> a lock it was accessed under
            covered: Dict[str, str] = {}
            for mm in cls.methods.values():
                for a in mm.accesses:
                    eff = cls.effective_held(mm, a.held)
                    if eff and a.attr not in covered:
                        covered[a.attr] = eff[0]
            if not covered:
                continue
            reported: Set[Tuple[str, str]] = set()
            for mm in cls.methods.values():
                if mm.name in _INIT_METHODS:
                    continue
                unlocked_reads = {
                    a.attr for a in mm.accesses
                    if a.kind == "read"
                    and not cls.effective_held(mm, a.held)}
                for a in mm.accesses:
                    if a.kind == "read" or a.attr not in covered:
                        continue
                    if a.attr in cls.lock_attrs:
                        continue
                    if cls.effective_held(mm, a.held):
                        continue
                    key = (mm.name, a.attr)
                    if key in reported:
                        continue
                    reported.add(key)
                    lock = covered[a.attr]
                    rmw = (a.kind in ("aug", "mutcall", "substore")
                           or a.attr in unlocked_reads)
                    sev = "error" if rmw else None
                    what = {"aug": "read-modify-written (augmented "
                                   "assignment)",
                            "mutcall": "mutated in place",
                            "substore": "mutated by subscript store",
                            "assign": ("read-then-assigned"
                                       if a.attr in unlocked_reads
                                       else "written")}[a.kind]
                    yield _finding(
                        rule, cls.relpath, a.node,
                        f"`self.{a.attr}` is lock-covered (accessed "
                        f"under `self.{lock}`) but {what} without the "
                        f"lock in `{cls.name}.{mm.name}`",
                        detail=f"{cls.name}.{mm.name}.{a.attr}",
                        severity=sev)


# -- FDT302: lock-order cycles --------------------------------------------


@conc_rule(
    "FDT302", "lock-order-cycle", "error",
    "The cross-class lock-acquisition graph has a cycle — two threads "
    "taking the locks in opposite order deadlock.",
    "establish one global acquisition order (document it), or narrow a "
    "lock region so the nested acquisition happens after release — the "
    "registry's copy-under-lock/render-after-release pattern")
def _check_lock_order(corpus: CorpusContext) -> Iterable[Finding]:
    rule = _rule_by_id("FDT302")
    # nodes "Class.lockattr"; edges (holder -> acquired) with a witness
    edges: Dict[str, Dict[str, Tuple[str, ast.AST]]] = {}

    def add_edge(src: str, dst: str, relpath: str, node: ast.AST) -> None:
        edges.setdefault(src, {}).setdefault(dst, (relpath, node))

    for mod in corpus.modules:
        for cls in mod.classes:
            if not cls.lock_attrs:
                continue
            for mm in cls.methods.values():
                for call in mm.calls:
                    held = cls.effective_held(mm, call.held)
                    if not held:
                        continue
                    parts = call.callee.split(".")
                    leaf = parts[-1]
                    if parts[0] == "self" and len(parts) == 2:
                        callee = cls.methods.get(leaf)
                        if callee is None:
                            continue
                        for lk in callee.acquires:
                            for src in held:
                                if lk == src:
                                    # re-entry through a non-reentrant
                                    # Lock is an immediate self-deadlock
                                    if cls.lock_attrs.get(lk) == "Lock":
                                        yield _finding(
                                            rule, cls.relpath, call.node,
                                            f"`{cls.name}.{mm.name}` "
                                            f"holds `self.{lk}` (a "
                                            f"non-reentrant Lock) and "
                                            f"calls `self.{leaf}` which "
                                            f"acquires it again",
                                            detail=(f"{cls.name}.{lk}"
                                                    f"->{cls.name}.{lk}"))
                                else:
                                    add_edge(f"{cls.name}.{src}",
                                             f"{cls.name}.{lk}",
                                             cls.relpath, call.node)
                        continue
                    if leaf in _AMBIGUOUS_METHODS:
                        continue
                    targets = corpus.locking_methods.get(leaf, [])
                    # resolve only an unambiguous method name — one
                    # lock-acquiring class in the whole corpus defines it
                    resolved = {id(c.node): (c, m) for c, m in targets}
                    if len(resolved) != 1:
                        continue
                    (tcls, tmm), = resolved.values()
                    if tcls is cls:
                        continue
                    for lk in tmm.acquires:
                        for src in held:
                            add_edge(f"{cls.name}.{src}",
                                     f"{tcls.name}.{lk}",
                                     cls.relpath, call.node)

    # cycle detection: DFS with colors; report each cycle once,
    # canonicalized by its sorted node set
    seen_cycles: Set[Tuple[str, ...]] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(node: str) -> Iterable[Finding]:
        color[node] = GRAY
        stack.append(node)
        for nxt, (relpath, witness) in edges.get(node, {}).items():
            c = color.get(nxt, WHITE)
            if c == GRAY:
                cyc = tuple(stack[stack.index(nxt):])
                key = tuple(sorted(cyc))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    path = " -> ".join(cyc + (nxt,))
                    yield _finding(
                        rule, relpath, witness,
                        f"lock-order cycle: {path} — threads taking "
                        f"these locks in opposite order deadlock",
                        detail="->".join(key))
            elif c == WHITE:
                yield from dfs(nxt)
        stack.pop()
        color[node] = BLACK

    for node in sorted(edges):
        if color.get(node, WHITE) == WHITE:
            yield from dfs(node)


# -- FDT303: blocking call while holding a lock ---------------------------


@conc_rule(
    "FDT303", "blocking-under-lock", "warning",
    "A blocking call (network/subprocess, or an unbounded "
    "join/wait/get/sleep) runs INSIDE a lock region — every other "
    "thread needing the lock stalls behind it, unboundedly.",
    "move the blocking call outside the region (snapshot state under "
    "the lock, block after release), or pass a timeout")
def _check_blocking_under_lock(corpus: CorpusContext) -> Iterable[Finding]:
    rule = _rule_by_id("FDT303")
    for mod in corpus.modules:
        for cls in mod.classes:
            if not cls.lock_attrs:
                continue
            for mm in cls.methods.values():
                for call in mm.calls:
                    held = cls.effective_held(mm, call.held)
                    if not held:
                        continue
                    d = call.callee
                    leaf = d.split(".")[-1]
                    blocking = None
                    if d.startswith(_BLOCKING_PREFIXES) \
                            or leaf in _BLOCKING_LEAVES_ALWAYS:
                        blocking = "a network/subprocess call"
                    elif d in ("time.sleep", "sleep") and d != "sleep":
                        blocking = "a deliberate sleep"
                    elif leaf in _BLOCKING_LEAVES_TIMEOUT \
                            and not call.has_timeout:
                        # `.wait()`/`.join()`/`.get()` with no bound;
                        # exclude the held locks' own condition methods?
                        # no — Condition.wait() under the SAME lock is
                        # legal, so skip waits on a held lock attr
                        base = _self_attr(call.node.func.value) \
                            if isinstance(call.node.func,
                                          ast.Attribute) else None
                        if base in held:
                            continue
                        blocking = f"an unbounded `.{leaf}()`"
                    if blocking is None:
                        continue
                    yield _finding(
                        rule, cls.relpath, call.node,
                        f"`{cls.name}.{mm.name}` holds "
                        f"`self.{held[0]}` across {blocking} "
                        f"(`{d}`)",
                        detail=f"{cls.name}.{mm.name}.{leaf}")


# -- FDT304: thread lifecycle ---------------------------------------------


def _daemon_kwarg(call: ast.Call) -> Optional[bool]:
    for k in call.keywords:
        if k.arg == "daemon" and isinstance(k.value, ast.Constant):
            return bool(k.value.value)
    return None


def _scope_has(node: ast.AST, pred) -> bool:
    return any(pred(n) for n in ast.walk(node))


@conc_rule(
    "FDT304", "thread-lifecycle", "warning",
    "A non-daemon Thread/Timer no code path ever joins (blocks "
    "interpreter exit, leaks on restart), or a class registers "
    "scrape-time callback gauges with no close/stop path that "
    "unregisters them (pins the dead object on shared registries).",
    "pass `daemon=True` (or `.daemon = True` before start) for "
    "fire-and-forget threads, `.join()` on the shutdown path "
    "otherwise; pair every `set_function` registration with an "
    "`unregister` in `close()`")
def _check_thread_lifecycle(corpus: CorpusContext) -> Iterable[Finding]:
    rule = _rule_by_id("FDT304")
    for mod in corpus.modules:
        # (a) non-daemon thread never joined
        for call, clsname, fn in mod.thread_sites:
            daemon = _daemon_kwarg(call)
            if daemon is True:
                continue
            # scope to search for `.daemon = True` / `.join(`: the
            # enclosing class body when inside a class, else the
            # enclosing function, else the module
            scope: ast.AST = mod.tree
            if clsname is not None:
                for c in mod.classes:
                    if c.name == clsname:
                        scope = c.node
                        break
            elif fn is not None:
                scope = fn

            def _is_daemon_set(n: ast.AST) -> bool:
                return (isinstance(n, ast.Assign)
                        and any(isinstance(t, ast.Attribute)
                                and t.attr == "daemon" for t in n.targets)
                        and isinstance(n.value, ast.Constant)
                        and bool(n.value.value))

            def _is_join(n: ast.AST) -> bool:
                return (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "join")

            if daemon is None and _scope_has(scope, _is_daemon_set):
                continue
            if _scope_has(scope, _is_join):
                continue
            where = clsname or (fn.name if fn is not None else "<module>")
            yield _finding(
                rule, mod.relpath, call,
                f"non-daemon {_dotted(call.func).split('.')[-1]} created "
                f"in `{where}` is never joined (and never marked "
                f"daemon) — it blocks interpreter exit",
                detail=f"{where}.thread")
        # (b) set_function registrations with no unregistering teardown
        for cls in mod.classes:
            if cls.defines_set_function:
                continue  # the metrics plumbing itself
            reg_node = None
            for mm in cls.methods.values():
                for callsite in mm.calls:
                    if callsite.callee.split(".")[-1] == "set_function":
                        reg_node = callsite.node
                        break
                if reg_node is not None:
                    break
            if reg_node is None:
                continue
            teardown = {"close", "stop", "shutdown", "__exit__",
                        "__del__", "unregister"}
            detaches = any(
                c.callee.split(".")[-1].startswith("unregister")
                for name, mm in cls.methods.items()
                if name in teardown
                for c in mm.calls)
            if not detaches:
                yield _finding(
                    rule, cls.relpath, reg_node,
                    f"`{cls.name}` registers callback gauges "
                    f"(`set_function`) but no close/stop path "
                    f"unregisters them — on a shared registry the dead "
                    f"object is pinned and scraped forever",
                    detail=f"{cls.name}.set_function")


# -- FDT305: unlocked module-global mutation from a thread target ---------


@conc_rule(
    "FDT305", "global-mutation-in-thread", "warning",
    "A thread-target function mutates a module global with no lock "
    "held — concurrent with every other thread touching it.",
    "guard the mutation with a module-level lock (the `_PLAN`-style "
    "install/clear pattern), or pass state through the thread's own "
    "arguments")
def _check_global_mutation(corpus: CorpusContext) -> Iterable[Finding]:
    rule = _rule_by_id("FDT305")
    for mod in corpus.modules:
        if not mod.thread_targets:
            continue
        for name in sorted(mod.thread_targets):
            for fn in mod.functions.get(name, []):
                yield from _scan_target(rule, mod, fn)


def _scan_target(rule: ConcRule, mod: _ModuleModel,
                 fn: ast.AST) -> Iterable[Finding]:
    declared_global: Set[str] = {
        n for node in ast.walk(fn) if isinstance(node, ast.Global)
        for n in node.names}
    mutable = mod.module_globals | declared_global
    if not mutable:
        return
    reported: Set[str] = set()

    def visit(n: ast.AST, held: bool) -> Iterable[Finding]:
        if isinstance(n, ast.With):
            # ANY with-region counts as synchronized — precision over
            # recall (the region is usually `with _lock:`)
            for item in n.items:
                yield from visit(item.context_expr, held)
            for child in n.body:
                yield from visit(child, True)
            return
        hits: List[Tuple[str, str]] = []
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id in declared_global:
                    hits.append((t.id, "rebound"))
                elif isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in mutable:
                    hits.append((t.value.id, "subscript-mutated"))
        elif isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _MUTATORS \
                and isinstance(n.func.value, ast.Name) \
                and n.func.value.id in mutable:
            hits.append((n.func.value.id, "mutated in place"))
        for gname, what in hits:
            if not held and gname not in reported:
                reported.add(gname)
                yield _finding(
                    rule, mod.relpath, n,
                    f"thread target `{fn.name}` {what.replace('-', ' ')} "
                    f"module global `{gname}` with no lock held",
                    detail=f"{fn.name}.{gname}")
        for child in ast.iter_child_nodes(n):
            yield from visit(child, held)

    for child in ast.iter_child_nodes(fn):
        yield from visit(child, False)


# -- entry point -----------------------------------------------------------


def run_concurrency_checks(
        paths: Optional[Sequence[str]] = None,
        root: Optional[str] = None,
        rules: Optional[Sequence[ConcRule]] = None) -> List[Finding]:
    """Parse ``paths`` (default: the port's package and
    ``chip_smoke.py``) and run the FDT3xx registry over the whole
    corpus.  Unparsable files are skipped here — the AST layer's FDT000
    already gates them."""
    from .engine import _relpath, default_roots, iter_py_files

    modules: List[_ModuleModel] = []
    for path in iter_py_files(list(paths) if paths else default_roots()):
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError, ValueError):
            continue
        modules.append(_build_module(path, _relpath(path, root), tree))
    corpus = CorpusContext(modules)
    out: List[Finding] = []
    for rule in (rules or CONC_RULES):
        out.extend(rule.check(corpus))
    out.sort(key=lambda f: (f.file, f.line, f.rule))
    return out
