"""Helpers on trees of tensors: the JAX package's ``tree.py`` for the
port's dicts of tensors.

A tree is a tensor (or numpy array), ``None``, or a (nested) dict, list
or tuple of them: the params, gradients, optimizer and model state of
the port are such trees.  Leaves are visited in insertion order (dicts
keep theirs); a leaf's path is its keys joined by ``/``, with ``[i]``
for a list or tuple position (the JAX package prints jax key paths).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["accum", "add_scaled", "allclose", "assert_close", "cast",
           "count_params", "div", "getfirst", "leaves", "leaves_with_path",
           "mean", "mismatches", "nbytes", "scale", "synchronize", "to_host",
           "tree_map", "zeros_like"]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of ``tree``; ``None`` stays ``None``.  Dicts
    keep their keys, lists and tuples their order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _map2(fn: Callable, a: Any, b: Any) -> Any:
    """``fn(x, y)`` over the leaves of two trees of one structure; a
    ``None`` leaf on either side reaches ``fn`` as ``None``."""
    if isinstance(a, dict) or isinstance(b, dict):
        ref = a if isinstance(a, dict) else b
        return {k: _map2(fn, None if a is None else a[k],
                         None if b is None else b[k]) for k in ref}
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        ref = a if isinstance(a, (list, tuple)) else b
        return type(ref)(_map2(fn, None if a is None else a[i],
                               None if b is None else b[i])
                         for i in range(len(ref)))
    return fn(a, b)


def zeros_like(tree: Any) -> Any:
    """A zeroed gradient tree of ``tree``'s structure (the reference's
    ``destruct``); ``None`` leaves stay ``None``."""
    return tree_map(torch.zeros_like, tree)


def accum(a: Any, b: Any) -> Any:
    """Leafwise ``a + b``, ``None`` the additive identity (the
    reference's ``_accum``)."""
    def f(x, y):
        if x is None:
            return y
        if y is None:
            return x
        return x + y

    return _map2(f, a, b)


def div(tree: Any, denom) -> Any:
    """Leafwise division by a scalar, ``None`` leaves skipped (the
    reference's ``_dodiv``).  It divides as the JAX package's compiled
    steps do (:func:`..optim.div_const`): a Python number is a
    compile-time constant there, which XLA turns into a product with its
    f32 reciprocal; a tensor ``denom`` is a traced value, a true
    division."""
    from .optim import div_const

    if torch.is_tensor(denom):
        return tree_map(lambda x: x / denom, tree)
    return tree_map(lambda x: div_const(x, denom), tree)


def scale(tree: Any, s) -> Any:
    """Leafwise ``x * s``, ``None`` leaves skipped."""
    return tree_map(lambda x: x * s, tree)


def add_scaled(a: Any, b: Any, s) -> Any:
    """``a + s * b`` leafwise, ``None``-tolerant."""
    def f(x, y):
        if y is None:
            return x
        if x is None:
            return y * s
        return x + y * s

    return _map2(f, a, b)


def mean(trees) -> Any:
    """The sequential fold of :func:`accum` over a list of trees, then
    :func:`div` by their count (the reference's hub all-reduce)."""
    trees = list(trees)
    if not trees:
        raise ValueError("mean() of an empty list of trees")
    acc = trees[0]
    for t in trees[1:]:
        acc = accum(acc, t)
    return div(acc, float(len(trees)))


def getfirst(tree: Any, name: str):
    """The first leaf (or subtree) under a key named ``name``, depth
    first in insertion order, or ``None`` (the reference's test helper
    ``getfirst``).  Matches dict keys, and the fields of a non-tuple
    object with ``_fields``; a list or tuple (a NamedTuple too) is
    walked by position, in the JAX function's order."""
    found: list = []

    def walk(node):
        if found:
            return
        if isinstance(node, dict):
            for k, v in node.items():
                if found:
                    return
                if k == name:
                    found.append(v)
                    return
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif hasattr(node, "_fields"):
            for k in node._fields:
                v = getattr(node, k)
                if k == name:
                    found.append(v)
                    return
                walk(v)

    walk(tree)
    return found[0] if found else None


def synchronize(tree: Any) -> Any:
    """Wait until the work that produces ``tree``'s leaves has run;
    returns the tree (the reference's ``synchronize()`` shim).  On a
    card that is ``torch.cuda.synchronize`` of each device the leaves
    live on; CPU leaves are ready already."""
    for dev in {x.device for x in leaves(tree)
                if torch.is_tensor(x) and x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


def leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, ``None`` leaves included."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    """The leaves that are not ``None``, in :func:`leaves_with_path`
    order."""
    return [x for _, x in leaves_with_path(tree) if x is not None]


def count_params(tree: Any) -> int:
    """Number of scalars in the tree."""
    return sum(int(np.prod(tuple(x.shape))) for x in leaves(tree))


def nbytes(tree: Any) -> int:
    """Bytes of every leaf together."""
    return sum(x.numel() * x.element_size() if torch.is_tensor(x)
               else int(x.nbytes) for x in leaves(tree))


def cast(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating-point leaf as ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def to_host(tree: Any) -> Any:
    """Every leaf copied to host memory, as detached CPU tensors (numpy
    has no bfloat16, so the port's host copies stay tensors)."""
    return tree_map(lambda x: x.detach().cpu(), tree)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def mismatches(a: Any, b: Any, rtol: float = 1e-4,
               atol: float = 1e-4) -> List[Tuple[str, str]]:
    """``(path, reason)`` for each leaf where ``a`` and ``b`` differ:
    another structure, one side ``None``, another shape, or values
    outside ``|a - b| <= atol + rtol * |b|``."""
    la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
    if len(la) != len(lb):
        return [("<tree>", f"leaf count {len(la)} vs {len(lb)}")]
    out = []
    for (pa, xa), (pb, xb) in zip(la, lb):
        if pa != pb:
            out.append((pa, f"path mismatch vs {pb}"))
        elif xa is None and xb is None:
            continue
        elif xa is None or xb is None:
            out.append((pa, "one side is None"))
        else:
            x, y = _np(xa), _np(xb)
            if x.shape != y.shape:
                out.append((pa, f"shape {x.shape} vs {y.shape}"))
            elif not np.allclose(x, y, rtol=rtol, atol=atol):
                err = float(np.max(np.abs(x - y))) if x.size else 0.0
                out.append((pa, f"max abs err {err:.3e}"))
    return out


def allclose(a: Any, b: Any, rtol: float = 1e-4, atol: float = 1e-4) -> bool:
    """True when every leaf of ``a`` matches ``b`` within tolerance."""
    return not mismatches(a, b, rtol=rtol, atol=atol)


def assert_close(a: Any, b: Any, rtol: float = 1e-4, atol: float = 1e-4,
                 msg: str = "") -> None:
    """Raise ``AssertionError`` naming the paths where the trees differ."""
    bad = mismatches(a, b, rtol=rtol, atol=atol)
    if bad:
        lines = "\n".join(f"  {p}: {r}" for p, r in bad[:20])
        more = "" if len(bad) <= 20 else f"\n  ... and {len(bad) - 20} more"
        raise AssertionError(
            f"trees differ{': ' + msg if msg else ''}\n{lines}{more}")
