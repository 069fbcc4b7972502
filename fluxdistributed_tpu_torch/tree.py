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

__all__ = ["allclose", "assert_close", "cast", "count_params", "leaves",
           "leaves_with_path", "mismatches", "nbytes", "to_host",
           "tree_map"]


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
