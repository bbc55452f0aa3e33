"""Small nested-dict helpers (counterpart of ``repro.utils.trees``).

Parameter trees in the port are plain nested ``dict``s of tensors, so the
pytree utilities shrink to a dict walk.
"""
from __future__ import annotations

from typing import Any, Callable


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts with identical keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list[Any]:
    if isinstance(tree, dict):
        out: list[Any] = []
        for v in tree.values():
            out.extend(tree_leaves(v))
        return out
    return [tree]
