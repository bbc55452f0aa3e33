"""Small nested-dict helpers (counterpart of ``repro.utils.trees``).

Parameter trees in the port are plain nested ``dict``s and ``list``s of
tensors (the LM keeps its layer groups in a list), so the pytree
utilities shrink to a walk over those two.
"""
from __future__ import annotations

from typing import Any, Callable


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts and lists of one
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list[Any]:
    """The leaves in a fixed order: dict insertion order, list order."""
    if isinstance(tree, (dict, list)):
        out: list[Any] = []
        for v in tree.values() if isinstance(tree, dict) else tree:
            out.extend(tree_leaves(v))
        return out
    return [tree]
