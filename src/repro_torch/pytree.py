"""Nested parameter trees: dicts (keys in sorted order, as JAX flattens
them), lists and tuples (by index), tensor or array leaves; ``None`` is
an empty subtree.  The optimizer and the checkpoints walk the port's
parameter tree with these."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "path_str", "tree_map", "tree_map_with_path",
           "unflatten"]


def flatten(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the tree's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def path_str(path: tuple) -> str:
    """"layers/3/mixer/wq/w": the keys and indices joined by "/", as the
    reference names a leaf."""
    return "/".join(str(p) for p in path)


def unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from the
    iterable ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(tree)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(path, leaf, *leaves of rest)`` over ``tree``'s leaves; the
    trees in ``rest`` have ``tree``'s structure."""
    flat = flatten(tree)
    others = [[leaf for _, leaf in flatten(r)] for r in rest]
    return unflatten(tree, [fn(path, leaf, *(o[i] for o in others))
                            for i, (path, leaf) in enumerate(flat)])


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)
