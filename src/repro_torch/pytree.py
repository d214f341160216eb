"""Nested-dict parameter trees, flattened in the JAX package's order.

JAX flattens a dict in sorted key order and a list or tuple in index order;
``None`` is an empty node. The snapshot format stores leaves by that ordinal
and names each by its ``keystr`` path (``['embed']['tok']``), so the port
flattens the same way: a snapshot written by either package restores into the
other with every leaf in its slot. ``torch.utils._pytree`` keeps dict
insertion order, which is why the port has its own walker.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    return [(f"[{i}]", v) for i, v in enumerate(node)]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree, is_leaf: Callable[[Any], bool] = None
                       ) -> List[Tuple[str, Any]]:
    """``[(keystr path, leaf), ...]`` in JAX's flattening order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path: str) -> None:
        if node is None:
            return
        if _is_node(node) and not (is_leaf is not None and is_leaf(node)):
            for key, child in _children(node):
                walk(child, path + key)
            return
        out.append((path, node))

    walk(tree, "")
    del walk        # the recursive closure is a reference cycle that would hold the leaves
    return out


def leaves(tree, is_leaf: Callable[[Any], bool] = None) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree, is_leaf)]


def structure(tree, is_leaf: Callable[[Any], bool] = None):
    """The tree with every leaf replaced by its ordinal (the snapshot's treedef)."""
    counter = iter(range(1 << 62))

    def walk(node):
        if node is None:
            return None
        if _is_node(node) and not (is_leaf is not None and is_leaf(node)):
            if isinstance(node, dict):
                return {k: walk(node[k]) for k in sorted(node)}
            return type(node)(walk(v) for v in node)
        return next(counter)

    out = walk(tree)
    del walk        # break the recursive closure's reference cycle
    return out


def unflatten(struct, flat: List[Any]):
    """Inverse of :func:`structure`: put ``flat[i]`` where ordinal ``i`` sits."""
    if struct is None:
        return None
    if isinstance(struct, dict):
        return {k: unflatten(v, flat) for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        return type(struct)(unflatten(v, flat) for v in struct)
    return flat[struct]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable[[Any], bool] = None):
    """Apply ``fn`` leafwise over ``tree``; each tree in ``rest`` is walked
    along ``tree``'s structure and hands ``fn`` whatever sits at each leaf
    position (as ``jax.tree.map`` does)."""
    if tree is None:
        return None
    if _is_node(tree) and not (is_leaf is not None and is_leaf(tree)):
        if isinstance(tree, dict):
            return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf)
                    for k in sorted(tree)}
        return type(tree)(tree_map(fn, c, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, c in enumerate(tree))
    return fn(tree, *rest)
