"""Parameter and state trees: nested dicts, lists, tuples and NamedTuples
of tensors, walked in the reference's pytree order.

The reference flattens its trees with ``jax.tree_util``: dict keys in
sorted order, list and tuple items in order, NamedTuple fields in
declaration order, and ``None`` as an empty subtree (no leaf).  The
optimizer, the train step and the checkpoints need that order (a
checkpoint's leaf ``i`` is the reference's leaf ``i``) and its path
strings (``.field``, ``['key']``, ``[i]``, joined by ``/``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    """(path key, child) pairs of an inner node, in the reference's order."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return [(f"[{i}]", c) for i, c in enumerate(tree)]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the reference's leaf order, with the
    path strings of the reference's checkpoint manifests."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            return
        if not _is_node(node):
            out.append(("/".join(prefix), node))
            return
        for key, child in _children(node):
            walk(child, prefix + [key])

    walk(tree, [])
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in leaf order,
    by ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}  # the template's key order
        items = [build(c) for _, c in _children(node)]
        return type(node)(*items) if _is_namedtuple(node) else type(node)(items)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
