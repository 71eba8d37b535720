"""Nested containers of tensors — the port's stand-in for ``jax.tree``.

The training state is a tree: dicts (visited in sorted key order, as
``jax.tree`` visits them), lists, tuples and NamedTuples (``TrainState``,
``AdamWState``), with tensors (or any other object) as leaves. The
optimizer, the checkpoint and the driver walk it through these three
functions, so every one of them sees the leaves in one order.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), into a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(like, values: Iterable):
    """A tree of ``like``'s structure whose leaves are ``values`` in
    order (the inverse of ``leaves``)."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than leaves")
    return out
