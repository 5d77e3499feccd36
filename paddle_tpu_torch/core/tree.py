"""Nested containers of tensors, flattened in ``jax.tree_util`` order.

A tree is a leaf or a ``dict`` (children in sorted key order), a
``NamedTuple``, ``tuple`` or ``list`` (children in order) of trees; ``None``
is an empty subtree. This is the order ``jax.tree_util.tree_leaves`` gives
the same containers, so a training state ``(Variables, OptState)`` flattens
to the same leaf sequence in both packages: parameters by name, then state
by name, then the optimizer's step, then its slots by slot name and
parameter name. Checkpoints are written in that order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

__all__ = ["leaves", "unflatten", "map_leaves"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, in ``jax.tree_util.tree_leaves`` order."""
    out: List[Any] = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        else:
            out.append(node)

    walk(tree)
    return out


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` (in
    :func:`leaves` order)."""
    it: Iterator[Any] = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(c) for c in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])
