"""Nested dict / list trees of tensors (the reference's pytrees).

Leaves come in JAX's order: dict keys sorted, list and tuple items in
order. :func:`map` walks the first tree; each further tree must have the
first's structure down to its leaves, where it may hold a whole subtree
(JAX's prefix rule: the optimizer's per-leaf state dicts ride along).
"""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def paths(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in JAX's order, the path's parts joined by "/"."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def map(fn, tree, *rest):  # noqa: A001  (the tree map, as jax.tree.map)
    """``fn`` over the leaves of ``tree`` (and the matching nodes of
    ``rest``), in a new tree of the same structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """``tree``'s structure with its leaves replaced by ``new_leaves`` (in
    :func:`leaves` order)."""
    it = iter(new_leaves)
    return map(lambda _: next(it), _sorted(tree))


def _sorted(tree):
    """The same tree with every dict's keys in sorted order, so that
    :func:`map` visits leaves in :func:`leaves` order."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree
