"""Nested dict / list trees of tensors: the port's stand-in for the few
``jax.tree_util`` calls the training path makes.  A tree is a dict
(keys visited in sorted order, as ``jax.tree_util`` flattens a dict), a
list or tuple (visited in order), or a leaf."""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{"/"-joined key path: leaf}, in ``jax.tree_util``'s leaf order
    (``repro.checkpoint.serialization._flatten_with_paths``'s keys)."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(paths(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(paths(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def leaves(tree) -> List[Any]:
    return list(paths(tree).values())


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; the leaves are visited in
    ``leaves``' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(template, flat: List[Any]):
    """A tree shaped like ``template`` whose leaves are ``flat``, given
    in ``leaves(template)``'s order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), template)
