"""Pytree helpers over nested dicts of tensors.

The port's models keep their parameters and non-trainable state as nested
dicts (ResNet-18's ``{"s0b0": {"bn1": {"scale": ...}}}``).  Leaves come in
``jax.tree_util``'s order for dicts: keys sorted at every level, so a
flat row (:class:`repro_torch.core.flatbuf.PytreeCodec`) is element for
element the reference's.  Keys sort as strings: VGG-16's ``c0..c12`` come
as ``c0, c1, c10, c11, c12, c2, ...``.  A tuple is a node whose
children come in their own order, as ``jax.tree_util`` takes it (the
training launcher checkpoints ``(params, opt_state)``).  An empty dict has
no leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

Tree = Any  # a tensor, or a dict or tuple of trees


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of ``tree``, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_paths(tree: Tree, prefix: str = "") -> List[str]:
    """Each leaf's key path, ``/``-joined, in :func:`tree_leaves` order
    (a flat dict's paths are its keys)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple):
        return [p for i, t in enumerate(tree)
                for p in tree_paths(t, f"{prefix}{i}/")]
    return [prefix[:-1]]


def tree_structure(tree: Tree) -> Tree:
    """The tree with every leaf replaced by None (the treedef)."""
    if isinstance(tree, dict):
        return {k: tree_structure(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_structure(t) for t in tree)
    return None


def tree_flatten(tree: Tree) -> Tuple[List[torch.Tensor], Tree]:
    """(leaves, treedef): :func:`tree_leaves` and :func:`tree_structure`."""
    return tree_leaves(tree), tree_structure(tree)


def tree_unflatten(treedef: Tree, leaves: Sequence) -> Tree:
    """Inverse of :func:`tree_flatten`: ``leaves`` in sorted-key order
    back into ``treedef``'s dicts."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple):
            return tuple(build(n) for n in node)
        return next(it)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_stack(trees: Sequence[Tree]) -> Tree:
    """K trees of one structure -> one tree of (K, ...) leaves."""
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def is_empty(tree: Tree) -> bool:
    """True iff ``tree`` has no leaves (``{}``, a model without state)."""
    return not tree_leaves(tree)
