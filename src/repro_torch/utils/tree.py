"""Parameter and cache trees: nested dicts (and tuples) of tensors.

The port keeps the reference's tree layout (``{"conv1": {"w", "b"}, ...}``;
the recurrent decode caches hold tuples, as the mLSTM carry ``(C, n, m)``)
and needs only a few helpers over it; ``tree_weighted_sum`` is a copy of
``repro.utils.tree.tree_weighted_sum`` (the FedAvg primitive).  An axes
tree (``Model.axes``) mirrors a params tree with tuples of logical axis
names for leaves (``axes_leaf``); ``axes_map`` walks the two side by
side.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

PyTree = Any


def axes_leaf(x: Any) -> bool:
    """A leaf of an axes tree: a tuple of logical axis names (str or
    None), one per dim of the parameter it describes."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over dict/tuple trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: PyTree, prefix: str = "") -> Iterator:
    """(path, leaf) pairs; paths read like ``jax.tree_util.keystr``
    (``['conv1']['w']``, ``['carry'][0]``), so a leaf's name is the same on
    both sides."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from tree_leaves_with_path(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def path_leaves(tree: PyTree, prefix: str = "") -> Iterator:
    """(path, leaf) pairs with '/'-joined paths (``a/b/0/c``), as the
    reference's ``repro.utils.tree.path_str`` renders a key path: the
    names the split patterns match and the checkpoint keys."""
    if isinstance(tree, dict):
        for k in tree:
            yield from path_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from path_leaves(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def map_with_path(fn: Callable, tree: PyTree, prefix: str = "") -> PyTree:
    """``tree_map`` where ``fn`` receives ('/'-joined path, leaf)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], f"{prefix}{k}/")
                for k in tree}
    if isinstance(tree, tuple):
        return tuple(map_with_path(fn, t, f"{prefix}{i}/")
                     for i, t in enumerate(tree))
    return fn(prefix[:-1], tree)


def axes_map(fn: Callable, params: PyTree, axes: PyTree) -> PyTree:
    """``fn(leaf, axes_leaf)`` over a params tree and its axes tree,
    matched by key: a params dict and its axes dict must hold the same
    keys, and each tensor meets its tuple of axis names."""
    if isinstance(params, dict):
        if not isinstance(axes, dict) or set(params) != set(axes):
            got = axes if axes_leaf(axes) else sorted(axes)
            raise ValueError(f"params/axes trees disagree: {sorted(params)}"
                             f" vs {got}")
        return {k: axes_map(fn, params[k], axes[k]) for k in params}
    if not axes_leaf(axes):
        raise ValueError(f"params leaf meets axes subtree {axes!r}")
    return fn(params, axes)


def tree_leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_weighted_sum(trees: list[PyTree], weights) -> PyTree:
    """sum_i weights[i] * trees[i]  (the FedAvg aggregation primitive)."""
    assert len(trees) == len(weights) and trees, "need >=1 tree"
    out = tree_scale(trees[0], weights[0])
    for t, w in zip(trees[1:], weights[1:]):
        out = tree_add(out, tree_scale(t, w))
    return out
