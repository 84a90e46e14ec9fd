"""Parameter and cache trees: nested dicts (and tuples) of tensors.

The port keeps the reference's tree layout (``{"conv1": {"w", "b"}, ...}``;
the recurrent decode caches hold tuples, as the mLSTM carry ``(C, n, m)``)
and keeps the reference's helpers over it (``repro.utils.tree``), as
functions of dict/tuple trees of tensors; ``tree_weighted_sum`` is the
FedAvg primitive.  ``tree_paths`` and ``mask_by_path`` walk a tree in the
reference's order (a dict's keys sorted, as jax flattens them; ``None``
holds no leaf), so their paths are the reference's for the same tree.
An axes tree (``Model.axes``) mirrors a params tree with tuples of logical axis
names for leaves (``axes_leaf``); ``axes_map`` walks the two side by
side.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Iterator

import torch

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


# ---------------------------------------- the reference's path utilities --

def path_str(path) -> str:
    """Render a key path (the dict keys and sequence indices from the root
    to a leaf, as :func:`tree_paths` walks them) as 'a/b/0/c', as the
    reference renders a jax key path."""
    return "/".join(str(p) for p in path)


def _key_paths(tree: PyTree, is_leaf: Callable[[Any], bool] | None = None,
               path: tuple = ()) -> Iterator:
    """(key path, leaf) pairs in jax's flattening order: a dict's keys
    sorted, tuples and lists in order, ``None`` an empty subtree, and a
    node for which ``is_leaf`` holds taken whole."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _key_paths(tree[k], is_leaf, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _key_paths(t, is_leaf, path + (i,))
    elif tree is not None:
        yield path, tree


def tree_paths(tree: PyTree,
               is_leaf: Callable[[Any], bool] | None = None) -> list[str]:
    """Every leaf's '/'-joined path, in the reference's order."""
    return [path_str(p) for p, _ in _key_paths(tree, is_leaf)]


def _map_key_paths(fn: Callable, tree: PyTree, *rest: PyTree,
                   is_leaf=None, path: tuple = ()) -> PyTree:
    """``fn(key path, leaf, *the other trees' leaves)`` over trees of
    ``tree``'s structure, as jax maps them: dicts, tuples and lists are
    nodes, ``None`` an empty subtree kept as ``None``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_key_paths(fn, tree[k], *(r[k] for r in rest),
                                  is_leaf=is_leaf, path=path + (k,))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_key_paths(fn, t, *(r[i] for r in rest),
                                         is_leaf=is_leaf, path=path + (i,))
                          for i, t in enumerate(tree))
    return None if tree is None else fn(path, tree, *rest)


def mask_by_path(tree: PyTree, patterns: list[str],
                 is_leaf: Callable[[Any], bool] | None = None) -> PyTree:
    """Boolean mask tree: True where the leaf path matches any regex
    pattern."""
    regs = [re.compile(p) for p in patterns]
    return _map_key_paths(
        lambda path, _: any(r.search(path_str(path)) for r in regs), tree,
        is_leaf=is_leaf)


def tree_size(tree: PyTree) -> int:
    """Elements over every leaf."""
    return sum(math.prod(x.shape) for _, x in _key_paths(tree))


def tree_bytes(tree: PyTree) -> int:
    """Bytes over every leaf."""
    return sum(math.prod(x.shape) * x.dtype.itemsize
               for _, x in _key_paths(tree))


def merge_trees(mask: PyTree, a: PyTree, b: PyTree) -> PyTree:
    """Select leaf from ``a`` where mask is True else from ``b``."""
    return _map_key_paths(lambda _, m, x, y: x if m else y, mask, a, b)


def select_tree(mask: PyTree, tree: PyTree) -> PyTree:
    """The tree's structure with the leaves where mask is False set to
    None; useful for reporting."""
    return _map_key_paths(lambda _, m, x: x if m else None, mask, tree)


def tree_allfinite(tree: PyTree) -> torch.Tensor:
    """A 0-d bool tensor: every floating leaf holds only finite values
    (True for a tree without one)."""
    leaves = [torch.as_tensor(x) for _, x in _key_paths(tree)]
    finite = [torch.isfinite(t).all() for t in leaves
              if t.is_floating_point()]
    if not finite:
        return torch.tensor(True)
    return torch.stack(finite).all()


def tree_zeros_like(tree: PyTree) -> PyTree:
    return _map_key_paths(lambda _, x: torch.zeros_like(x), tree)


def tree_l2_distance(a: PyTree, b: PyTree) -> torch.Tensor:
    """||a - b||_2 over every leaf, the squares summed in float32 leaf by
    leaf in the reference's order."""
    sq = [torch.sum((x.float() - y.float()) ** 2)
          for (_, x), (_, y) in zip(_key_paths(a), _key_paths(b))]
    return torch.sqrt(sum(sq))
