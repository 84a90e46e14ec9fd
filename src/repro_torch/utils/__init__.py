from repro_torch.utils.tree import (
    tree_paths,
    path_str,
    map_with_path,
    mask_by_path,
    tree_size,
    tree_bytes,
    merge_trees,
    select_tree,
    tree_allfinite,
    tree_zeros_like,
    tree_add,
    tree_scale,
    tree_weighted_sum,
    tree_l2_distance,
)
from repro_torch.utils.prng import key_iter, fold_in_str
from repro_torch.utils.flops import matmul_flops, dense_model_flops

__all__ = [
    "tree_paths",
    "path_str",
    "map_with_path",
    "mask_by_path",
    "tree_size",
    "tree_bytes",
    "merge_trees",
    "select_tree",
    "tree_allfinite",
    "tree_zeros_like",
    "tree_add",
    "tree_scale",
    "tree_weighted_sum",
    "tree_l2_distance",
    "key_iter",
    "fold_in_str",
    "matmul_flops",
    "dense_model_flops",
]
