from repro_torch.utils.tree import (
    tree_add,
    tree_axpy,
    tree_dot,
    tree_l2_norm,
    tree_lerp,
    tree_map,
    tree_scale,
    tree_sub,
    tree_zeros_like,
)

__all__ = [
    "tree_add",
    "tree_axpy",
    "tree_dot",
    "tree_l2_norm",
    "tree_lerp",
    "tree_map",
    "tree_scale",
    "tree_sub",
    "tree_zeros_like",
]
