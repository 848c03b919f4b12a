"""CUDA kernels K1–K4 for the paper's tree-evaluation hot spot."""

from repro_torch.kernels.tree_eval.ops import (
    FOREST_VARIANTS,
    VARIANTS,
    ForestVariantSpec,
    PackedForest,
    PackedTree,
    VariantSpec,
    choose_block_m,
    forest_eval,
    forest_eval_fused,
    get_forest_variant,
    get_variant,
    list_forest_variants,
    list_variants,
    register_forest_variant,
    register_variant,
    tree_eval,
)
from repro_torch.kernels.tree_eval.ref import forest_eval_ref, tree_eval_ref

__all__ = [
    "FOREST_VARIANTS",
    "ForestVariantSpec",
    "PackedForest",
    "PackedTree",
    "VARIANTS",
    "VariantSpec",
    "choose_block_m",
    "forest_eval",
    "forest_eval_fused",
    "forest_eval_ref",
    "get_forest_variant",
    "get_variant",
    "list_forest_variants",
    "list_variants",
    "register_forest_variant",
    "register_variant",
    "tree_eval",
    "tree_eval_ref",
]
