"""Core paper contribution: branchless + speculative classification-tree evaluation.

Spencer (2011): Procedures 1–5 and the §3.6 analysis — numpy on the host for
the encodings, the serial oracle and CART; PyTorch for the evaluators.
"""

from repro_torch.core.tree import (
    BOTTOM,
    EncodedTree,
    Node,
    attr_select_matrix,
    breadth_first_encode,
    decode_to_linked,
    forest_of,
    leaf_paths,
    node_depths,
    pad_tree,
    paper_tree,
    perfect_tree,
    processor_node_map,
    random_tree,
    tree_depth,
    validate_encoding,
)
from repro_torch.core.eval_serial import eval_serial, eval_serial_vectorized_host
from repro_torch.core.eval_dataparallel import (
    eval_data_parallel,
    eval_data_parallel_tree,
    shard_eval_data_parallel,
)
from repro_torch.core.eval_speculative import (
    eval_speculative,
    eval_speculative_tree,
    pointer_jump,
    rounds_for_depth,
    sanitize_records,
    shard_eval_speculative,
    speculative_node_eval,
)
from repro_torch.core.cart import CartConfig, accuracy, train_cart
from repro_torch.core.forest import (
    EncodedForest,
    eval_forest,
    eval_forest_cascade,
    eval_forest_sharded,
    eval_forest_tuned,
    majority_vote,
    route_topk,
    vote_counts,
    vote_winner,
)
from repro_torch.core.soft_tree import (
    SoftTreeConfig,
    SoftTreeParams,
    harden,
    init_soft_tree,
    leaf_probs,
    load_balance_loss,
    output_probs,
)
from repro_torch.core.windowed import eval_windowed, level_offsets
from repro_torch.core import analysis

__all__ = [
    "BOTTOM",
    "EncodedTree",
    "Node",
    "attr_select_matrix",
    "breadth_first_encode",
    "decode_to_linked",
    "forest_of",
    "leaf_paths",
    "node_depths",
    "pad_tree",
    "paper_tree",
    "perfect_tree",
    "processor_node_map",
    "random_tree",
    "tree_depth",
    "validate_encoding",
    "eval_serial",
    "eval_serial_vectorized_host",
    "eval_data_parallel",
    "eval_data_parallel_tree",
    "shard_eval_data_parallel",
    "eval_speculative",
    "eval_speculative_tree",
    "pointer_jump",
    "rounds_for_depth",
    "sanitize_records",
    "shard_eval_speculative",
    "speculative_node_eval",
    "CartConfig",
    "accuracy",
    "train_cart",
    "EncodedForest",
    "eval_forest",
    "eval_forest_cascade",
    "eval_forest_sharded",
    "eval_forest_tuned",
    "majority_vote",
    "route_topk",
    "vote_counts",
    "vote_winner",
    "SoftTreeConfig",
    "SoftTreeParams",
    "harden",
    "init_soft_tree",
    "leaf_probs",
    "load_balance_loss",
    "output_probs",
    "eval_windowed",
    "level_offsets",
    "analysis",
]
