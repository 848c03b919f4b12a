"""granite-moe-3b-a800m — 40-expert top-8 fine-grained MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, 40e top-8.
Tree-router integration: 40 experts under a depth-6 tree (64 leaves, leaf ℓ
→ expert ℓ mod 40); on the serving path each token takes the tree's expert
and the 7 after it (mod 40), gates 1/8 (``models/layers/moe.py``).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff=512, router="tree", router_tree_depth=6),
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=48,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    dtype="float32",
    moe=MoEConfig(n_experts=5, top_k=3, d_ff=64, router="tree", router_tree_depth=3,
                  capacity_factor=8.0),
)
