"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE with GQA.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=6400/expert vocab=32064, 16e top-2.
Primary integration target for the paper's tree router (depth-4 tree over 16
experts, speculative branchless evaluation on the serving path).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400, router="tree"),
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, router="tree", capacity_factor=8.0),
)
