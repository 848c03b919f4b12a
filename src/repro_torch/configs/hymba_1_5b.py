"""hymba-1.5b — hybrid parallel attention + Mamba heads, sliding windows.

[arXiv:2411.13676; hf]  32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001,
ssm_state=16.  Sliding-window attention (1024) with 3 global-attention layers
(first/middle/last, per the Hymba paper); the SSM side runs in parallel with
attention in every block and the outputs are averaged.  Sub-quadratic →
eligible for long_500k.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
)

SMOKE = ModelConfig(
    name="hymba-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    dtype="float32",
    sliding_window=8,
    global_attn_layers=(0, 2),
    ssm=SSMConfig(state_dim=4, conv_width=4, expand=2),
)
