"""yi-6b — llama-arch dense decoder with aggressive GQA (kv=4).

[arXiv:2403.04652; hf]  32L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
)

SMOKE = ModelConfig(
    name="yi-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    dtype="float32",
)
