"""codeqwen1.5-7b — qwen1.5-arch dense decoder (full MHA, kv=32).

[hf:Qwen/CodeQwen1.5-7B; hf]  32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=512,
    dtype="float32",
)
