"""qwen2-vl-72b — VLM backbone with M-RoPE (vision frontend stubbed).

[arXiv:2409.12191; hf]  80L d_model=8192 64H (kv=8) d_ff=29568 vocab=152064.
``input_specs`` provides precomputed patch/text embeddings plus (B, 3, S)
M-RoPE position streams (temporal/height/width) — the ViT frontend and
dynamic-resolution packer are stubs per the assignment.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_style="mrope",
    mrope_sections=(16, 24, 24),
    embeds_input=True,
)

SMOKE = ModelConfig(
    name="qwen2vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
    rope_style="mrope",
    mrope_sections=(4, 2, 2),
    embeds_input=True,
)
