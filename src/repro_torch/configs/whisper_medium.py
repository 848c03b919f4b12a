"""whisper-medium — encoder-decoder audio backbone (conv frontend stubbed).

[arXiv:2212.04356; unverified]
24L (enc) + 24L (dec), d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
``input_specs`` provides precomputed frame embeddings (B, 1500, 1024) — the
mel-spectrogram conv stack is a stub per the assignment.
"""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    rope_style="none",
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    dtype="float32",
    act="gelu",
    rope_style="none",
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=2, n_frames=24),
)
