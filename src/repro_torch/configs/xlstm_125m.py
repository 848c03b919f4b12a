"""xlstm-125m — sLSTM + mLSTM block stack (1:3 ratio).

[arXiv:2405.04517; unverified]  12L d_model=768 4H d_ff=0 vocab=50304.
Recurrent decode state is O(1) in sequence length → eligible for long_500k.
"""

from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    rope_style="none",
    xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0, conv_width=4),
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    dtype="float32",
    rope_style="none",
    xlstm=XLSTMConfig(slstm_every=4, proj_factor=2.0, conv_width=4),
)
