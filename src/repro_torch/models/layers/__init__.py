"""The models' layers: RoPE, MLP and RMSNorm, attention (self and cross), the
MoE block with its tree router, the SSM and xLSTM blocks, and the tree
token head."""
