"""The decoder's layers: RoPE, MLP and RMSNorm, attention, and the MoE block
with its tree router."""
