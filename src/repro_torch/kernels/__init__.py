"""Hand-written CUDA kernels of the port, built from ``csrc/`` at first use."""
