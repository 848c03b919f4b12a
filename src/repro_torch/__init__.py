"""PyTorch/CUDA port of the speculative classification-tree evaluator.

Mirrors the module tree of the JAX package ``repro`` (the reference it is
tested against) without importing it: ``core`` holds the encodings and the
plain tensor evaluators, ``data`` the paper's dataset twin, and
``kernels.tree_eval`` the hand-written CUDA kernels for Hopper.  Entry points
run on the card unless the caller passes ``device="cpu"`` or CPU tensors.
"""
