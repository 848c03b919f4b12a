"""PyTorch/CUDA port of the speculative classification-tree evaluator.

Mirrors the module tree of the JAX package ``repro`` (the reference it is
tested against) without importing it: ``core`` holds the encodings and the
plain tensor evaluators, ``data`` the paper's dataset twin,
``kernels.tree_eval`` the hand-written CUDA kernels for Hopper, ``tune`` and
``serve`` the autotuned serving path, ``dist`` (over ``parallel``'s
device grids) the sharded and streamed forest evaluation, ``configs``
and ``models`` the LM whose tree-routed MoE ``serve.ServeEngine`` serves,
and ``utils.losses``, ``optim``, ``train``, ``ckpt`` and ``data.pipeline``
its training path.
Entry points run on the card unless the caller passes ``device="cpu"``
(``devices=("cpu",)`` for a grid) or CPU tensors.
"""
