"""The benchmark's plain reference, in NumPy.

It stands apart from the program under test: it imports neither the JAX
package nor the PyTorch port, and takes nothing the program made.  The
harness trains the trees with it, hands the same node arrays and records to
the program and to this reference, and judges the program's classes by it.

- ``segmentation``: the synthetic twin of UCI Image Segmentation (19
  attributes, 7 classes, 2,310 train + 2,099 test records) and the paper's
  §4.1 tiling of its records into 65,536-record frames.
- ``cart``: the CART trainer (Gini, axis-aligned thresholds), bagging, and
  Procedure 1's breadth-first encoding.
- ``descend``: serial descent by Procedure 2's rules (NaN goes left, leaves
  self-loop on a ``+inf`` threshold), the majority vote (ties to the lowest
  class), and bfloat16 rounding for the lower-precision control.
"""
