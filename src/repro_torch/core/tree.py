"""Classification-tree structures and the branchless breadth-first encoding.

Implements Procedure 1 of Spencer (2011), *Speculative Parallel Evaluation of
Classification Trees on GPGPU Compute Engines*:

    The tree is stored as a flat array in breadth-first order.  Every right
    child has index ``leftChild + 1`` so each node stores a single
    ``childIndex`` and the next node during evaluation is computed without a
    branch as ``next = childIndex + (r_a > t)``.

Leaf encoding
-------------
The paper states leaves "always evaluate to themselves by setting their
threshold to -inf and their child index to be their own index".  With the
paper's strict ``>`` predicate a ``-inf`` threshold would yield
``next = self + 1``; the self-loop requires the predicate to be *false*, so we
encode leaf thresholds as ``+inf`` (an erratum-level fix that preserves the
paper's intent: ``r_a > +inf`` is false for all finite/NaN attributes, hence
``next = childIndex + 0 = self``).  NaN attribute values compare false against
any threshold and therefore deterministically take the left branch, matching
IEEE semantics of the branchless predicate.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

BOTTOM = -1  # class sentinel for internal nodes (the paper's "⊥")


@dataclasses.dataclass
class Node:
    """A linked classification-tree node (pre-encoding).

    Internal nodes carry ``(attr, threshold)`` and two children; leaves carry
    ``class_val`` only.  Trees are *full* binary trees: every internal node
    has exactly two children (CART and the paper both guarantee this).
    """

    attr: int = 0
    threshold: float = 0.0
    left: Optional["Node"] = None
    right: Optional["Node"] = None
    class_val: int = BOTTOM

    @property
    def is_leaf(self) -> bool:
        return self.left is None and self.right is None

    def validate(self) -> None:
        if self.is_leaf:
            if self.class_val == BOTTOM:
                raise ValueError("leaf node missing class value")
        else:
            if self.left is None or self.right is None:
                raise ValueError("internal node must have both children (full binary tree)")
            if self.class_val != BOTTOM:
                raise ValueError("internal node must have class ⊥")
            self.left.validate()
            self.right.validate()

    def depth(self) -> int:
        """Depth in *edges* on the longest root→leaf path (single leaf = 0)."""
        if self.is_leaf:
            return 0
        return 1 + max(self.left.depth(), self.right.depth())

    def count_nodes(self) -> int:
        if self.is_leaf:
            return 1
        return 1 + self.left.count_nodes() + self.right.count_nodes()

    def count_leaves(self) -> int:
        if self.is_leaf:
            return 1
        return self.left.count_leaves() + self.right.count_leaves()

    def iter_breadth_first(self) -> Iterator["Node"]:
        q: deque[Node] = deque([self])
        while q:
            n = q.popleft()
            yield n
            if not n.is_leaf:
                q.append(n.left)
                q.append(n.right)


class EncodedTree(NamedTuple):
    """Branchless breadth-first array encoding (Procedure 1).

    All fields are dense arrays of length ``n_nodes`` (padded length when a
    kernel requires lane alignment — padding nodes are self-looping leaves
    with ``class_val = 0`` that are unreachable from the root).

    attr_idx:  int32 (N,)  attribute index evaluated by node ``i``
    threshold: float32 (N,)  decision threshold (``+inf`` for leaves)
    child:     int32 (N,)  left-child index; right child is ``child+1``;
               leaves store their own index (self-loop)
    class_val: int32 (N,)  assigned class for leaves, ``-1`` (⊥) for internal
    """

    attr_idx: np.ndarray
    threshold: np.ndarray
    child: np.ndarray
    class_val: np.ndarray

    @classmethod
    def from_arrays(cls, attr_idx, threshold, child, class_val) -> "EncodedTree":
        """Carry an encoding across from another package as numpy arrays.

        The four tables must be 1-D, of one length, and of the dtypes the
        kernels read (int32, float32, int32, int32); nothing is cast.
        """
        return cls(*_checked_tables((attr_idx, threshold, child, class_val), ndim=1))

    @property
    def n_nodes(self) -> int:
        return int(self.attr_idx.shape[-1])

    @property
    def is_leaf_mask(self) -> np.ndarray:
        return np.asarray(self.class_val) != BOTTOM

    @property
    def n_leaves(self) -> int:
        return int(self.is_leaf_mask.sum())

    @property
    def n_internal(self) -> int:
        return self.n_nodes - self.n_leaves


_TABLE_DTYPES = (np.int32, np.float32, np.int32, np.int32)
_TABLE_NAMES = ("attr_idx", "threshold", "child", "class_val")


def _checked_tables(tables, *, ndim: int) -> tuple[np.ndarray, ...]:
    """Validate (attr_idx, threshold, child, class_val) numpy tables."""
    out = []
    for name, want, arr in zip(_TABLE_NAMES, _TABLE_DTYPES, tables):
        if not isinstance(arr, np.ndarray):
            raise TypeError(f"{name} must be a numpy array, got {type(arr).__name__}")
        if arr.dtype != want:
            raise TypeError(f"{name} must be {np.dtype(want).name}, got {arr.dtype}")
        if arr.ndim != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {arr.shape}")
        out.append(arr)
    shapes = {a.shape for a in out}
    if len(shapes) != 1:
        raise ValueError(f"table shapes differ: {[a.shape for a in out]}")
    if out[0].shape[-1] == 0:
        raise ValueError("tables hold no nodes")
    return tuple(out)


def breadth_first_encode(root: Node) -> EncodedTree:
    """Procedure 1: breadth-first branchless encoding of a full binary tree."""
    root.validate()
    n_nodes = root.count_nodes()
    attr_idx = np.zeros((n_nodes,), np.int32)
    threshold = np.zeros((n_nodes,), np.float32)
    child = np.zeros((n_nodes,), np.int32)
    class_val = np.full((n_nodes,), BOTTOM, np.int32)

    # Procedure 1, with the queue carrying (node, my_index).
    q: deque[Node] = deque([root])
    child_index = 1
    i = 0
    while q:
        n = q.popleft()
        attr_idx[i] = n.attr
        if n.is_leaf:
            threshold[i] = np.inf  # predicate always false -> self-loop
            child[i] = i
            class_val[i] = n.class_val
        else:
            threshold[i] = n.threshold
            child[i] = child_index
            q.append(n.left)
            child_index += 1
            q.append(n.right)
            child_index += 1
        i += 1
    return EncodedTree(attr_idx, threshold, child, class_val)


def decode_to_linked(enc: EncodedTree) -> Node:
    """Inverse of :func:`breadth_first_encode` (for round-trip testing)."""
    leaf = enc.is_leaf_mask
    nodes = [Node() for _ in range(enc.n_nodes)]
    for i in range(enc.n_nodes):
        if leaf[i]:
            nodes[i].class_val = int(enc.class_val[i])
        else:
            nodes[i].attr = int(enc.attr_idx[i])
            nodes[i].threshold = float(enc.threshold[i])
            nodes[i].left = nodes[int(enc.child[i])]
            nodes[i].right = nodes[int(enc.child[i]) + 1]
    return nodes[0]


def tree_depth(enc: EncodedTree) -> int:
    """Longest root→leaf path (edges) from the encoded form."""
    depth = np.zeros((enc.n_nodes,), np.int64)
    best = 0
    # BFS order guarantees parents precede children.
    leaf = enc.is_leaf_mask
    for i in range(enc.n_nodes):
        if leaf[i]:
            best = max(best, int(depth[i]))
        else:
            c = int(enc.child[i])
            depth[c] = depth[i] + 1
            depth[c + 1] = depth[i] + 1
    return best


def node_depths(enc: EncodedTree) -> np.ndarray:
    """Per-node depth (root = 0)."""
    depth = np.zeros((enc.n_nodes,), np.int64)
    leaf = enc.is_leaf_mask
    for i in range(enc.n_nodes):
        if not leaf[i]:
            c = int(enc.child[i])
            depth[c] = depth[i] + 1
            depth[c + 1] = depth[i] + 1
    return depth


def validate_encoding(enc: EncodedTree) -> None:
    """Structural invariants of the breadth-first branchless encoding.

    Used by property tests: BFS order implies ``child[i] > i`` for internal
    nodes and children appear in increasing order; leaves self-loop with
    ``+inf`` thresholds; every non-root node has exactly one parent.
    """
    n = enc.n_nodes
    leaf = enc.is_leaf_mask
    indeg = np.zeros((n,), np.int64)
    for i in range(n):
        if leaf[i]:
            if enc.child[i] != i:
                raise ValueError(f"leaf {i} does not self-loop")
            if not np.isposinf(enc.threshold[i]):
                raise ValueError(f"leaf {i} threshold must be +inf")
            if enc.class_val[i] == BOTTOM:
                raise ValueError(f"leaf {i} missing class")
        else:
            c = int(enc.child[i])
            if not (i < c and c + 1 < n):
                raise ValueError(f"internal {i} child {c} violates BFS order")
            if enc.class_val[i] != BOTTOM:
                raise ValueError(f"internal {i} has class value")
            indeg[c] += 1
            indeg[c + 1] += 1
    if indeg[0] != 0:
        raise ValueError("root has a parent")
    bad = np.nonzero(indeg[1:] != 1)[0]
    if bad.size:
        raise ValueError(f"nodes {bad + 1} do not have exactly one parent")


def check_table_indices(attr_idx: np.ndarray, child: np.ndarray, class_val: np.ndarray, n_attrs: int):
    """Every index the kernels follow must land inside its table.

    The CUDA kernels index shared memory with ``attr_idx`` and ``child``
    unchecked, so every packing of tables for them calls this first.
    """
    n = child.shape[-1]
    child = np.asarray(child, np.int64)   # a narrow table's child + 1 must not wrap
    if ((attr_idx < 0) | (attr_idx >= n_attrs)).any():
        raise ValueError(f"attr_idx outside [0, {n_attrs})")
    internal = class_val == BOTTOM
    if ((child < 0) | (child + internal >= n)).any():
        raise ValueError(f"child index outside the {n}-node table")


# ---------------------------------------------------------------------------
# Procedure-5 support tables
# ---------------------------------------------------------------------------


def leaf_paths(enc: EncodedTree) -> np.ndarray:
    """Static ``path`` initialisation (Procedure 5 ``leafPaths``).

    Leaves map to themselves; internal entries are arbitrary (0) because the
    node-evaluation step overwrites them for every record.
    """
    n = enc.n_nodes
    out = np.zeros((n,), np.int32)
    leaf = enc.is_leaf_mask
    out[leaf] = np.nonzero(leaf)[0].astype(np.int32)
    return out


def processor_node_map(enc: EncodedTree) -> np.ndarray:
    """Procedure 5 ``processorNodeMap``: indices of the internal nodes.

    Processor ``p`` in a record group evaluates node ``processorNodeMap[p]``;
    only ``(N-1)/2`` processors (for a full tree) do productive work.
    """
    return np.nonzero(~enc.is_leaf_mask)[0].astype(np.int32)


def pad_tree(enc: EncodedTree, n_padded: int) -> EncodedTree:
    """Pad the node array to ``n_padded`` with unreachable self-loop leaves.

    Padding stacks trees of different sizes into one forest table.  The
    phantom nodes are leaves with class 0 that no internal node points to, so
    they never influence results — mirroring the paper's "phantom node" used
    to fill the 16-thread half-warp for a 15-internal-node tree.
    """
    n = enc.n_nodes
    if n_padded < n:
        raise ValueError(f"cannot pad {n} nodes down to {n_padded}")
    if n_padded == n:
        return enc
    pad = n_padded - n
    idx = np.arange(n, n_padded, dtype=np.int32)
    return EncodedTree(
        np.concatenate([enc.attr_idx, np.zeros((pad,), np.int32)]),
        np.concatenate([enc.threshold, np.full((pad,), np.inf, np.float32)]),
        np.concatenate([enc.child, idx]),
        np.concatenate([enc.class_val, np.zeros((pad,), np.int32)]),
    )


def attr_select_matrix(enc: EncodedTree, n_attrs: int, dtype=np.float32) -> np.ndarray:
    """One-hot attribute-selection matrix ``S[a, n] = 1 ⇔ attr_idx[n] == a``.

    The ``onehot`` form of the node-evaluation step reads attributes through
    it: ``vals[R, N] = records[R, A] @ S[A, N]`` puts node ``n``'s attribute
    value in column ``n`` (exact only on sanitized records, see
    ``eval_speculative.sanitize_records``).
    """
    out = np.zeros((n_attrs, enc.n_nodes), dtype)
    out[enc.attr_idx, np.arange(enc.n_nodes)] = 1
    return out


# ---------------------------------------------------------------------------
# Random tree generation (tests / geometry sweeps, paper §6 future work)
# ---------------------------------------------------------------------------


def random_tree(
    *,
    n_attrs: int,
    n_classes: int,
    max_depth: int,
    seed: int = 0,
    balance: float = 1.0,
    min_depth: int = 1,
) -> Node:
    """Generate a random full binary classification tree.

    ``balance`` in (0, 1]: probability that a node at depth < max_depth keeps
    splitting; 1.0 yields a perfect tree of depth ``max_depth``, small values
    yield shallow straggly trees (the paper's §6 geometry-sweep axis).
    """
    rng = np.random.default_rng(seed)

    def build(depth: int) -> Node:
        must_split = depth < min_depth
        may_split = depth < max_depth
        if may_split and (must_split or rng.random() < balance):
            return Node(
                attr=int(rng.integers(0, n_attrs)),
                threshold=float(np.round(rng.normal(), 4)),
                left=build(depth + 1),
                right=build(depth + 1),
            )
        return Node(class_val=int(rng.integers(0, n_classes)))

    root = build(0)
    if root.is_leaf:  # guarantee at least one split
        root = Node(
            attr=0,
            threshold=0.0,
            left=Node(class_val=0),
            right=Node(class_val=min(1, n_classes - 1)),
        )
    return root


def perfect_tree(depth: int, n_attrs: int, n_classes: int, seed: int = 0) -> Node:
    """A perfectly balanced tree of the given depth."""
    return random_tree(
        n_attrs=n_attrs,
        n_classes=n_classes,
        max_depth=depth,
        min_depth=depth,
        seed=seed,
        balance=1.0,
    )


def paper_tree(seed: int = 7) -> Node:
    """A tree with the same geometry class as the paper's experimental tree.

    The paper's Orange-trained classifier has N=31 nodes, 16 leaves and depth
    11 (an unbalanced full binary tree over 19 attributes and 7 classes).  We
    rebuild an equivalent-geometry tree deterministically: 15 internal nodes
    forming a depth-11 "vine with bushes" shape.
    """
    rng = np.random.default_rng(seed)

    def leaf() -> Node:
        return Node(class_val=int(rng.integers(0, 7)))

    def split(left: Node, right: Node) -> Node:
        return Node(
            attr=int(rng.integers(0, 19)),
            threshold=float(np.round(rng.normal(), 4)),
            left=left,
            right=right,
        )

    # Build a depth-11 spine of 11 internal nodes, then attach 4 more splits
    # along the upper spine to reach 15 internal / 16 leaves.
    node = split(leaf(), leaf())  # depth counted from here upward
    for _ in range(10):
        node = split(node, leaf())
    # node now: depth 11, 11 internal, 12 leaves. Add 4 splits on right leaves.
    for _ in range(4):
        cur = node
        while not cur.right.is_leaf:
            cur = cur.right
        cur.right = split(leaf(), leaf())
    assert node.count_nodes() == 31 and node.count_leaves() == 16
    assert node.depth() == 11
    return node


def forest_of(trees: Sequence[Node]) -> list[EncodedTree]:
    """Encode each tree of a forest breadth-first (Procedure 1)."""
    return [breadth_first_encode(t) for t in trees]
