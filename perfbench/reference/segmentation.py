"""Synthetic twin of UCI Image Segmentation and the paper's §4.1 frames.

No download is possible, so the data set is a statistically matched stand-in
with the real set's shapes and cardinalities: 19 continuous attributes, 7
classes, 2,310 training and 2,099 test records, each class a Gaussian mixture
over five correlated attribute groups.  ``make_segmentation(0)`` draws the
same records, bit for bit, as the data module the repository's trees were
trained on.

A frame is the paper's timing workload: the 4,409 train + test records
combined, permuted again and again and tiled to 65,536 rows (a 256×256
image).  Frames are index arrays into those base records, so every record
of a frame is a copy of a base record.
"""

from __future__ import annotations

import numpy as np

N_ATTRS = 19
N_CLASSES = 7
N_TRAIN = 2310
N_TEST = 2099


def make_segmentation(seed: int = 0):
    """(x_train, y_train, x_test, y_test): float32 (·, 19) and int32 labels."""
    rng = np.random.default_rng(seed)
    groups = [slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16), slice(16, 19)]
    total = N_TRAIN + N_TEST
    per = np.full((N_CLASSES,), total // N_CLASSES)
    per[: total % N_CLASSES] += 1
    xs, ys = [], []
    for c in range(N_CLASSES):
        n = per[c]
        x = np.zeros((n, N_ATTRS))
        for g in groups:
            width = g.stop - g.start
            mean = rng.normal(0, 2.0, size=(width,))
            base = rng.normal(size=(n, 1))
            x[:, g] = mean + base + 0.6 * rng.normal(size=(n, width))
        xs.append(x)
        ys.append(np.full((n,), c))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys).astype(np.int32)
    perm = rng.permutation(total)
    x, y = x[perm], y[perm]
    return x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:], y[N_TRAIN:]


def base_records(seed: int = 0) -> np.ndarray:
    """The 4,409 train + test records every frame is tiled from, (4409, 19) float32."""
    x_train, _, x_test, _ = make_segmentation(seed)
    return np.concatenate([x_train, x_test])


def frame_indices(rng: np.random.Generator, n_base: int, n_frames: int,
                  frame_records: int) -> np.ndarray:
    """§4.1 tiling: each frame is successive permutations of the base records,
    cut at ``frame_records`` rows.  Returns int32 (n_frames, frame_records)."""
    reps = -(-frame_records // n_base)
    keys = np.broadcast_to(np.arange(n_base, dtype=np.int32), (n_frames * reps, n_base))
    perms = rng.permuted(keys, axis=1)
    return np.ascontiguousarray(perms.reshape(n_frames, reps * n_base)[:, :frame_records])
