"""The paper's own application as an on-line service, on the PyTorch port:
real-time image segmentation with the speculative tree evaluator.

Simulates the paper's procedure-room workload: a stream of 256×256 "images"
(65 536 pixel records each) classified on-line; reports per-image latency
with the speculative evaluator (``core.eval_speculative``, one-hot node
evaluation) — the paper's deterministic-latency argument (§3.3: "uniform
evaluation times needed in deterministic, real-time applications") shows
up as the tight min/max spread.

    PYTHONPATH=src python examples/segmentation_service_torch.py --images 5 [--device cpu]

Classifies on the card unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core import CartConfig, breadth_first_encode, train_cart, tree_depth
from repro_torch.core.eval_speculative import eval_speculative
from repro_torch.data.segmentation import make_segmentation, replicated_dataset


def classifier(enc, dev: torch.device):
    """``classify(image) -> classes``: numpy records in (H2D), the speculative
    evaluator with one-hot node evaluation on ``dev``, numpy classes out (D2H)."""
    d = tree_depth(enc)
    tree_args = (torch.from_numpy(enc.attr_idx).to(dev), torch.from_numpy(enc.threshold).to(dev),
                 torch.from_numpy(enc.child).to(dev), torch.from_numpy(enc.class_val).to(dev))
    return lambda r: eval_speculative(r, *tree_args, max_depth=d, jumps_per_round=2, use_onehot_matmul=True,
                                      device=dev).cpu().numpy()


def trained_tree(data):
    root = train_cart(data.x_train, data.y_train, 7,
                      CartConfig(max_depth=12, min_samples_split=8, min_gain=4e-3))
    return breadth_first_encode(root)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=5)
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' for the host")
    args = ap.parse_args()
    dev = _device.resolve(None, args.device)

    data = make_segmentation(seed=0)
    enc = trained_tree(data)
    print(f"classifier: N={enc.n_nodes} depth={tree_depth(enc)} (trained offline, as in the paper); on {dev}")
    classify = classifier(enc, dev)

    lat = []
    for i in range(args.images):
        img, _ = replicated_dataset(data, 65_536, seed=i + 1)
        t0 = time.perf_counter()
        classes = classify(img)   # H2D + eval + D2H
        lat.append((time.perf_counter() - t0) * 1e3)
        hist = np.bincount(classes, minlength=7)
        print(f"image {i}: {lat[-1]:7.2f} ms  class histogram {hist.tolist()}")
    a = np.asarray(lat[1:]) if len(lat) > 1 else np.asarray(lat)
    print(f"\nsteady-state latency: mean {a.mean():.2f} ms  "
          f"min {a.min():.2f}  max {a.max():.2f}  "
          f"(spread {(a.max()-a.min())/a.mean()*100:.1f}% — the paper's "
          f"time-uniformity argument)")


if __name__ == "__main__":
    main()
