"""Quickstart on the PyTorch port: the paper's full pipeline.

1. Generate the UCI-Image-Segmentation synthetic twin (19 attrs, 7 classes).
2. Train a CART classifier (the substrate the paper got from Orange).
3. Encode it breadth-first + branchless (Procedure 1).
4. Evaluate 4,096 of 65 536 records with all three algorithms — serial (P2),
   data-parallel (P3), speculative (P4/5) — plus the hand-written CUDA
   kernels (K1 speculative, K2 data-parallel; their plain versions on the
   host), verifying they agree exactly.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The evaluators run on the card unless ``--device cpu`` is given.
"""

import argparse
import time

import numpy as np

from repro_torch import _device
from repro_torch.core import (
    CartConfig, accuracy, breadth_first_encode, eval_serial,
    eval_data_parallel_tree, eval_speculative_tree, train_cart, tree_depth,
)
from repro_torch.core.analysis import mean_traversal_depth, observed_depths
from repro_torch.data.segmentation import make_segmentation, replicated_dataset
from repro_torch.kernels.tree_eval import tree_eval


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the card by default; 'cpu' for the host")
    args = ap.parse_args()
    dev = _device.resolve(None, args.device)

    print("1) synthetic UCI Image Segmentation twin")
    data = make_segmentation(seed=0)
    print(f"   train {data.x_train.shape}, test {data.x_test.shape}")

    print("2) CART training (Gini, axis-aligned)")
    t0 = time.perf_counter()
    root = train_cart(data.x_train, data.y_train, 7,
                      CartConfig(max_depth=12, min_samples_split=8, min_gain=4e-3))
    enc = breadth_first_encode(root)
    print(f"   tree: N={enc.n_nodes} leaves={enc.n_leaves} depth={tree_depth(enc)} "
          f"({time.perf_counter()-t0:.1f}s)  "
          f"test acc={accuracy(eval_serial(enc, data.x_test), data.y_test):.3f}")

    print("3) replicate to 65 536 records (a 256x256 'image')")
    rec, _ = replicated_dataset(data)
    d_mu = mean_traversal_depth(observed_depths(enc, rec[:2048]))
    print(f"   mean traversal depth d_mu = {d_mu:.2f}")

    print(f"4) evaluate with every algorithm on {dev}")
    d = tree_depth(enc)
    ref = eval_serial(enc, rec[:4096])
    outs = {
        "P3 data-parallel": eval_data_parallel_tree(enc, rec[:4096], max_depth=d, device=dev),
        "P4/5 speculative": eval_speculative_tree(enc, rec[:4096], max_depth=d, device=dev),
        "P4/5 spec (one-hot matmul)": eval_speculative_tree(
            enc, rec[:4096], max_depth=d, use_onehot_matmul=True, device=dev),
        "CUDA speculative kernel (K1)": tree_eval(rec[:4096], enc, algorithm="speculative", device=dev),
        "CUDA data-parallel kernel (K2)": tree_eval(rec[:4096], enc, algorithm="data_parallel", device=dev),
    }
    for name, out in outs.items():
        ok = np.array_equal(out.cpu().numpy(), ref)
        print(f"   {name:32s} {'EXACT MATCH' if ok else 'MISMATCH!'}")
        if not ok:
            raise SystemExit(f"{name} disagrees with eval_serial")
    print("\nall evaluators agree — Procedures 1-5 verified end to end")


if __name__ == "__main__":
    main()
