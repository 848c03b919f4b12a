"""The paper's own experiment configuration (§4).

The port's copy of the JAX package's ``configs/paper_segmentation.py``.
UCI Image Segmentation: 19 continuous attributes, 7 classes, 2310 train +
2099 test records; tree N=31 nodes / 16 leaves / depth 11; dataset replicated
to 65 536 records (a 256×256 image).  No download is made:
``data/segmentation.py`` generates a statistically matched synthetic twin
with identical shapes and cardinalities.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperExperimentConfig:
    n_attrs: int = 19
    n_classes: int = 7
    n_train: int = 2310
    n_test: int = 2099
    dataset_records: int = 65_536          # 256×256 "image"
    tree_nodes: int = 31
    tree_leaves: int = 16
    tree_depth: int = 11
    n_timing_iters: int = 500
    jumps_per_round: int = 2               # paper: 2 reductions/loop optimal
    record_group: int = 16                 # paper: p=16 (half-warp)


CONFIG = PaperExperimentConfig()
