from repro_torch.data.pipeline import (
    DataConfig, SyntheticEncDec, SyntheticLM, SyntheticVLM, pipeline_for,
)
from repro_torch.data.segmentation import SegmentationData, make_segmentation, replicated_dataset

__all__ = ["DataConfig", "SegmentationData", "SyntheticEncDec", "SyntheticLM", "SyntheticVLM",
           "make_segmentation", "pipeline_for", "replicated_dataset"]
