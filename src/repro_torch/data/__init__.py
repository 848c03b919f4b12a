from repro_torch.data.segmentation import SegmentationData, make_segmentation, replicated_dataset

__all__ = ["SegmentationData", "make_segmentation", "replicated_dataset"]
