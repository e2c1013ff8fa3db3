"""The data pipeline's transforms, registered under the JAX package's names
(scflow_tpu/datasets/pipelines): those of the test workflow.  The train
workflow's PoseJitter, colour augmentations and ProjectKeypoints are not
ported yet, so a config naming them raises KeyError where the dataset is
built."""

from scflow_tpu_torch.datasets.pipelines.formatting import Collect, Compose, Normalize, ToArray
from scflow_tpu_torch.datasets.pipelines.geometry import ComputeBbox, Crop, Pad, RemapPose, Resize
from scflow_tpu_torch.datasets.pipelines.loading import LoadImages, LoadMasks

__all__ = ["Collect", "Compose", "Normalize", "ToArray", "ComputeBbox", "Crop", "Pad",
           "RemapPose", "Resize", "LoadImages", "LoadMasks"]
