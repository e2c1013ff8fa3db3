"""The data pipeline's transforms, registered under the JAX package's names
(scflow_tpu/datasets/pipelines): those of the test workflow, of the shipped
train pipeline (PoseJitter, RandomHSV, RandomNoise, RandomSmooth,
ProjectKeypoints) and the rest of the JAX package's colour transforms
(RandomSharpness, RandomGray, RandomBackground, RandomOcclusion,
RandomOcclusionV2)."""

from scflow_tpu_torch.datasets.pipelines.color import (RandomBackground, RandomGray, RandomHSV,
                                                       RandomNoise, RandomOcclusion,
                                                       RandomOcclusionV2, RandomSharpness,
                                                       RandomSmooth)
from scflow_tpu_torch.datasets.pipelines.formatting import Collect, Compose, Normalize, ToArray
from scflow_tpu_torch.datasets.pipelines.geometry import (ComputeBbox, Crop, Pad,
                                                          ProjectKeypoints, RemapPose, Resize)
from scflow_tpu_torch.datasets.pipelines.jitter import PoseJitter
from scflow_tpu_torch.datasets.pipelines.loading import LoadImages, LoadMasks

__all__ = ["Collect", "Compose", "Normalize", "ToArray", "ComputeBbox", "Crop", "Pad",
           "ProjectKeypoints", "RemapPose", "Resize", "LoadImages", "LoadMasks", "PoseJitter",
           "RandomHSV", "RandomNoise", "RandomSmooth", "RandomSharpness", "RandomGray",
           "RandomBackground", "RandomOcclusion", "RandomOcclusionV2"]
