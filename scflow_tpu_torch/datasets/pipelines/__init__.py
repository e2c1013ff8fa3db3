"""The data pipeline's transforms, registered under the JAX package's names
(scflow_tpu/datasets/pipelines): those of the test workflow and of the
shipped train pipeline (PoseJitter, RandomHSV, RandomNoise, RandomSmooth,
ProjectKeypoints).  The other colour transforms of the JAX package are not
ported yet, so a config naming them raises KeyError where the dataset is
built."""

from scflow_tpu_torch.datasets.pipelines.color import RandomHSV, RandomNoise, RandomSmooth
from scflow_tpu_torch.datasets.pipelines.formatting import Collect, Compose, Normalize, ToArray
from scflow_tpu_torch.datasets.pipelines.geometry import (ComputeBbox, Crop, Pad,
                                                          ProjectKeypoints, RemapPose, Resize)
from scflow_tpu_torch.datasets.pipelines.jitter import PoseJitter
from scflow_tpu_torch.datasets.pipelines.loading import LoadImages, LoadMasks

__all__ = ["Collect", "Compose", "Normalize", "ToArray", "ComputeBbox", "Crop", "Pad",
           "ProjectKeypoints", "RemapPose", "Resize", "LoadImages", "LoadMasks", "PoseJitter",
           "RandomHSV", "RandomNoise", "RandomSmooth"]
