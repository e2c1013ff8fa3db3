"""The data layer of the test and train workflows, without cv2: BOP
annotation stores, the refinement datasets with ADD(-S)/REP/AUC evaluation
and BOP export, the supervised train dataset, the pipeline transforms,
batch collation and the DataLoader.  The port's copy of
scflow_tpu/datasets; importing it registers the datasets and transforms
under the JAX package's names."""

from scflow_tpu_torch.datasets import pipelines  # noqa: F401  (registers the transforms)
from scflow_tpu_torch.datasets.base import BaseDataset, ConcatDataset
from scflow_tpu_torch.datasets.loader import DataLoader, collate_batch
from scflow_tpu_torch.datasets.mask import BitmapMasks
from scflow_tpu_torch.datasets.refine import RefineDataset, RefineTestDataset
from scflow_tpu_torch.datasets.supervise import SuperviseTrainDataset

__all__ = ["BaseDataset", "BitmapMasks", "ConcatDataset", "DataLoader", "RefineDataset",
           "RefineTestDataset", "SuperviseTrainDataset", "collate_batch"]
