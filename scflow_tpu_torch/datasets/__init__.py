"""The data layer of the test workflow, without cv2: BOP annotation
stores, the refinement datasets with ADD(-S)/REP/AUC evaluation and BOP
export, the pipeline transforms and batch collation.  The port's copy of
scflow_tpu/datasets; importing it registers the datasets and transforms
under the JAX package's names."""

from scflow_tpu_torch.datasets import pipelines  # noqa: F401  (registers the transforms)
from scflow_tpu_torch.datasets.base import BaseDataset, ConcatDataset
from scflow_tpu_torch.datasets.loader import collate_batch
from scflow_tpu_torch.datasets.mask import BitmapMasks
from scflow_tpu_torch.datasets.refine import RefineDataset, RefineTestDataset

__all__ = ["BaseDataset", "BitmapMasks", "ConcatDataset", "RefineDataset", "RefineTestDataset",
           "collate_batch"]
