"""Image/mask loading transforms (reference datasets/pipelines/loadding.py):
the port's copy of scflow_tpu/datasets/pipelines/loading.py, reading PNG and
JPEG files with imops.imread in place of cv2.imread."""

import os

import numpy as np

from scflow_tpu_torch.datasets.mask import BitmapMasks
from scflow_tpu_torch.datasets.pipelines.imops import imread
from scflow_tpu_torch.registry import PIPELINES


def _read(path: str, flag: str) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return imread(path, flag)


@PIPELINES.register_module("LoadImages")
class LoadImages:
    def __init__(self, color_type="color", to_float32=False, file_client_args=None):
        self.color_type = color_type
        self.to_float32 = to_float32

    def __call__(self, results):
        img = _read(results["img_path"], self.color_type)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=-1)
        if self.to_float32:
            img = img.astype(np.float32)
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        return results


@PIPELINES.register_module("LoadMasks")
class LoadMasks:
    def __init__(self, binarize=True, merge=False, file_client_args=None, eps=1e-5):
        self.binarize = binarize
        self.eps = eps

    def __call__(self, results):
        height, width = results["img_shape"][:2]
        masks = []
        for path in results["gt_mask_path"]:
            m = _read(path, "unchanged")
            if m.ndim == 3:
                m = m[..., 0]
            if self.binarize:
                mx = m.max()
                m = np.zeros_like(m) if mx < self.eps else (m / mx).astype(m.dtype)
            masks.append(m)
        results["gt_masks"] = BitmapMasks(masks, height, width)
        return results
