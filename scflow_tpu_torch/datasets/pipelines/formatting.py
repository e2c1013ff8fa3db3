"""Pipeline composition and output formatting.

ToArray replaces the reference's ToTensor (formatting.py:94-148): patches are
stacked to NHWC float arrays (the layout the entry points take) instead of
NCHW tensors; masks are packed to (n, H, W) uint8.  Collect splits annot/meta keys
exactly like the reference (formatting.py:150-180).  The port's copy of
scflow_tpu/datasets/pipelines/formatting.py, with Normalize (in the JAX
package's color.py, beside the colour augmentations of the train
workflow)."""

from typing import Dict, Sequence

import numpy as np

from scflow_tpu_torch.datasets.mask import BitmapMasks
from scflow_tpu_torch.registry import PIPELINES


@PIPELINES.register_module("Compose")
class Compose:
    """Transform chain (reference `datasets/pipelines/formatting.py:183-217`
    semantics: None from any transform aborts the sample)."""

    def __init__(self, transforms: Sequence):
        self.transforms = []
        for t in transforms:
            if isinstance(t, dict):
                self.transforms.append(PIPELINES.build(t))
            elif callable(t):
                self.transforms.append(t)
            else:
                raise TypeError(t)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
            if data is None:
                return None
        return data

    def __repr__(self):
        inner = "\n".join(f"    {t.__class__.__name__}" for t in self.transforms)
        return f"Compose(\n{inner}\n)"


@PIPELINES.register_module("CopyFields")
class CopyFields:
    """Copy result fields src[i] -> dst[i] (arrays copied).  Pipeline
    surgery uses it (`cli browse --skip-types PoseJitter`): a skipped
    jitter must still give the downstream transforms their `ref_*` pose
    fields, so ref = gt."""

    def __init__(self, src: Sequence[str], dst: Sequence[str]):
        if len(src) != len(dst):
            raise ValueError(f"CopyFields: {len(src)} source fields for {len(dst)} targets")
        self.src = list(src)
        self.dst = list(dst)

    def __call__(self, results: Dict) -> Dict:
        for s, d in zip(self.src, self.dst):
            v = results[s]
            results[d] = np.copy(v) if isinstance(v, np.ndarray) else v
        return results


@PIPELINES.register_module("ToArray")
@PIPELINES.register_module("ToTensor")  # config-name compatibility
class ToArray:
    def __init__(self, stack_keys=("img",)):
        self.stack_keys = stack_keys

    def __call__(self, results):
        for key in results.get("image_fields", ["img"]):
            img = results[key]
            if isinstance(img, (list, tuple)):
                img = [i[..., None] if i.ndim == 2 else i for i in img]
                img = np.stack(img, axis=0)
            results[key] = np.ascontiguousarray(img, dtype=np.float32)
        for field in results.get("mask_fields", []):
            masks = results[field]
            if isinstance(masks, (list, tuple)):
                flat = []
                for m in masks:
                    flat.extend(list(m.masks) if isinstance(m, BitmapMasks) else [m])
                if flat:
                    h, w = flat[0].shape
                    results[field] = BitmapMasks(flat, h, w)
                else:
                    results[field] = BitmapMasks([], 0, 0)
        return results


@PIPELINES.register_module("Collect")
class Collect:
    def __init__(self, keys=("img",), annot_keys=None,
                 meta_keys=("img_path", "ori_shape", "ori_k", "k", "img_shape",
                            "img_norm_cfg")):
        self.keys = keys
        self.annot_keys = annot_keys
        self.meta_keys = meta_keys

    def __call__(self, results):
        data: Dict = {}
        annot_keys = self.annot_keys or results.get("annot_fields", [])
        img_meta = {k: results[k] for k in self.meta_keys if k in results}
        annot = {k: results[k] for k in annot_keys if k in results}
        for k in self.keys:
            data[k] = results[k]
        data["img_metas"] = img_meta
        if annot:
            data["annots"] = annot
        return data


@PIPELINES.register_module("Normalize")
class Normalize:
    """(img - mean) / std on each patch in float32, BGR -> RGB first when
    to_rgb (JAX's Normalize, a patch-level ColorTransform)."""

    def __init__(self, mean, std, to_rgb=True, patch_level=True, image_keys=("img",)):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_rgb = to_rgb
        self.patch_level = patch_level
        self.image_keys = image_keys

    def augment(self, img):
        img = img.astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        return (img - self.mean) / self.std

    def __call__(self, results):
        if len(results["labels"]) > 0:
            for key in self.image_keys:
                imgs = results[key]
                results[key] = ([self.augment(p) for p in imgs] if self.patch_level
                                else self.augment(imgs))
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std, to_rgb=self.to_rgb)
        return results
