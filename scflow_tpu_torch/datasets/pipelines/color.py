"""Photometric augmentations of the shipped train pipeline
(configs/refine_datasets/ycbv_real.py: RandomHSV, RandomNoise,
RandomSmooth), without cv2.  The port's copy of part of
scflow_tpu/datasets/pipelines/color.py (reference
datasets/pipelines/color_transform.py): the same draws from Python's
`random` and numpy's global RNG in the same order, and imops' bit-exact
replacements of cv2's HSV conversions and box filter.  They act on the
per-object uint8 BGR patches that Crop makes (patch_level) or on the whole
image."""

import random

import numpy as np

from scflow_tpu_torch.datasets.pipelines.imops import bgr2hsv, blur, hsv2bgr
from scflow_tpu_torch.registry import PIPELINES


class ColorTransform:
    """Applies augment() to each patch of results[key] (patch_level) or to
    results[key] itself, for each key of image_keys."""

    def __init__(self, patch_level=True, image_keys=("img",)):
        self.patch_level = patch_level
        self.image_keys = image_keys

    def augment(self, img):
        raise NotImplementedError

    def __call__(self, results):
        for key in self.image_keys:
            if self.patch_level:
                results[key] = [self.augment(patch) for patch in results[key]]
            else:
                results[key] = self.augment(results[key])
        return results


@PIPELINES.register_module("RandomHSV")
class RandomHSV(ColorTransform):
    """With probability p, scales H, S and V by 1 + U(-1, 1) x ratio each,
    clipping at 179 / 255 where the factor is at least 1."""

    def __init__(self, h_ratio, s_ratio, v_ratio, p=1.0, patch_level=True,
                 image_keys=("img",)):
        super().__init__(patch_level, image_keys)
        self.h_ratio, self.s_ratio, self.v_ratio, self.p = h_ratio, s_ratio, v_ratio, p

    def augment(self, img):
        if random.random() > self.p:
            return img
        hsv = bgr2hsv(img)
        a = random.uniform(-1, 1) * self.h_ratio + 1
        b = random.uniform(-1, 1) * self.s_ratio + 1
        c = random.uniform(-1, 1) * self.v_ratio + 1
        for i, (f, top) in enumerate(((a, 179), (b, 255), (c, 255))):
            x = hsv[:, :, i].astype(np.float32) * f
            hsv[:, :, i] = x if f < 1 else x.clip(None, top)  # float -> uint8 truncates
        return hsv2bgr(hsv)


@PIPELINES.register_module("RandomNoise")
class RandomNoise(ColorTransform):
    """With probability p, adds gaussian noise of sigma U(0, noise_ratio) x
    255, clipped to uint8."""

    def __init__(self, noise_ratio, p=1.0, patch_level=True, image_keys=("img",)):
        super().__init__(patch_level, image_keys)
        self.noise_ratio, self.p = noise_ratio, p

    def augment(self, img):
        if random.random() > self.p:
            return img
        sigma = random.uniform(0, self.noise_ratio)
        noisy = img + np.random.normal(0, sigma, img.shape) * 255
        return np.uint8(np.clip(noisy, 0, 255))


@PIPELINES.register_module("RandomSmooth")
class RandomSmooth(ColorTransform):
    """With probability p, a box blur of a size drawn from 1, 3, ...,
    max_kernel_size."""

    def __init__(self, max_kernel_size=7, p=1.0, patch_level=True, image_keys=("img",)):
        super().__init__(patch_level, image_keys)
        self.kernel_sizes = [i * 2 + 1 for i in range(int(max_kernel_size) // 2 + 1)]
        self.p = p

    def augment(self, img):
        if random.random() > self.p:
            return img
        return blur(img, random.choice(self.kernel_sizes))
