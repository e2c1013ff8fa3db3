"""Photometric augmentations without cv2: those of the shipped train
pipeline (configs/refine_datasets/ycbv_real.py: RandomHSV, RandomNoise,
RandomSmooth), the background swap the PBR configs insert
(RandomBackground), RandomSharpness, RandomGray and the two occluders
(RandomOcclusion, RandomOcclusionV2).  The port's copy of
scflow_tpu/datasets/pipelines/color.py (reference
datasets/pipelines/color_transform.py), but for Normalize, which
formatting.py holds: the same draws from Python's `random` and numpy's
global RNG in the same order, and imops' bit-exact replacements of cv2's
reads, colour conversions, box filter, normalize, resize and affine warp.
The colour transforms act on the per-object uint8 BGR patches that Crop
makes (patch_level) or on the whole image."""

import glob
import random
import warnings
from os import path as osp

import numpy as np

from scflow_tpu_torch.datasets.mask import BitmapMasks
from scflow_tpu_torch.datasets.pipelines.imops import (DecodeError, bgr2gray, bgr2hsv, blur,
                                                       get_rotation_matrix_2d, gray2bgr,
                                                       hsv2bgr, imread, normalize_minmax,
                                                       resize_u8, warp_affine)
from scflow_tpu_torch.registry import PIPELINES


def _read_or_none(path: str):
    """imread(path, 'color'), or None where cv2.imread returns None (a file
    that is missing or not an image).  A file that cv2 reads and the port
    cannot raises."""
    try:
        return imread(path, "color")
    except (DecodeError, OSError):
        return None


class ColorTransform:
    """Applies augment() to each patch of results[key] (patch_level) or to
    results[key] itself, for each key of image_keys; with augment_with_mask
    each patch's augment() also takes its entry of results['gt_masks']."""

    def __init__(self, patch_level=True, image_keys=("img",)):
        self.patch_level = patch_level
        self.image_keys = image_keys
        self.augment_with_mask = False

    def augment(self, img, mask=None):
        raise NotImplementedError

    def __call__(self, results):
        for key in self.image_keys:
            if self.patch_level:
                if self.augment_with_mask:
                    masks = results.get("gt_masks")
                    results[key] = [self.augment(patch, masks[i])
                                    for i, patch in enumerate(results[key])]
                else:
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

    def augment(self, img, mask=None):
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

    def augment(self, img, mask=None):
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

    def augment(self, img, mask=None):
        if random.random() > self.p:
            return img
        return blur(img, random.choice(self.kernel_sizes))


@PIPELINES.register_module("RandomSharpness")
class RandomSharpness(ColorTransform):
    """With probability p, blends the patch with its edge map (the ratio to
    or the difference from a box blur of a drawn size, min-max normalized)
    at a weight U(0.5, 0.95), then min-max normalizes the blend."""

    def __init__(self, kernel_sizes=(5, 7, 9, 11), p=1.0, patch_level=True,
                 image_keys=("img",)):
        super().__init__(patch_level, image_keys)
        self.kernel_sizes = list(kernel_sizes)
        self.p = p

    def augment(self, img, mask=None):
        if random.random() > self.p:
            return img
        ks = random.choice(self.kernel_sizes)
        smooth = blur(img, ks)
        if random.random() < 0.5:
            edge = img / (smooth.astype(np.float32) + 0.01)
        else:
            edge = img - smooth.astype(np.float32)
        edge = normalize_minmax(edge).astype(np.uint8)
        alpha = random.uniform(0.5, 0.95)
        out = img * (1 - alpha) + edge * alpha
        return normalize_minmax(out).astype(np.uint8)


@PIPELINES.register_module("RandomGray")
class RandomGray(ColorTransform):
    """With probability p, the patch's grey (BT.601) in all three channels."""

    def __init__(self, p=1.0, patch_level=True, image_keys=("img",)):
        super().__init__(patch_level, image_keys)
        self.p = p

    def augment(self, img, mask=None):
        if random.random() > self.p:
            return img
        return gray2bgr(bgr2gray(img))


@PIPELINES.register_module("RandomBackground")
class RandomBackground(ColorTransform):
    """With probability p per patch, replaces the pixels outside every
    object mask by an image drawn from background_dir (its *.jpg, then its
    *.png, sorted), read in colour and resized to the patch with cv2's
    INTER_LINEAR (p=0.3 in the PBR configs).  A file that is not an image
    warns and keeps the patch, as the reference does."""

    def __init__(self, background_dir, p=0.8, file_client_args=None,
                 flag="color", patch_level=True):
        super().__init__(patch_level)
        self.augment_with_mask = True
        self.backgrounds = sorted(
            glob.glob(osp.join(background_dir, "*.jpg"))
            + glob.glob(osp.join(background_dir, "*.png"))
        )
        if not self.backgrounds:
            raise RuntimeError(f"no background images in {background_dir}")
        self.p = p

    def augment(self, img, mask=None):
        if random.random() > self.p:
            return img
        path = random.choice(self.backgrounds)
        bg = _read_or_none(path)
        if bg is None:
            warnings.warn(f"failed to load background {path}")
            return img
        if bg.shape[:2] != img.shape[:2]:
            bg = resize_u8(bg, img.shape[:2])
        alpha = np.ones(img.shape[:2], np.float32)
        alpha[mask.get_background_mask()] = 0
        alpha = alpha[..., None]
        return np.uint8(bg * (1 - alpha) + img[..., :3] * alpha)


@PIPELINES.register_module("RandomOcclusion")
class RandomOcclusion:
    """Synthetic rectangular occluders with mask update
    (color_transform.py:270-330): with probability p per patch whose box is
    at least min_bbox_size, a rectangle of random noise of a drawn size,
    aspect and centre inside the box, cut out of every mask."""

    def __init__(self, p=0.0, bbox_field="gt_bboxes", mask_field="gt_masks",
                 size_range=(0.02, 0.7), ratio_range=(0.5, 2.0), min_bbox_size=20):
        self.p = p
        self.bbox_field = bbox_field
        self.mask_field = mask_field
        self.size_range = size_range
        self.ratio_range = ratio_range
        self.min_bbox_size = min_bbox_size

    def __call__(self, results):
        images = results["img"]
        bboxes = results[self.bbox_field]
        masks = results[self.mask_field]
        x1, y1, x2, y2 = bboxes[..., 0], bboxes[..., 1], bboxes[..., 2], bboxes[..., 3]
        bbox_size = (x2 - x1) * (y2 - y1)
        new_images, new_masks = [], []
        for i in range(len(bboxes)):
            img, mask = images[i], masks[i]
            if random.random() > self.p or bbox_size[i] < self.min_bbox_size:
                new_images.append(img)
                new_masks.append(mask)
                continue
            h, w = img.shape[:2]
            size = random.uniform(*self.size_range) * bbox_size[i]
            ratio = random.uniform(*self.ratio_range)
            ew, eh = int(np.sqrt(size * ratio)), int(np.sqrt(size / ratio))
            ecx, ecy = random.uniform(x1[i], x2[i]), random.uniform(y1[i], y2[i])
            esx = int(np.clip(ecx - ew / 2 + 0.5, 0, w - 1))
            esy = int(np.clip(ecy - eh / 2 + 0.5, 0, h - 1))
            eex = int(np.clip(ecx + ew / 2 + 0.5, 0, w - 1))
            eey = int(np.clip(ecy + eh / 2 + 0.5, 0, h - 1))
            img = img.copy()
            img[esy:eey, esx:eex] = np.random.randint(
                256, size=(eey - esy, eex - esx, 3)
            )
            occ = np.zeros((h, w), np.uint8)
            occ[esy:eey, esx:eex] = 1
            new_masks.append(mask.merge_background_mask(occ))
            new_images.append(img)
        results["img"] = new_images
        results[self.mask_field] = new_masks
        return results


@PIPELINES.register_module("RandomOcclusionV2")
class RandomOcclusionV2:
    """Paste a random occluder image (black background) over the object with
    a random scale/rotation/translation; masks are updated
    (color_transform.py:333-402)."""

    def __init__(self, augment_mask_field, data_root, image_list,
                 file_client_args=None, p=1.0, scale_range=(0.5, 1.0),
                 rotate_range=(-45, 45)):
        self.data_root = data_root
        with open(image_list) as f:
            self.image_list = [
                osp.join(data_root, line.strip()) for line in f if line.strip()
            ]
        self.augment_mask_field = augment_mask_field
        self.p = p
        self.scale_range = scale_range
        self.rotate_range = rotate_range

    def __call__(self, results):
        if random.random() > self.p:
            return results
        img = results["img"]
        mask = results[self.augment_mask_field]
        h, w = img.shape[:2]
        occ_bgr = _read_or_none(random.choice(self.image_list))
        if occ_bgr is None:
            return results
        if occ_bgr.shape[:2] != (h, w):
            occ_bgr = resize_u8(occ_bgr, (h, w))
        occ_fg = (
            (occ_bgr[..., 0] > 0) | (occ_bgr[..., 1] > 0) | (occ_bgr[..., 2] > 0)
        ).astype(np.uint8)
        occ_masks = BitmapMasks([occ_fg], h, w)
        ob = occ_masks.get_bboxes()[0]
        origin = mask.get_bboxes()[0]
        if ob[2] <= ob[0] or origin[2] <= origin[0]:
            return results
        ocx, ocy = (ob[0] + ob[2]) / 2, (ob[1] + ob[3]) / 2
        pleft = random.randint(int(ocx - origin[2]), int(ocx - origin[0]))
        ptop = random.randint(int(ocy - origin[3]), int(ocy - origin[1]))
        shift = np.array([[1, 0, -pleft], [0, 1, -ptop], [0, 0, 1]], np.float32)
        scale = np.sqrt(max(mask.areas[0], 1) / max(occ_masks.areas[0], 1))
        sf = random.uniform(scale * self.scale_range[0], scale * self.scale_range[1])
        angle = random.uniform(*self.rotate_range)
        rs = get_rotation_matrix_2d((ocx, ocy), angle, sf)
        tm = shift @ np.concatenate([rs, [[0, 0, 1]]], axis=0)
        occ_bgr = warp_affine(occ_bgr, tm[:2], (w, h), "bilinear", (0, 0, 0))
        occ_fg_w = occ_masks.warpaffine(tm[:2], w, h)
        alpha = occ_fg_w.masks[0].astype(np.float32)[..., None]
        results["img"] = ((1 - alpha) * img + alpha * occ_bgr).astype(np.uint8)
        for field in results.get("mask_fields", ["gt_masks"]):
            results[field] = results[field].merge_background_mask(occ_fg_w.masks[0])
        return results
