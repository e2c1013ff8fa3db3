"""Bitmap instance masks in numpy: the port's copy of
scflow_tpu/datasets/mask.py (the reference's mmcv-backed BitmapMasks,
datasets/mask.py:12-419) without cv2: the methods the test workflow's
transforms reach (crop, rescale and resize with cv2's nearest rule, pad)
and the array helpers.  The flips, affine warps, crop_and_resize and
occlusion helpers, which the training augmentations use, come with the
train workflow."""

from typing import Tuple

import numpy as np


class BitmapMasks:
    """masks: (N, H, W) uint8 array or list of (H, W) arrays."""

    def __init__(self, masks, height: int, width: int):
        self.height = height
        self.width = width
        if len(masks) == 0:
            self.masks = np.empty((0, height, width), dtype=np.uint8)
        else:
            if isinstance(masks, np.ndarray):
                assert masks.ndim == 3
                self.masks = masks.astype(np.uint8)
            else:
                flat = []
                for m in masks:
                    if isinstance(m, BitmapMasks):
                        flat.extend(list(m.masks))
                    else:
                        assert m.shape == (height, width), (m.shape, height, width)
                        flat.append(m)
                self.masks = np.stack(flat).astype(np.uint8)

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, idx):
        m = self.masks[idx]
        if m.ndim == 2:
            return BitmapMasks(m[None], self.height, self.width)
        return BitmapMasks(m, self.height, self.width)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @property
    def areas(self) -> np.ndarray:
        return self.masks.sum(axis=(1, 2))

    def crop(self, bbox) -> "BitmapMasks":
        """Crop by [x1, y1, x2, y2]; out-of-image regions are zero-padded
        (clip_border=False crops may extend past the image)."""
        x1, y1, x2, y2 = [int(v) for v in bbox]
        w, h = max(x2 - x1, 1), max(y2 - y1, 1)
        out = np.zeros((len(self.masks), h, w), np.uint8)
        sx1, sy1 = max(x1, 0), max(y1, 0)
        sx2, sy2 = min(x2, self.width), min(y2, self.height)
        if sx2 > sx1 and sy2 > sy1:
            out[:, sy1 - y1 : sy2 - y1, sx1 - x1 : sx2 - x1] = self.masks[
                :, sy1:sy2, sx1:sx2
            ]
        return BitmapMasks(out, h, w)

    def rescale(self, scale) -> "BitmapMasks":
        """Keep-ratio rescale to fit in `scale` (int or (h, w)), mmcv
        imrescale semantics."""
        if isinstance(scale, (tuple, list)):
            max_long, max_short = max(scale), min(scale)
        else:
            max_long = max_short = scale
        h, w = self.height, self.width
        factor = min(max_long / max(h, w), max_short / min(h, w))
        new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
        return self.resize((new_h, new_w))

    def resize(self, out_shape) -> "BitmapMasks":
        """Nearest resize to out_shape ((h, w) or an int), cv2.INTER_NEAREST's
        rule: source index min(floor(d * (1 / (dst / src))), src - 1) in
        float64, the reciprocal of the scale taken first as cv2 does."""
        h, w = out_shape if isinstance(out_shape, (tuple, list)) else (out_shape, out_shape)
        if len(self.masks) == 0:
            return BitmapMasks([], h, w)
        ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / self.height))).astype(np.int64),
                        self.height - 1)
        xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / self.width))).astype(np.int64),
                        self.width - 1)
        return BitmapMasks(self.masks[:, ys][:, :, xs], h, w)

    def pad(self, padding: Tuple[int, int, int, int], pad_val=0) -> "BitmapMasks":
        """padding = (left, top, right, bottom); negative values crop."""
        left, top, right, bottom = [int(p) for p in padding]
        h = self.height + top + bottom
        w = self.width + left + right
        out = np.full((len(self.masks), h, w), pad_val, np.uint8)
        sy1, sx1 = max(-top, 0), max(-left, 0)
        sy2 = min(self.height, h - top)
        sx2 = min(self.width, w - left)
        dy1, dx1 = max(top, 0), max(left, 0)
        out[:, dy1 : dy1 + (sy2 - sy1), dx1 : dx1 + (sx2 - sx1)] = self.masks[
            :, sy1:sy2, sx1:sx2
        ]
        return BitmapMasks(out, h, w)

    def copy(self) -> "BitmapMasks":
        return BitmapMasks(self.masks.copy(), self.height, self.width)

    def to_ndarray(self) -> np.ndarray:
        return self.masks

    def to_array(self, dtype=np.float32) -> np.ndarray:
        return self.masks.astype(dtype)
