"""Bitmap instance masks in numpy: the port's copy of
scflow_tpu/datasets/mask.py (the reference's mmcv-backed BitmapMasks,
datasets/mask.py:12-419) without cv2: crop, rescale and resize (cv2's
nearest rule, or its INTER_LINEAR), pad, the affine warps (imops'
warp_affine and get_rotation_matrix_2d in place of cv2's), flip, expand,
a numpy roi_align for crop_and_resize, and the occlusion helpers the
colour transforms use."""

from typing import Tuple

import numpy as np

from scflow_tpu_torch.datasets.pipelines.imops import (get_rotation_matrix_2d, resize_u8,
                                                       warp_affine)

# cv2's interpolation codes, which the JAX package's callers pass
_INTER_NEAREST, _INTER_LINEAR = 0, 1


def _interp_matrix(coords, size: int) -> np.ndarray:
    """Dense 1D bilinear-gather matrix with roi_align boundary semantics:
    samples outside [-1, size] contribute zero; in [-1, 0] they clamp to
    pixel 0; at the high edge both taps collapse onto size-1."""
    c = np.asarray(coords, np.float64)
    valid = (c >= -1.0) & (c <= size)
    c0 = np.maximum(c, 0.0)
    lo = np.floor(c0).astype(np.int64)
    at_edge = lo >= size - 1
    lo = np.where(at_edge, size - 1, lo)
    hi = np.where(at_edge, size - 1, lo + 1)
    frac = np.where(at_edge, 0.0, c0 - lo)
    M = np.zeros((len(c), size))
    rows = np.arange(len(c))
    np.add.at(M, (rows, lo), (1.0 - frac) * valid)
    np.add.at(M, (rows, hi), frac * valid)
    return M


def _bilinear_zero_pad(img: np.ndarray, ys, xs) -> np.ndarray:
    """(len(ys), len(xs)) bilinear samples of a 2D image on the ys × xs
    lattice, zero outside — two separable interp-matrix matmuls."""
    return _interp_matrix(ys, img.shape[0]) @ img @ _interp_matrix(
        xs, img.shape[1]).T


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

    def rescale(self, scale, interpolation=_INTER_NEAREST) -> "BitmapMasks":
        """Keep-ratio rescale to fit in `scale` (int or (h, w)), mmcv
        imrescale semantics."""
        if isinstance(scale, (tuple, list)):
            max_long, max_short = max(scale), min(scale)
        else:
            max_long = max_short = scale
        h, w = self.height, self.width
        factor = min(max_long / max(h, w), max_short / min(h, w))
        new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
        return self.resize((new_h, new_w), interpolation)

    def resize(self, out_shape, interpolation=_INTER_NEAREST) -> "BitmapMasks":
        """Resize to out_shape ((h, w) or an int).  interpolation is cv2's
        code: INTER_NEAREST (0, the default) takes cv2's rule, source index
        min(floor(d * (1 / (dst / src))), src - 1) in float64, the
        reciprocal of the scale taken first as cv2 does; INTER_LINEAR (1)
        is cv2's on uint8 (imops.resize_u8).  Other codes raise
        NotImplementedError."""
        h, w = out_shape if isinstance(out_shape, (tuple, list)) else (out_shape, out_shape)
        if interpolation not in (_INTER_NEAREST, _INTER_LINEAR):
            raise NotImplementedError(f"mask resize with interpolation {interpolation!r} "
                                      "(nearest and bilinear only)")
        if len(self.masks) == 0:
            return BitmapMasks([], h, w)
        if interpolation == _INTER_LINEAR:
            return BitmapMasks(np.stack([resize_u8(m, (h, w)) for m in self.masks]), h, w)
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

    def warpaffine(self, matrix2x3, width, height) -> "BitmapMasks":
        warped = [warp_affine(m, matrix2x3, (width, height), "nearest") for m in self.masks]
        return BitmapMasks(warped, height, width)

    def flip(self, flip_direction: str = "horizontal") -> "BitmapMasks":
        """Flip along an axis (reference datasets/mask.py:129-141; mmcv
        imflip: horizontal = reverse columns, vertical = reverse rows,
        diagonal = both)."""
        assert flip_direction in ("horizontal", "vertical", "diagonal")
        if len(self.masks) == 0:
            return BitmapMasks(self.masks, self.height, self.width)
        m = self.masks
        if flip_direction in ("horizontal", "diagonal"):
            m = m[:, :, ::-1]
        if flip_direction in ("vertical", "diagonal"):
            m = m[:, ::-1, :]
        return BitmapMasks(np.ascontiguousarray(m), self.height, self.width)

    def expand(self, expanded_h: int, expanded_w: int, top: int,
               left: int) -> "BitmapMasks":
        """Place the masks inside a larger zero canvas (reference
        datasets/mask.py:220-231)."""
        out = np.zeros((len(self.masks), expanded_h, expanded_w), np.uint8)
        if len(self.masks):
            out[:, top : top + self.height, left : left + self.width] = self.masks
        return BitmapMasks(out, expanded_h, expanded_w)

    def _warp_all(self, matrix2x3, out_shape, border_value, interpolation):
        h, w = out_shape
        if len(self.masks) == 0:
            return BitmapMasks(np.empty((0, h, w), np.uint8), h, w)
        warped = np.stack([warp_affine(m, matrix2x3, (w, h), interpolation, border_value)
                           for m in self.masks]).astype(self.masks.dtype)
        return BitmapMasks(warped, h, w)

    def translate(self, out_shape, offset, direction: str = "horizontal",
                  fill_val=0, interpolation: str = "bilinear") -> "BitmapMasks":
        """Translate (reference datasets/mask.py:233-284; mmcv imtranslate:
        a pure-offset affine warp, bilinear by default)."""
        assert direction in ("horizontal", "vertical")
        if direction == "horizontal":
            matrix = np.float32([[1, 0, offset], [0, 1, 0]])
        else:
            matrix = np.float32([[1, 0, 0], [0, 1, offset]])
        return self._warp_all(matrix, out_shape, fill_val, interpolation)

    def shear(self, out_shape, magnitude, direction: str = "horizontal",
              border_value=0, interpolation: str = "bilinear") -> "BitmapMasks":
        """Shear (reference datasets/mask.py:286-320; mmcv imshear matrix:
        [[1, mag, 0], [0, 1, 0]] horizontal / [[1, 0, 0], [mag, 1, 0]]
        vertical)."""
        assert direction in ("horizontal", "vertical")
        if direction == "horizontal":
            matrix = np.float32([[1, magnitude, 0], [0, 1, 0]])
        else:
            matrix = np.float32([[1, 0, 0], [magnitude, 1, 0]])
        return self._warp_all(matrix, out_shape, border_value, interpolation)

    def rotate(self, out_shape, angle, center=None, scale: float = 1.0,
               fill_val=0) -> "BitmapMasks":
        """Rotate (reference datasets/mask.py:322-351; mmcv imrotate:
        positive angle = clockwise, i.e. getRotationMatrix2D(center, -angle,
        scale), default center = ((w-1)/2, (h-1)/2), bilinear)."""
        if center is None:
            center = ((self.width - 1) * 0.5, (self.height - 1) * 0.5)
        matrix = get_rotation_matrix_2d(tuple(center), -angle, scale)
        return self._warp_all(matrix, out_shape, fill_val, "bilinear")

    def crop_and_resize(self, bboxes, out_shape, inds,
                        interpolation: str = "bilinear",
                        binarize: bool = True) -> "BitmapMasks":
        """RoIAlign crop (reference datasets/mask.py:183-218, mmcv
        roi_align avg/aligned=True/sampling_ratio=0) in pure numpy: each
        output bin averages ceil(bin)² bilinear samples with aligned=True
        half-pixel offsets and zero padding outside the image."""
        out_h, out_w = out_shape
        if len(self.masks) == 0 or len(bboxes) == 0:
            return BitmapMasks(np.empty((0, out_h, out_w), np.uint8),
                               out_h, out_w)
        bboxes = np.asarray(bboxes, np.float64)
        inds = np.asarray(inds, np.int64)
        results = []
        for box, src_idx in zip(bboxes, inds):
            mask = self.masks[src_idx].astype(np.float64)
            x1, y1, x2, y2 = box[:4] - 0.5  # aligned=True
            roi_w, roi_h = x2 - x1, y2 - y1
            bin_w, bin_h = roi_w / out_w, roi_h / out_h
            gx = max(int(np.ceil(roi_w / out_w)), 1)  # sampling_ratio=0
            gy = max(int(np.ceil(roi_h / out_h)), 1)
            # sample coordinates: (out, grid) lattice, then bilinear gather
            ys = (y1 + (np.arange(out_h)[:, None] + (np.arange(gy)[None]
                  + 0.5) / gy) * bin_h).reshape(-1)
            xs = (x1 + (np.arange(out_w)[:, None] + (np.arange(gx)[None]
                  + 0.5) / gx) * bin_w).reshape(-1)
            val = _bilinear_zero_pad(mask, ys, xs)  # (len(ys), len(xs))
            val = val.reshape(out_h, gy, out_w, gx).mean(axis=(1, 3))
            results.append(val)
        out = np.stack(results)
        if binarize:
            out = out >= 0.5
        return BitmapMasks(out.astype(np.uint8), out_h, out_w)

    def copy(self) -> "BitmapMasks":
        return BitmapMasks(self.masks.copy(), self.height, self.width)

    def to_ndarray(self) -> np.ndarray:
        return self.masks

    def cal_iof(self, new_mask: np.ndarray) -> np.ndarray:
        """Intersection-over-foreground of each instance vs `new_mask`
        (reference datasets/mask.py:400-414; area 0 -> iof 1.0)."""
        fg = new_mask.astype(bool)
        area = fg.sum()
        if area == 0:
            return np.ones(len(self.masks))
        inter = (self.masks.astype(bool) & fg[None]).sum(axis=(1, 2))
        return inter / area

    def get_bboxes(self) -> np.ndarray:
        boxes = []
        for m in self.masks:
            ys, xs = np.nonzero(m)
            if len(xs) == 0:
                boxes.append([0, 0, 0, 0])
            else:
                boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        return np.asarray(boxes, np.float32)

    def get_background_mask(self) -> np.ndarray:
        """(H, W) bool: True where NO instance is present."""
        return self.masks.sum(axis=0) == 0

    def merge_background_mask(self, occluder: np.ndarray) -> "BitmapMasks":
        """Remove occluded pixels from every instance mask."""
        new = self.masks * (occluder[None] == 0).astype(np.uint8)
        return BitmapMasks(new, self.height, self.width)

    def to_array(self, dtype=np.float32) -> np.ndarray:
        return self.masks.astype(dtype)
