"""Geometric patch transforms: bbox computation, per-object crop, keep-ratio
resize, center pad, and pose/intrinsic remapping.

Reference: datasets/pipelines/geometry_transform.py and formatting.py:40-90;
the port's copy of scflow_tpu/datasets/pipelines/geometry.py, with imops'
resize and host_geometry's pose remap in place of cv2's.
After Crop, 'img' is a list of per-object patches and 'k'/'transform_matrix'
carry a leading object axis; the accumulated 3x3 transform maps original
image pixels to patch pixels.
"""

import random
import numpy as np

from scflow_tpu_torch.datasets.pipelines.imops import imcrop_pad, impad, imrescale, imresize
from scflow_tpu_torch.host_geometry import project_3d_point, remap_pose
from scflow_tpu_torch.registry import PIPELINES
from scflow_tpu_torch.render.ply import load_ply


def update_transform_matrix(transform_matrix, results):
    if results.get("transform_matrix", None) is None:
        results["transform_matrix"] = transform_matrix
    else:
        results["transform_matrix"] = np.matmul(
            transform_matrix, results["transform_matrix"]
        )
    return results


@PIPELINES.register_module("ComputeBbox")
class ComputeBbox:
    """Project mesh vertices under the reference pose -> 2D bbox."""

    def __init__(self, mesh_dir, clip_border=True, filter_invalid=True,
                 pose_field=("ref_rotations", "ref_translations"),
                 bbox_field="ref_bboxes", num_points=1000):
        import glob
        from os import path as osp

        paths = sorted(glob.glob(osp.join(mesh_dir, "*.ply"))) if osp.isdir(mesh_dir) else [mesh_dir]
        verts = [load_ply(p).vertices for p in paths]
        self.mesh_vertices = [
            v[np.random.choice(v.shape[0], num_points)] for v in verts
        ]
        self.clip_border = clip_border
        self.filter_invalid = filter_invalid
        self.pose_field = pose_field
        self.bbox_field = bbox_field

    def __call__(self, results):
        labels = results["labels"]
        rotations = results[self.pose_field[0]]
        translations = results[self.pose_field[1]]
        ks = results["k"]
        bboxes = []
        for i in range(len(labels)):
            pts = project_3d_point(
                self.mesh_vertices[labels[i]], ks[i], rotations[i], translations[i]
            )
            bboxes.append(
                np.array(
                    [pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()],
                    np.float32,
                )
            )
        bboxes = np.stack(bboxes) if bboxes else np.zeros((0, 4), np.float32)
        if self.clip_border and len(bboxes):
            h, w = results["img"].shape[:2]
            bboxes[:, 0::2] = np.clip(bboxes[:, 0::2], 0, w)
            bboxes[:, 1::2] = np.clip(bboxes[:, 1::2], 0, h)
        if self.filter_invalid and len(bboxes):
            oh, ow = results["ori_shape"][:2]
            area = (bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1])
            if np.any(area > oh * ow):
                return None
        results[self.bbox_field] = bboxes
        return results


@PIPELINES.register_module("Crop")
class Crop:
    """Crop one patch per object around its reference bbox with a random
    scale; accumulates per-object transform matrices."""

    def __init__(self, size_range=(0.8, 1.2), crop_bbox_field="ref_bboxes",
                 keep_ratio=False, aspect_ratio=1.0, pad_val=128,
                 min_expand=0, clip_border=True):
        self.size_range = size_range
        self.crop_bbox_field = crop_bbox_field
        self.keep_ratio = keep_ratio
        self.aspect_ratio = aspect_ratio
        self.pad_val = pad_val
        self.min_expand = min_expand
        self.clip_border = clip_border

    def __call__(self, results):
        if len(results["labels"]) == 0:
            results["k"] = np.zeros((0, 3, 3), np.float32)
            return results
        bboxes = results[self.crop_bbox_field]
        img = results["img"]
        h, w = img.shape[:2]
        tms, crop_boxes = [], []
        for bbox in bboxes:
            size_ratio = random.uniform(*self.size_range)
            x1, y1, x2, y2 = bbox
            bw, bh = x2 - x1, y2 - y1
            xc, yc = (x1 + x2) / 2, (y1 + y2) / 2
            if not self.keep_ratio:
                bw = max(bw, bh * self.aspect_ratio)
                bh = max(bw / self.aspect_ratio, bh)
            old_w, old_h = bw, bh
            bw, bh = bw * size_ratio, bh * size_ratio
            if self.min_expand > 0:
                bw = max(old_w + 2 * self.min_expand, bw)
                bh = max(old_h + 2 * self.min_expand, bh)
            if self.clip_border:
                cx1, cx2 = int(np.clip(xc - bw / 2, 0, w)), int(np.clip(xc + bw / 2, 0, w))
                cy1, cy2 = int(np.clip(yc - bh / 2, 0, h)), int(np.clip(yc + bh / 2, 0, h))
            else:
                cx1, cx2 = int(xc - bw / 2), int(xc + bw / 2)
                cy1, cy2 = int(yc - bh / 2), int(yc + bh / 2)
            tms.append(np.array([[1, 0, -cx1], [0, 1, -cy1], [0, 0, 1]], np.float32))
            crop_boxes.append([cx1, cy1, cx2, cy2])
        crop_boxes = np.asarray(crop_boxes)
        tms = np.stack(tms)
        patches = [imcrop_pad(img, cb, self.pad_val) for cb in crop_boxes]
        results["img"] = patches
        results["img_shape"] = [p.shape for p in patches]
        results = update_transform_matrix(tms, results)
        # shift bboxes
        offset = np.stack(
            [crop_boxes[:, 0], crop_boxes[:, 1], crop_boxes[:, 0], crop_boxes[:, 1]], 1
        )
        n = len(crop_boxes)
        for field in results.get("bbox_fields", []):
            b = results[field]
            b[:n] = b[:n] - offset
            results[field] = b
        # crop masks (one mask per object patch)
        for field in results.get("mask_fields", []):
            masks = results[field]
            results[field] = [
                masks[i].crop(crop_boxes[i]) if i < n else masks[i]
                for i in range(len(masks))
            ]
        return results


@PIPELINES.register_module("Resize")
class Resize:
    def __init__(self, img_scale, keep_ratio=True):
        self.img_scale = (img_scale, img_scale) if isinstance(img_scale, int) else tuple(img_scale)
        self.keep_ratio = keep_ratio

    def __call__(self, results):
        if len(results["labels"]) == 0:
            return results
        patches = results["img"]
        out, shapes, tms, sfs = [], [], [], []
        for p in patches:
            if self.keep_ratio:
                rp, f = imrescale(p, self.img_scale)
                tms.append(np.diag([f, f, 1.0]).astype(np.float32))
                ws = hs = f
            else:
                rp, ws, hs = imresize(p, self.img_scale)
                tms.append(np.diag([ws, hs, 1.0]).astype(np.float32))
            out.append(rp)
            shapes.append(rp.shape)
            sfs.append(np.array([ws, hs, ws, hs], np.float32))
        results["img"] = out
        results["img_shape"] = shapes
        results["scale_factor"] = np.stack(sfs)
        results = update_transform_matrix(np.stack(tms), results)
        n = len(patches)
        for field in results.get("bbox_fields", []):
            b = results[field]
            b[:n] = b[:n] * results["scale_factor"]
            results[field] = b
        for field in results.get("mask_fields", []):
            masks = results[field]
            results[field] = [
                m.rescale(self.img_scale) if self.keep_ratio else m.resize(self.img_scale)
                for m in masks
            ]
        return results


@PIPELINES.register_module("Pad")
class Pad:
    def __init__(self, size=None, center=False, pad_val=None):
        assert size is not None and len(size) == 2
        self.size = tuple(size)
        self.center = center
        self.pad_val = pad_val or dict(img=0, mask=0)

    def __call__(self, results):
        if len(results["labels"]) == 0:
            results["img"] = np.zeros((0, self.size[0], self.size[1], 3), np.uint8)
            return results
        pv = self.pad_val.get("img", 0)
        patches = results["img"]
        padded, paddings, tms = [], [], []
        for img in patches:
            ih, iw = img.shape[:2]
            if self.center:
                top = int(self.size[0] / 2 - ih / 2)
                left = int(self.size[1] / 2 - iw / 2)
            else:
                top = left = 0
            bottom = self.size[0] - ih - top
            right = self.size[1] - iw - left
            padding = (left, top, right, bottom)
            padded.append(impad(img, padding, pv))
            paddings.append(padding)
            tms.append(
                np.array([[1, 0, left], [0, 1, top], [0, 0, 1]], np.float32)
            )
        results["img"] = padded
        results["padding"] = paddings
        results["img_shape"] = [p.shape for p in padded]
        # masks
        pvm = self.pad_val.get("mask", 0)
        for field in results.get("mask_fields", []):
            masks = results[field]
            new_masks = []
            for i, m in enumerate(masks):
                if i >= len(paddings):
                    new_masks.append(m)
                    continue
                left, top, _, _ = paddings[i]
                right = self.size[1] - m.width - left
                bottom = self.size[0] - m.height - top
                new_masks.append(m.pad((left, top, right, bottom), pvm))
            results[field] = new_masks
        return update_transform_matrix(np.stack(tms), results)


@PIPELINES.register_module("RemapPose")
class RemapPose:
    """Propagate the accumulated 2D transform into pose/intrinsics:
    adapt_intrinsic (K <- T K), keep_intrinsic (PnP re-solve), or
    target_intrinsic (PnP under dst_k)."""

    def __init__(self, keep_intrinsic=True, dst_k=None):
        if keep_intrinsic:
            assert dst_k is None
            self.mode = "keep_intrinsic"
            self.dst_k = None
        elif dst_k is not None:
            self.dst_k = np.array(dst_k, np.float32).reshape(3, 3)
            self.mode = "target_intrinsic"
        else:
            self.mode = "adapt_intrinsic"
            self.dst_k = None

    def __call__(self, results):
        tms = results.get("transform_matrix")
        k = results.get("k")
        if self.mode == "adapt_intrinsic":
            results["k"] = np.matmul(tms, k)
        else:
            pose_fields = results.get(
                "pose_fields", [("rotations", "translations", "keypoints_3d")]
            )
            if len(pose_fields) == 2:
                n = min(len(results[pose_fields[0][0]]), len(results[pose_fields[1][0]]))
            else:
                n = len(results[pose_fields[0][0]])
            for rf, tf, kf in pose_fields:
                R, t, kp = results[rf], results[tf], results[kf]
                newR, newT = [], []
                for i in range(n):
                    dstK = self.dst_k if self.mode == "target_intrinsic" else k[i]
                    nr, nt, _ = remap_pose(k[i], R[i], t[i], kp[i], dstK, tms[i])
                    newR.append(nr)
                    newT.append(nt)
                R[:n] = np.stack(newR)
                t[:n] = np.stack(newT)
                results[rf], results[tf] = R, t
            if self.mode == "target_intrinsic":
                results["k"] = np.repeat(self.dst_k[None], n, axis=0)
        results["geometry_transform_mode"] = self.mode
        return results



@PIPELINES.register_module("ProjectKeypoints")
class ProjectKeypoints:
    """gt_keypoints_3d (per object, in the object's frame) projected under
    the gt pose and k: gt_keypoints_2d and gt_keypoints_3d_camera, float32.
    clip_border is accepted for config compatibility; neither package
    clips."""

    def __init__(self, clip_border=False):
        self.clip_border = clip_border

    def __call__(self, results):
        kp3d = results["gt_keypoints_3d"]
        R, t, k = results["gt_rotations"], results["gt_translations"], results["k"]
        kp2d, kp3c = [], []
        for i in range(len(R)):
            p2, p3 = project_3d_point(kp3d[i], k[i], R[i], t[i], return_3d=True)
            kp2d.append(p2)
            kp3c.append(p3)
        results["gt_keypoints_2d"] = np.stack(kp2d).astype(np.float32)
        results["gt_keypoints_3d_camera"] = np.stack(kp3c).astype(np.float32)
        return results
