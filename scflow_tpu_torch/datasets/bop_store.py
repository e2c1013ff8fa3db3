"""Compact BOP annotation store: scene_gt / scene_camera / scene_gt_info as
flat numpy arrays instead of dict-of-list-of-dicts.  The port's copy of
scflow_tpu/datasets/bop_store.py on its pure-Python parser; the JAX
package's native C++ parser (native/bop_annots.cpp) gives the same arrays
and is not ported yet.
"""

import json
from typing import Optional

import numpy as np

class SceneAnnotations:
    """One BOP sequence's annotations with O(1) per-image views."""

    def __init__(self, img_ids, counts, obj_ids, R, t,
                 cam_img_ids=None, K=None, depth_scale=None,
                 info=None):
        self.img_ids = img_ids  # (N,) int64 sorted as stored
        self.counts = counts  # (N,) objects per image
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.obj_ids = obj_ids  # (M,) int32
        self.R = R  # (M, 3, 3) float32
        self.t = t  # (M, 3) float32
        self._index = {int(i): n for n, i in enumerate(img_ids)}
        self.K = None
        self.depth_scale = None
        if cam_img_ids is not None:
            cam_index = {int(i): n for n, i in enumerate(cam_img_ids)}
            order = [cam_index[int(i)] for i in img_ids]
            self.K = K[order]
            self.depth_scale = depth_scale[order]
        self.info = info  # dict of aligned (M,...) arrays or None

    def __contains__(self, img_id) -> bool:
        return int(img_id) in self._index

    def objects(self, img_id: int):
        """Per-image slice: dict of arrays for the objects in this image."""
        n = self._index[int(img_id)]
        a, b = self.offsets[n], self.offsets[n + 1]
        out = dict(
            obj_ids=self.obj_ids[a:b],
            rotations=self.R[a:b],
            translations=self.t[a:b],
        )
        if self.K is not None:
            out["cam_K"] = self.K[n]
            out["depth_scale"] = self.depth_scale[n]
        if self.info is not None:
            for k, v in self.info.items():
                out[k] = v[a:b]
        return out


def parse_scene_gt(path: str):
    with open(path) as f:
        d = json.load(f)
    img_ids, counts, obj_ids, R, t = [], [], [], [], []
    for key, anns in d.items():
        img_ids.append(int(key))
        counts.append(len(anns))
        for a in anns:
            obj_ids.append(a["obj_id"])
            R.append(a["cam_R_m2c"])
            t.append(a["cam_t_m2c"])
    return (
        np.asarray(img_ids, np.int64),
        np.asarray(counts, np.int64),
        np.asarray(obj_ids, np.int32),
        np.asarray(R, np.float32).reshape(-1, 9),
        np.asarray(t, np.float32).reshape(-1, 3),
    )


def parse_scene_camera(path: str):
    with open(path) as f:
        d = json.load(f)
    ids, K, ds = [], [], []
    for key, cam in d.items():
        ids.append(int(key))
        K.append(cam["cam_K"])
        ds.append(cam.get("depth_scale", 1.0))
    return (
        np.asarray(ids, np.int64),
        np.asarray(K, np.float32).reshape(-1, 9),
        np.asarray(ds, np.float32),
    )


def parse_scene_gt_info(path: str):
    with open(path) as f:
        d = json.load(f)
    ids, counts, bo, bv, vf, pc = [], [], [], [], [], []
    for key, infos in d.items():
        ids.append(int(key))
        counts.append(len(infos))
        for i in infos:
            bo.append(i.get("bbox_obj", [0, 0, 0, 0]))
            bv.append(i.get("bbox_visib", [0, 0, 0, 0]))
            vf.append(i.get("visib_fract", 1.0))
            pc.append(i.get("px_count_visib", 0))
    return (
        np.asarray(ids, np.int64),
        np.asarray(counts, np.int64),
        np.asarray(bo, np.float32).reshape(-1, 4),
        np.asarray(bv, np.float32).reshape(-1, 4),
        np.asarray(vf, np.float32),
        np.asarray(pc, np.int64),
    )


def load_sequence(
    gt_path: str,
    camera_path: Optional[str] = None,
    info_path: Optional[str] = None,
) -> SceneAnnotations:
    ii, cc, oo, rr, tt = parse_scene_gt(gt_path)
    cam = parse_scene_camera(camera_path) if camera_path else (None, None, None)
    info = None
    if info_path:
        ji, jc, bo, bv, vf, pc = parse_scene_gt_info(info_path)
        if not np.array_equal(ji, ii):
            raise ValueError("scene_gt_info image ids disagree with scene_gt")
        info = dict(bbox_obj=bo, bbox_visib=bv, visib_fract=vf,
                    px_count_visib=pc)
    return SceneAnnotations(
        ii, cc, oo, rr.reshape(-1, 3, 3), tt,
        cam_img_ids=cam[0], K=cam[1].reshape(-1, 3, 3) if cam[1] is not None else None,
        depth_scale=cam[2], info=info,
    )
