"""Refinement test/val datasets driven by external initial poses (PoseCNN et
al.): reference datasets/refine.py.  RefineDataset matches reference poses to
GT per obj_id; RefineTestDataset runs without GT (BOP export only).  The
port's copy of scflow_tpu/datasets/refine.py."""

import itertools
from os import path as osp
from typing import Optional, Sequence

import numpy as np

from scflow_tpu_torch.datasets.base import BaseDataset
from scflow_tpu_torch.registry import DATASETS


@DATASETS.register_module("RefineDataset")
class RefineDataset(BaseDataset):
    def __init__(
        self,
        data_root: str,
        image_list: str,
        pipeline: Sequence[dict],
        ref_annots_root: str,
        keypoints_json: str,
        keypoints_num: int,
        gt_annots_root: Optional[str] = None,
        filter_invalid_pose: bool = False,
        depth_range: Optional[tuple] = None,
        class_names: Optional[tuple] = None,
        label_mapping: Optional[dict] = None,
        target_label: Optional[list] = None,
        meshes_eval: Optional[str] = None,
        mesh_symmetry: dict = {},
        mesh_diameter: list = [],
    ):
        super().__init__(
            data_root=data_root,
            image_list=image_list,
            keypoints_json=keypoints_json,
            pipeline=pipeline,
            class_names=class_names,
            label_mapping=label_mapping,
            target_label=target_label,
            keypoints_num=keypoints_num,
            meshes_eval=meshes_eval,
            mesh_symmetry=mesh_symmetry,
            mesh_diameter=mesh_diameter,
            gt_annots_root=(gt_annots_root or data_root),
        )
        self.ref_annots_root = ref_annots_root
        self.filter_invalid_pose = filter_invalid_pose
        self.depth_range = depth_range
        self.mask_path_tmpl = "{:06d}/mask_visib/{:06d}_{:06d}.png"
        self.ref_seq_pose_annots = self._load_ref_annots()

    def _load_ref_annots(self):
        from scflow_tpu_torch.datasets.bop_store import load_sequence

        out = {}
        for seq in self._sequences():
            out[seq] = load_sequence(
                osp.join(self.ref_annots_root, f"{int(seq):06d}/scene_gt.json")
            )
        return out

    def getitem(self, index):
        img_path = self.img_files[index]
        _, seq_name, _, img_name = img_path.rsplit("/", 3)
        img_id = int(osp.splitext(img_name)[0])
        gt = self.gt_seq_pose_annots[seq_name].objects(img_id)
        ref = self.ref_seq_pose_annots[seq_name].objects(img_id)

        gt_rotations, gt_translations, gt_labels, gt_bboxes, gt_mask_paths = (
            [], [], [], [], []
        )
        for i in range(len(gt["obj_ids"])):
            obj_id = int(gt["obj_ids"][i])
            if self.target_label is not None and obj_id not in self.target_label:
                continue
            if self.label_mapping is not None:
                if obj_id not in self.label_mapping:
                    continue
                obj_id = self.label_mapping[obj_id]
            if gt["px_count_visib"][i] == 0:
                continue
            gt_labels.append(obj_id)
            gt_rotations.append(gt["rotations"][i])
            gt_translations.append(gt["translations"][i])
            bbox = gt["bbox_obj"][i].copy()
            bbox[2:] = bbox[:2] + bbox[2:]
            gt_bboxes.append(bbox)
            gt_mask_paths.append(
                osp.join(
                    self.gt_annots_root,
                    self.mask_path_tmpl.format(int(seq_name), img_id, i),
                )
            )
        if not gt_rotations:
            raise RuntimeError(f"{img_path} found no gt")
        gt_rotations = np.stack(gt_rotations)
        gt_translations = np.stack(gt_translations)
        gt_labels = np.asarray(gt_labels, np.int64)
        gt_bboxes = np.stack(gt_bboxes)

        ref_rotations, ref_translations, ref_labels = [], [], []
        f_gt_r, f_gt_t, f_gt_bboxes, f_gt_masks = [], [], [], []
        for i in range(len(ref["obj_ids"])):
            obj_id = int(ref["obj_ids"][i])
            if self.target_label is not None and obj_id not in self.target_label:
                continue
            if self.label_mapping is not None:
                if obj_id not in self.label_mapping:
                    continue
                obj_id = self.label_mapping[obj_id]
            translation = ref["translations"][i]
            if self.filter_invalid_pose and (
                translation[-1] > self.depth_range[-1]
                or translation[-1] < self.depth_range[0]
            ):
                continue
            if obj_id not in gt_labels:
                continue
            ref_rotations.append(ref["rotations"][i])
            ref_translations.append(translation)
            ref_labels.append(obj_id)
            gi = int(np.nonzero(gt_labels == obj_id)[0][0])
            f_gt_r.append(gt_rotations[gi])
            f_gt_t.append(gt_translations[gi])
            f_gt_bboxes.append(gt_bboxes[gi])
            f_gt_masks.append(gt_mask_paths[gi])
        if not ref_rotations:
            return None
        ref_rotations = np.stack(ref_rotations)
        ref_translations = np.stack(ref_translations)
        ref_labels = np.asarray(ref_labels, np.int64) - 1
        kp3d = self.keypoints_3d[ref_labels]
        f_gt_r, f_gt_t = np.stack(f_gt_r), np.stack(f_gt_t)
        f_gt_bboxes = np.stack(f_gt_bboxes)
        k_orig = self.gt_seq_pose_annots[seq_name].objects(img_id)["cam_K"].reshape(3, 3)
        k = np.repeat(k_orig[None], len(ref_labels), axis=0)

        rd = dict(
            pose_fields=[
                ("gt_rotations", "gt_translations", "gt_keypoints_3d"),
                ("ref_rotations", "ref_translations", "ref_keypoints_3d"),
            ],
            bbox_fields=["gt_bboxes", "ref_bboxes"],
            label_fields=["labels"],
            mask_fields=[],
        )
        rd["annot_fields"] = (
            rd["bbox_fields"] + rd["label_fields"] + rd["mask_fields"]
            + list(itertools.chain(*rd["pose_fields"]))
            + ["k", "ori_k", "transform_matrix"]
        )
        rd.update(
            ref_rotations=ref_rotations,
            ref_translations=ref_translations,
            gt_rotations=f_gt_r,
            gt_translations=f_gt_t,
            ref_keypoints_3d=kp3d,
            gt_keypoints_3d=kp3d.copy(),
            keypoints_3d=kp3d,
            labels=ref_labels,
            gt_bboxes=f_gt_bboxes,
            k=k,
            ori_k=k_orig,
            img_path=img_path,
            gt_mask_path=f_gt_masks,
            ori_gt_rotations=f_gt_r.copy(),
            ori_gt_translations=f_gt_t.copy(),
            ori_ref_rotations=ref_rotations.copy(),
            ori_ref_translations=ref_translations.copy(),
        )
        out = self.transformer(rd)
        if out is None:
            raise RuntimeError(f"pipeline broken for {img_path}")
        return out


@DATASETS.register_module("RefineTestDataset")
class RefineTestDataset(BaseDataset):
    """No-GT variant: initial poses only, for BOP-format submission runs
    (reference datasets/refine.py:221-366)."""

    def __init__(
        self,
        data_root: str,
        image_list: str,
        pipeline: Sequence[dict],
        ref_annots_root: str,
        keypoints_json: str,
        keypoints_num: int,
        class_names: Optional[tuple] = None,
        label_mapping: Optional[dict] = None,
        target_label: Optional[list] = None,
        meshes_eval: Optional[str] = None,
        mesh_symmetry: dict = {},
        mesh_diameter: list = [],
    ):
        super().__init__(
            data_root=data_root,
            image_list=image_list,
            keypoints_json=keypoints_json,
            pipeline=pipeline,
            class_names=class_names,
            label_mapping=label_mapping,
            target_label=target_label,
            keypoints_num=keypoints_num,
            meshes_eval=meshes_eval,
            mesh_symmetry=mesh_symmetry,
            mesh_diameter=mesh_diameter,
        )
        self.ref_annots_root = ref_annots_root
        self.ref_seq_pose_annots = self._load_ref_annots()

    def _load_ref_annots(self):
        from scflow_tpu_torch.datasets.bop_store import load_sequence

        out = {}
        for seq in self._sequences():
            out[seq] = load_sequence(
                osp.join(self.ref_annots_root, f"{int(seq):06d}/scene_gt.json"),
                osp.join(self.data_root, f"{int(seq):06d}/scene_camera.json"),
            )
        return out

    def getitem(self, index):
        img_path = self.img_files[index]
        _, seq_name, _, img_name = img_path.rsplit("/", 3)
        img_id = int(osp.splitext(img_name)[0])
        ref = self.ref_seq_pose_annots[seq_name].objects(img_id)

        ref_rotations, ref_translations, ref_labels = [], [], []
        for i in range(len(ref["obj_ids"])):
            obj_id = int(ref["obj_ids"][i])
            if self.target_label is not None and obj_id not in self.target_label:
                continue
            if self.label_mapping is not None:
                if obj_id not in self.label_mapping:
                    continue
                obj_id = self.label_mapping[obj_id]
            ref_rotations.append(ref["rotations"][i])
            ref_translations.append(ref["translations"][i])
            ref_labels.append(obj_id)
        if not ref_rotations:
            return None
        ref_rotations = np.stack(ref_rotations)
        ref_translations = np.stack(ref_translations)
        ref_labels = np.asarray(ref_labels, np.int64) - 1
        kp3d = self.keypoints_3d[ref_labels]
        k_orig = ref["cam_K"].reshape(3, 3)
        k = np.repeat(k_orig[None], len(ref_labels), axis=0)

        rd = dict(
            pose_fields=[("ref_rotations", "ref_translations", "ref_keypoints_3d")],
            bbox_fields=["ref_bboxes"],
            label_fields=["labels"],
            mask_fields=[],
        )
        rd["annot_fields"] = (
            rd["bbox_fields"] + rd["label_fields"]
            + ["ref_rotations", "ref_translations", "ref_keypoints_3d"]
            + ["k", "ori_k", "transform_matrix"]
        )
        rd.update(
            ref_rotations=ref_rotations,
            ref_translations=ref_translations,
            ref_keypoints_3d=kp3d,
            keypoints_3d=kp3d,
            labels=ref_labels,
            k=k,
            ori_k=k_orig,
            img_path=img_path,
            ori_ref_rotations=ref_rotations.copy(),
            ori_ref_translations=ref_translations.copy(),
        )
        out = self.transformer(rd)
        if out is None:
            raise RuntimeError(f"pipeline broken for {img_path}")
        return out
