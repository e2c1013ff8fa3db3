"""The supervised training dataset: GT poses, jittered in the pipeline into
the reference poses (reference datasets/supervise_refine.py).  The port's
copy of scflow_tpu/datasets/supervise.py."""

import itertools
from os import path as osp
from typing import Optional

import numpy as np

from scflow_tpu_torch.datasets.base import BaseDataset
from scflow_tpu_torch.datasets.utils import ascii_table
from scflow_tpu_torch.registry import DATASETS


@DATASETS.register_module("SuperviseTrainDataset")
class SuperviseTrainDataset(BaseDataset):
    """Each item: `sample_num` objects (-1: all) drawn with replacement by
    np.random.choice from the image's objects that pass target_label,
    label_mapping, min_visib_fract and min_visib_px_num, with their gt
    poses, boxes, keypoints, intrinsics and mask paths, through the
    pipeline.  getitem returns None for an image with no such object
    (BaseDataset.__getitem__ then draws another image)."""

    def __init__(self, data_root, image_list, pipeline, gt_annots_root: str,
                 keypoints_json: str, keypoints_num: int, class_names: tuple,
                 min_visib_fract=0.0, min_visib_px_num=0, sample_num=1,
                 label_mapping: Optional[dict] = None, target_label: Optional[list] = None,
                 meshes_eval: Optional[str] = None, mesh_symmetry: dict = {},
                 mesh_diameter: list = []):
        super().__init__(data_root=data_root, image_list=image_list,
                         keypoints_json=keypoints_json, pipeline=pipeline,
                         class_names=class_names, label_mapping=label_mapping,
                         keypoints_num=keypoints_num, meshes_eval=meshes_eval,
                         mesh_symmetry=mesh_symmetry, mesh_diameter=mesh_diameter,
                         target_label=target_label, gt_annots_root=gt_annots_root)
        self.min_visib_fract = min_visib_fract
        self.min_visib_px_num = min_visib_px_num
        self.sample_num = sample_num
        self.mask_path_tmpl = "{:06d}/mask_visib/{:06d}_{:06d}.png"
        self.total_sample_num = self._sample_census()

    def _sample_census(self) -> str:
        """The per-class table of all and of valid samples
        (supervise_refine.py:57-86), as the JAX package counts them: valid
        by visib_fract, label_mapping and target_label (not by
        min_visib_px_num, which only getitem applies)."""
        ncls = len(self.class_names)
        total = np.zeros(ncls, np.int64)
        valid = np.zeros(ncls, np.int64)
        for store in self.gt_seq_pose_annots.values():
            ids = store.obj_ids.astype(np.int64)
            np.add.at(total, ids - 1, 1)
            ok = store.info["visib_fract"] >= self.min_visib_fract
            if self.label_mapping is not None:
                ok = ok & np.isin(ids, list(self.label_mapping))
            if self.target_label is not None:
                tl = [self.label_mapping.get(i, i) if self.label_mapping else i for i in ids]
                ok = ok & np.isin(tl, self.target_label)
            np.add.at(valid, ids[ok] - 1, 1)
        rows = [["class"] + list(self.class_names) + ["total"],
                ["total_sample_num"] + total.tolist() + [int(total.sum())],
                ["valid_sample_num"] + valid.tolist() + [int(valid.sum())]]
        return ascii_table(rows)

    def getitem(self, index):
        img_path = self.img_files[index]
        _, seq_name, _, img_name = img_path.rsplit("/", 3)
        img_id = int(osp.splitext(img_name)[0])
        objs = self.gt_seq_pose_annots[seq_name].objects(img_id)

        rotations, translations, labels, bboxes, mask_paths = [], [], [], [], []
        for i in range(len(objs["obj_ids"])):
            obj_id = int(objs["obj_ids"][i])
            if self.target_label is not None and obj_id not in self.target_label:
                continue
            if self.label_mapping is not None:
                if obj_id not in self.label_mapping:
                    continue
                obj_id = self.label_mapping[obj_id]
            if objs["visib_fract"][i] < self.min_visib_fract:
                continue
            if objs["px_count_visib"][i] < self.min_visib_px_num:
                continue
            rotations.append(objs["rotations"][i])
            translations.append(objs["translations"][i])
            labels.append(obj_id)
            bbox = objs["bbox_obj"][i].copy()
            bbox[2:] = bbox[:2] + bbox[2:]
            bboxes.append(bbox)
            mask_paths.append(osp.join(self.data_root,
                                       self.mask_path_tmpl.format(int(seq_name), img_id, i)))
        if not labels:
            return None
        rotations = np.stack(rotations)
        translations = np.stack(translations)
        labels = np.asarray(labels, np.int64) - 1
        bboxes = np.stack(bboxes)

        n = len(labels)
        sample_num = n if self.sample_num == -1 else self.sample_num
        choice = np.random.choice(n, sample_num)
        rotations, translations = rotations[choice], translations[choice]
        labels, bboxes = labels[choice], bboxes[choice]
        kp3d = self.keypoints_3d[labels]
        mask_paths = [mask_paths[c] for c in choice]
        k = np.repeat(objs["cam_K"].reshape(1, 3, 3), sample_num, axis=0)

        rd = dict(pose_fields=[("gt_rotations", "gt_translations", "gt_keypoints_3d"),
                               ("ref_rotations", "ref_translations", "ref_keypoints_3d")],
                  bbox_fields=["gt_bboxes", "ref_bboxes"], mask_fields=["gt_masks"],
                  label_fields=["labels"])
        rd["annot_fields"] = (rd["bbox_fields"] + rd["mask_fields"] + rd["label_fields"]
                              + list(itertools.chain(*rd["pose_fields"])) + ["k"])
        rd.update(gt_rotations=rotations, gt_translations=translations, gt_keypoints_3d=kp3d,
                  ref_keypoints_3d=kp3d.copy(), ori_gt_rotations=rotations.copy(),
                  ori_gt_translations=translations.copy(), labels=labels, gt_bboxes=bboxes,
                  gt_mask_path=mask_paths, k=k, ori_k=k, img_path=img_path)
        return self.transformer(rd)
