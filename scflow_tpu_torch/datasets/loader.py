"""Batch collation of the evaluation loop: the port's copy of
scflow_tpu/datasets/loader.py::collate_batch.  The threaded and process
DataLoader comes with the train workflow."""

from typing import Any, Dict, List

import numpy as np


def collate_batch(samples: List[Dict], train: bool = True) -> Dict[str, np.ndarray]:
    """Flatten per-image object patches into one dense batch (the reference
    does this inside format_data_*, base_refiner.py:85-91,146-151).

    Returns arrays keyed for the train/infer steps plus 'img_metas' (list,
    host-only) and 'per_img_patch_num' for regrouping at eval."""
    out: Dict[str, Any] = {}
    per_img = [len(s["annots"]["labels"]) for s in samples]
    out["per_img_patch_num"] = per_img
    out["img_metas"] = [s["img_metas"] for s in samples]

    imgs = np.concatenate([np.asarray(s["img"], np.float32) for s in samples], axis=0)
    out["real_images"] = imgs

    def cat(key, dtype=np.float32):
        return np.concatenate(
            [np.asarray(s["annots"][key], dtype) for s in samples], axis=0
        )

    a0 = samples[0]["annots"]
    out["ref_rotations"] = cat("ref_rotations")
    out["ref_translations"] = cat("ref_translations")
    out["labels"] = cat("labels", np.int32)
    out["k"] = cat("k")
    if "gt_rotations" in a0:
        out["gt_rotations"] = cat("gt_rotations")
        out["gt_translations"] = cat("gt_translations")
    if "gt_masks" in a0:
        masks = []
        for s in samples:
            masks.append(s["annots"]["gt_masks"].to_array(np.float32))
        out["gt_masks"] = np.concatenate(masks, axis=0)
    for key in ("init_add_error", "init_rot_error", "init_trans_error"):
        if key in a0:
            out[key] = cat(key)
    return out
