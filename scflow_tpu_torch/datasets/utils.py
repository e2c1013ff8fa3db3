"""Dataset utilities: compact BOP json dumping, simple ascii tables
(replacing terminaltables), numpy point projection and pairwise mask
areas.  The port's copy of scflow_tpu/datasets/utils.py."""

import json
from typing import Any, List

import numpy as np


def dumps_json(content: Any) -> str:
    """Compact json like the reference's BOP export helper
    (datasets/utils.py:39-68): nested per-image lists on single lines."""

    def default(o):
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    if isinstance(content, dict):
        lines = ["{"]
        keys = list(content.keys())
        for i, k in enumerate(keys):
            tail = "," if i < len(keys) - 1 else ""
            lines.append(
                f'  "{k}": {json.dumps(content[k], default=default)}{tail}'
            )
        lines.append("}")
        return "\n".join(lines)
    return json.dumps(content, default=default)


def ascii_table(table_data: List[List[Any]]) -> str:
    """Minimal AsciiTable replacement for metric printing."""
    cols = len(table_data[0])
    widths = [0] * cols
    rows = [[str(c) for c in row] for row in table_data]
    for row in rows:
        for i, c in enumerate(row):
            widths[i] = max(widths[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    for j, row in enumerate(rows):
        out.append(
            "|" + "|".join(f" {c:<{widths[i]}} " for i, c in enumerate(row)) + "|"
        )
        if j == 0:
            out.append(sep)
    out.append(sep)
    return "\n".join(out)


def project_3d_points_np(pt3d, K, rotation, translation):
    """Points (V, 3) under K (3, 3) or (N, 3, 3), R (3, 3) or (N, 3, 3) and
    t (3,) or (N, 3) -> (pixels (V, 2), camera points (V, 3)), or (N, V, 2)
    and (N, V, 3) for batched poses; numpy (reference datasets/pose.py:
    18-76), uv / (w + 1e-8)."""
    single = rotation.ndim == 2
    R = rotation[None] if single else rotation
    t = translation.reshape(-1, 3) if translation.ndim <= 2 else translation
    Kb = K[None] if K.ndim == 2 else K
    cam = np.einsum("nij,vj->nvi", R, pt3d) + t[:, None]
    uvw = np.einsum("nij,nvj->nvi", Kb, cam)
    xy = uvw[..., :2] / (uvw[..., 2:3] + 1e-8)
    if single:
        return xy[0], cam[0]
    return xy, cam


def intersect_and_union(pred_mask, gt_mask):
    """Pairwise areas of P predicted and G ground-truth binary masks
    (reference tools/eval.py:218-261): (intersections (G, P), unions (G, P),
    predicted areas (P,), gt areas (G,)).  Masks are arrays (N, H, W),
    cast to bool; gt may be a BitmapMasks."""
    from scflow_tpu_torch.datasets.mask import BitmapMasks

    if isinstance(gt_mask, BitmapMasks):
        gt_mask = gt_mask.masks
    gt_mask = np.asarray(gt_mask)
    pred_mask = np.asarray(pred_mask)
    if gt_mask.dtype != np.bool_:
        gt_mask = gt_mask.astype(np.bool_)
    if pred_mask.dtype != np.bool_:
        pred_mask = pred_mask.astype(np.bool_)
    intersect = pred_mask[None] & gt_mask[:, None]
    area_intersect = intersect.sum(axis=(-1, -2))
    area_pred = pred_mask.sum(axis=(-1, -2))
    area_gt = gt_mask.sum(axis=(-1, -2))
    area_union = area_gt[..., None] + area_pred[None] - area_intersect
    return area_intersect, area_union, area_pred, area_gt
