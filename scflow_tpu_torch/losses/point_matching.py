"""Point-matching pose losses over padded per-class vertex banks: the
port's copy of scflow_tpu/losses/point_matching.py (sym_mask_from_types,
point_matching_loss, disentangle_point_matching_loss and
rot_point_matching_loss).

Bank layout: points (C, V, 3) zero-padded vertices, valid (C, V) bool,
sym (C,) bool (symmetric classes match each target point to its nearest
predicted point), diameters (C,)."""

import numpy as np
import torch

from scflow_tpu_torch.ops.knn import nn_points


def sym_mask_from_types(symmetry_types: dict, num_class: int) -> np.ndarray:
    """{'cls_13': {...}, ...} (1-based, as the reference configs) -> (C,) bool."""
    m = np.zeros((num_class,), bool)
    for k in symmetry_types:
        idx = int(k.split("_")[-1]) - 1
        if 0 <= idx < num_class:
            m[idx] = True
    return m


def _vnorm(diff: torch.Tensor, loss_type: int) -> torch.Tensor:
    """torch.linalg.norm(dim=-1, ord=loss_type): 1 -> sum |x|, 2 -> sqrt(sum x^2)."""
    if loss_type == 1:
        return torch.sum(torch.abs(diff), dim=-1)
    return torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)


def _masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    vf = valid.to(x.dtype)
    return (x * vf).sum(dim=-1) / torch.clamp(vf.sum(dim=-1), min=1.0)


def _scale_translations(pred_t, gt_t, scale_factors, scale_xy, scale_depth,
                        scale_depth_factor):
    sp, sg = pred_t.clone(), gt_t.clone()
    if scale_xy:
        sp[..., :2] = pred_t[..., :2] * scale_factors[:, None]
        sg[..., :2] = gt_t[..., :2] * scale_factors[:, None]
    z_scale = scale_factors * scale_depth_factor if scale_depth else scale_depth_factor
    sp[..., 2] = pred_t[..., 2] * z_scale
    sg[..., 2] = gt_t[..., 2] * z_scale
    return sp, sg


def _bank(labels, points_bank, points_valid, sym_mask, diameters):
    labels = labels.long()
    return points_bank[labels], points_valid[labels], sym_mask[labels], diameters[labels]


def _matched(target: torch.Tensor, pred: torch.Tensor, valid: torch.Tensor,
             sym: torch.Tensor) -> torch.Tensor:
    """pred, with each target point's nearest valid pred point in its place
    for the symmetric classes."""
    idx, _ = nn_points(target, pred, ref_valid=valid)
    matched = torch.gather(pred, 1, idx[..., None].expand(-1, -1, 3))
    return torch.where(sym[:, None, None], matched, pred)


def point_matching_loss(pred_r, pred_t, gt_r, gt_t, labels, points_bank, points_valid,
                        sym_mask, diameters, loss_type: int = 2, loss_weight: float = 1.0,
                        scale_factors=None, scale_xy: bool = False, scale_depth: bool = False,
                        scale_depth_factor: float = 1.0) -> torch.Tensor:
    """ADD(-S)-style loss (reference point_matching_loss.py:62-103): the
    model points under the predicted and the gt pose (nearest-point matched
    for symmetric classes), the mean norm over each image's valid points
    divided by its diameter, the mean over images."""
    pts, valid, sym, diam = _bank(labels, points_bank, points_valid, sym_mask, diameters)
    sp, sg = _scale_translations(pred_t, gt_t, scale_factors, scale_xy, scale_depth,
                                 scale_depth_factor)
    pred = torch.einsum("nij,nvj->nvi", pred_r, pts) + sp[:, None]
    target = torch.einsum("nij,nvj->nvi", gt_r, pts) + sg[:, None]
    per_pt = _vnorm(_matched(target, pred, valid, sym) - target, loss_type)
    return loss_weight * (_masked_mean(per_pt, valid) / diam).mean()


def rot_point_matching_loss(pred_r, gt_r, labels, points_bank, points_valid, sym_mask,
                            diameters, loss_type: int = 2,
                            loss_weight: float = 1.0) -> torch.Tensor:
    """The rotation-only loss (reference point_matching_loss.py:222-291):
    point_matching_loss without the translations."""
    pts, valid, sym, diam = _bank(labels, points_bank, points_valid, sym_mask, diameters)
    pred = torch.einsum("nij,nvj->nvi", pred_r, pts)
    target = torch.einsum("nij,nvj->nvi", gt_r, pts)
    per_pt = _vnorm(_matched(target, pred, valid, sym) - target, loss_type)
    return loss_weight * (_masked_mean(per_pt, valid) / diam).mean()


def disentangle_point_matching_loss(pred_r, pred_t, gt_r, gt_t, labels, points_bank,
                                    points_valid, sym_mask, diameters, loss_type: int = 1,
                                    disentangle_z: bool = True, loss_weight: float = 1.0,
                                    scale_factors=None, scale_xy: bool = False,
                                    scale_depth: bool = False,
                                    scale_depth_factor: float = 1.0) -> torch.Tensor:
    """Rotation term: the model points under pred R and gt t (nearest-point
    matched for symmetric classes) against gt R, t.  Translation: with
    disentangle_z, a z term (pred z, gt rotation and xy) plus an xy term
    (pred xy, gt rotation and z); else pred t whole.  Each image's terms
    are over its valid points, divided by its diameter; mean over images
    (reference point_matching_loss.py:160-218)."""
    pts, valid, sym, diam = _bank(labels, points_bank, points_valid, sym_mask, diameters)
    sp, sg = _scale_translations(pred_t, gt_t, scale_factors, scale_xy, scale_depth,
                                 scale_depth_factor)
    pts_gt_rot = torch.einsum("nij,nvj->nvi", gt_r, pts)
    pts_gt_rt = pts_gt_rot + sg[:, None]

    pts_pred_rot = torch.einsum("nij,nvj->nvi", pred_r, pts) + sg[:, None]
    pts_pred_rot_eff = _matched(pts_gt_rt, pts_pred_rot, valid, sym)
    loss_rot = _masked_mean(_vnorm(pts_pred_rot_eff - pts_gt_rt, loss_type), valid)

    if disentangle_z:
        t_pred_z = torch.cat([sg[..., :2], sp[..., 2:3]], dim=-1)
        loss_z = _masked_mean(_vnorm(pts_gt_rot + t_pred_z[:, None] - pts_gt_rt, loss_type),
                              valid)
        t_pred_xy = torch.cat([sp[..., :2], sg[..., 2:3]], dim=-1)
        loss_xy = _masked_mean(
            _vnorm(pts_gt_rot + t_pred_xy[:, None] - pts_gt_rt, loss_type), valid)
        loss_trans = loss_z + loss_xy
    else:
        loss_trans = _masked_mean(_vnorm(pts_gt_rot + sp[:, None] - pts_gt_rt, loss_type),
                                  valid)
    return loss_weight * ((loss_rot + loss_trans) / diam).mean()
