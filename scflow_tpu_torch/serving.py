"""Serving pipeline: full camera frames + initial poses -> refined poses, with
all the preprocessing on the card.  The port's copy of scflow_tpu/serving.py.

  1. object bboxes: project each object's padded vertex bank under its
     initial pose, min/max of the valid projections;
  2. square crop boxes (scale margin, the reference's Crop);
  3. patch extraction: an axis-aligned crop + resize as two batched
     tent-weight products per patch (JAX's einsums; plain tensor code);
  4. intrinsics adapted per patch (K' = T K, 'adapt_intrinsic'), so the
     refined poses are already in the original camera frame;
  5. render at the initial pose (the raster kernel) and the refiner's
     recurrence (the lookup kernel), through the port's infer entry points.

A serve fn holds its model, as make_scflow_infer_fn does: it is called
serve(frames, frame_idx, ref_rotations, ref_translations, K, labels), JAX's
arguments without the variables.  It computes under torch.inference_mode()
and device.full_fp32(), the infer entry points' precision.
"""

from typing import Optional, Tuple

import torch

from scflow_tpu_torch.device import full_fp32, resolve_device
from scflow_tpu_torch.refiners.system import (NORM_MEAN, NORM_STD, RenderAssets,
                                              make_raft_infer_fn, make_scflow_infer_fn)


def project_bboxes(points_bank: torch.Tensor, valid_bank: torch.Tensor,
                   rotations: torch.Tensor, translations: torch.Tensor, K: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """xyxy bboxes (P, 4) of the projected meshes (ComputeBbox, on the
    device): points_bank (C, V, 3) and valid_bank (C, V) a padded vertex
    bank, rotations (P, 3, 3), translations (P, 3), K (P, 3, 3), labels (P,)."""
    labels = labels.long()
    pts = points_bank[labels]
    valid = valid_bank[labels]
    cam = torch.einsum("pij,pvj->pvi", rotations, pts) + translations[:, None]
    uvw = torch.einsum("pij,pvj->pvi", K, cam)
    xy = uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-6)
    big = torch.tensor(1e9, dtype=xy.dtype, device=xy.device)
    x1 = torch.where(valid, xy[..., 0], big).amin(dim=1)
    y1 = torch.where(valid, xy[..., 1], big).amin(dim=1)
    x2 = torch.where(valid, xy[..., 0], -big).amax(dim=1)
    y2 = torch.where(valid, xy[..., 1], -big).amax(dim=1)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def _tent_matrix(src_start: torch.Tensor, src_step: torch.Tensor, n_out: int,
                 n_in: int) -> torch.Tensor:
    """(P, n_out, n_in) bilinear interpolation matrices for uniform sampling
    at src_start + i * src_step (per patch); zero outside [0, n_in - 1], so
    the border fades to 0 (black padding)."""
    dt, dev = src_start.dtype, src_start.device
    i = torch.arange(n_out, dtype=dt, device=dev)
    src = src_start[:, None] + i[None, :] * src_step[:, None]
    j = torch.arange(n_in, dtype=dt, device=dev)
    return torch.clamp(1.0 - torch.abs(src[..., None] - j[None, None, :]), min=0.0)


def crop_resize_patches(frames: torch.Tensor, boxes: torch.Tensor, frame_idx: torch.Tensor,
                        K: torch.Tensor, out_size: int = 256,
                        margin: float = 1.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Square crop (the box's longer side times margin, centred) resized to
    out_size, as two tent products per patch.  frames (I, Hf, Wf, 3) float
    images, boxes (P, 4) xyxy (may leave the frame), frame_idx (P,) the
    frame of each patch, K (P, 3, 3) its intrinsics.  Returns (patches
    (P, S, S, 3), K' (P, 3, 3)).  The gathered frames (P, Hf, Wf, 3) are
    materialized, as JAX's jnp.take does."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    side = torch.maximum(x2 - x1, y2 - y1) * margin
    sx1 = cx - side / 2
    sy1 = cy - side / 2
    step = side / out_size
    # sample positions at the pixel centres of the output grid
    wx = _tent_matrix(sx1 + 0.5 * step - 0.5, step, out_size, frames.shape[2]).to(frames.dtype)
    wy = _tent_matrix(sy1 + 0.5 * step - 0.5, step, out_size, frames.shape[1]).to(frames.dtype)
    imgs = frames[frame_idx.long()]
    tmp = torch.einsum("poh,phwc->powc", wy, imgs)
    patches = torch.einsum("pqw,powc->poqc", wx, tmp)

    scale = out_size / side
    zeros = torch.zeros_like(scale)
    ones = torch.ones_like(scale)
    # x' = (x - sx1) * scale at the output pixel centres; off is 0 by
    # construction (scale * step == 1), kept as JAX computes it
    off = 0.5 * scale * step - 0.5
    T = torch.stack([torch.stack([scale, zeros, -sx1 * scale + off], -1),
                     torch.stack([zeros, scale, -sy1 * scale + off], -1),
                     torch.stack([zeros, zeros, ones], -1)], dim=1)
    return patches, T @ K


def _real_images(patches: torch.Tensor, norm_mean, norm_std) -> torch.Tensor:
    mean = torch.tensor(norm_mean, dtype=torch.float32, device=patches.device) / 255.0
    std = torch.tensor(norm_std, dtype=torch.float32, device=patches.device) / 255.0
    return (patches - mean) / std


def _crop(points_bank, valid_bank, dev, image_size, margin, frames, frame_idx, ref_rotations,
          ref_translations, K, labels):
    """The serve fns' inputs as tensors on `dev`, and their patches and K'."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    R, t, K = f32(ref_rotations), f32(ref_translations), f32(K)
    labels = torch.as_tensor(labels, device=dev).long()
    frame_idx = torch.as_tensor(frame_idx, device=dev).long()
    boxes = project_bboxes(points_bank, valid_bank, R, t, K, labels)
    patches, new_k = crop_resize_patches(f32(frames), boxes, frame_idx, K, image_size, margin)
    return R, t, labels, patches, new_k


def _check_banks(points_bank, valid_bank, dev):
    for name, bank in (("points_bank", points_bank), ("valid_bank", valid_bank)):
        if bank.device != dev:
            raise ValueError(f"{name} is on {bank.device}, the model on {dev}")


def make_raft_serving_fn(model, render_assets: RenderAssets, points_bank: torch.Tensor,
                         valid_bank: torch.Tensor, image_size: int = 256, norm_mean=NORM_MEAN,
                         norm_std=NORM_STD, margin: float = 1.1, iters: Optional[int] = None,
                         render_backend: str = "auto", render_cull_backfaces: bool = False,
                         lookup_backend: str = "auto", pnp_backend: str = "host",
                         pnp_cfg=None, device=None):
    """RAFT-family serving: the SCFlow path's preprocessing, then the
    network's flow (and occlusion); the pose comes from PnP.  serve(...) ->
    {'flow' (P, S, S, 2), 'occlusion' (mask model), 'rendered_depths',
    'new_k', 'ref_rotations', 'ref_translations'}: what the host PnP
    (flow_pose.solve_poses_from_flow, the reference's test path) needs, with
    the adapted intrinsics, so its poses land in the original camera frame.
    pnp_backend='device' solves the pose on the device as well
    (flow_pose.solve_poses_from_flow_device with pnp_cfg) and adds
    'rotations', 'translations' and 'pnp_ok'.  The network runs through
    make_raft_infer_fn (its backends, precision and device rules); device
    (None: CUDA) is the port's addition to JAX's arguments."""
    dev = resolve_device(device)
    _check_banks(points_bank, valid_bank, dev)
    infer = make_raft_infer_fn(model, render_assets, image_size=(image_size, image_size),
                               norm_mean=norm_mean, norm_std=norm_std, iters=iters,
                               render_backend=render_backend,
                               render_cull_backfaces=render_cull_backfaces,
                               lookup_backend=lookup_backend, pnp_backend=pnp_backend,
                               pnp_cfg=pnp_cfg, device=dev)

    def serve(frames, frame_idx, ref_rotations, ref_translations, K, labels):
        with torch.inference_mode(), full_fp32():
            R, t, labels, patches, new_k = _crop(points_bank, valid_bank, dev, image_size, margin,
                                                 frames, frame_idx, ref_rotations,
                                                 ref_translations, K, labels)
            out = infer(dict(real_images=_real_images(patches, norm_mean, norm_std),
                             ref_rotations=R, ref_translations=t, k=new_k, labels=labels))
        res = {"flow": out["flow"], "rendered_depths": out["rendered_depths"], "new_k": new_k,
               "ref_rotations": R, "ref_translations": t}
        for k in ("occlusion", "rotations", "translations", "pnp_ok"):
            if k in out:
                res[k] = out[k]
        return res

    return serve


def make_serving_fn(model, render_assets: RenderAssets, points_bank: torch.Tensor,
                    valid_bank: torch.Tensor, image_size: int = 256, norm_mean=NORM_MEAN,
                    norm_std=NORM_STD, margin: float = 1.1, iters: Optional[int] = None,
                    render_backend: str = "auto", render_cull_backfaces: bool = False,
                    lookup_backend: str = "auto", slim: bool = False, device=None):
    """Returns serve(frames, frame_idx, ref_rotations, ref_translations, K,
    labels) -> {'rotations' (P, 3, 3), 'translations' (P, 3)} in the
    original camera frame, and with slim=False also 'masks' (P, S, S).
    frames (I, Hf, Wf, 3) in [0, 1] RGB, K (P, 3, 3) the original
    intrinsics, as numpy arrays or tensors.  Serving is the crop, then
    make_scflow_infer_fn (its backends, precision and device rules) on the
    normalized patches and K'.  slim=True runs the model pose-only, what a
    service that fetches poses needs (PoseService's default).  device
    (None: CUDA) is the port's addition to JAX's arguments."""
    dev = resolve_device(device)
    _check_banks(points_bank, valid_bank, dev)
    infer = make_scflow_infer_fn(model, render_assets, image_size=(image_size, image_size),
                                 norm_mean=norm_mean, norm_std=norm_std, iters=iters,
                                 render_backend=render_backend,
                                 render_cull_backfaces=render_cull_backfaces,
                                 lookup_backend=lookup_backend, slim=slim, device=dev)

    def serve(frames, frame_idx, ref_rotations, ref_translations, K, labels):
        with torch.inference_mode(), full_fp32():
            R, t, labels, patches, new_k = _crop(points_bank, valid_bank, dev, image_size, margin,
                                                 frames, frame_idx, ref_rotations,
                                                 ref_translations, K, labels)
            out = infer(dict(real_images=_real_images(patches, norm_mean, norm_std),
                             ref_rotations=R, ref_translations=t, k=new_k, labels=labels))
        res = {"rotations": out["rotations"], "translations": out["translations"]}
        if not slim:
            res["masks"] = out["masks"]
        return res

    return serve
