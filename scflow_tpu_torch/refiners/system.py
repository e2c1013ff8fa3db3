"""Inference entry point: render at the reference pose -> network -> pose.

Port of scflow_tpu/refiners/system.py: RenderAssets, render_and_normalize
and make_scflow_infer_fn with slim=True (final pose only).
"""

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from scflow_tpu_torch.device import resolve_device
from scflow_tpu_torch.render.renderer import render_batch

# the data pipeline's Normalize (configs/refine_datasets/ycbv_real.py:16-17)
NORM_MEAN = (0.0, 0.0, 0.0)
NORM_STD = (255.0, 255.0, 255.0)


class RenderAssets(NamedTuple):
    """The mesh bank the renderer reads, as tensors on one device."""

    verts: torch.Tensor
    faces: torch.Tensor
    face_valid: torch.Tensor
    colors: torch.Tensor
    normals: torch.Tensor
    vert_valid: torch.Tensor

    @classmethod
    def from_bank(cls, bank, device=None) -> "RenderAssets":
        """bank: any object with the MeshBank fields as numpy arrays."""
        dev = resolve_device(device)
        return cls(*(torch.from_numpy(np.asarray(getattr(bank, k))).to(dev)
                     for k in cls._fields))


def render_and_normalize(render_assets: RenderAssets, ref_rotations, ref_translations,
                         k, labels, image_size: Tuple[int, int],
                         cull_backfaces: bool = False):
    """Render at the reference pose and normalize as the data pipeline does
    ((image - mean/255) / (std/255) on [0, 1] images).  Returns (images
    (N, H, W, 3), depths (N, H, W), masks (N, H, W))."""
    h, w = image_size
    out = render_batch(*render_assets, ref_rotations, ref_translations, k, labels,
                       h, w, cull_backfaces=cull_backfaces)
    dev = out["images"].device
    mean = torch.tensor(NORM_MEAN, dtype=torch.float32, device=dev) / 255.0
    std = torch.tensor(NORM_STD, dtype=torch.float32, device=dev) / 255.0
    return (out["images"] - mean) / std, out["depths"], out["masks"]


def make_scflow_infer_fn(model, render_assets: RenderAssets,
                         image_size: Tuple[int, int] = (256, 256),
                         render_cull_backfaces: bool = False, device=None):
    """Returns infer(batch) -> {"rotations" (N, 3, 3), "translations" (N, 3)},
    the final pose of the slim path, in the patch-intrinsics frame.

    batch holds real_images (N, H, W, 3), ref_rotations (N, 3, 3),
    ref_translations (N, 3), k (N, 3, 3) and labels (N,), as numpy arrays or
    tensors.  The model moves to `device` (None means CUDA) in eval mode;
    render_assets must already be there."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    if render_assets.verts.device != dev:
        raise ValueError(f"render assets are on {render_assets.verts.device}, "
                         f"the model on {dev}")

    def as_tensor(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def infer(batch: Dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            R = as_tensor(batch["ref_rotations"], torch.float32)
            t = as_tensor(batch["ref_translations"], torch.float32)
            K = as_tensor(batch["k"], torch.float32)
            labels = as_tensor(batch["labels"], torch.int64)
            real = as_tensor(batch["real_images"], torch.float32)
            rendered, depths, _ = render_and_normalize(
                render_assets, R, t, K, labels, image_size,
                cull_backfaces=render_cull_backfaces)
            out = model(rendered, real, R, t, depths, K, labels)
            return {"rotations": out["rotations"][-1],
                    "translations": out["translations"][-1]}

    return infer
