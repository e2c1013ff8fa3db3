"""Entry points: render at the reference pose -> network -> pose (inference)
or -> sequence losses -> optimizer update (training).

Port of scflow_tpu/refiners/system.py: RenderAssets, LossAssets,
render_and_normalize, render_depth, scflow_sequence_losses,
make_scflow_train_step and make_scflow_infer_fn (the JAX signature: the
final pose, and with slim=False the final mask and flow).  Both entry points
run a model of either dtype (SCFlowRefiner(dtype=torch.bfloat16) computes in
bf16); rendering, the gt flow, the losses, the clip and AdamW are float32
either way.
"""

import copy
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scflow_tpu_torch.device import full_fp32, resolve_backend, resolve_device
from scflow_tpu_torch.geometry import filter_flow_by_mask, flow_from_pose_and_depth
from scflow_tpu_torch.losses.basic import l1_loss, raft_loss
from scflow_tpu_torch.losses.point_matching import (disentangle_point_matching_loss,
                                                    sym_mask_from_types)
from scflow_tpu_torch.ops.cuda.corr_lookup import check_variant
from scflow_tpu_torch.render.rasterizer import rasterize
from scflow_tpu_torch.render.renderer import render_batch
from scflow_tpu_torch.runtime.train_state import TrainState

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


class LossAssets(NamedTuple):
    """Padded vertex banks of the point-matching loss, on one device."""

    points: torch.Tensor  # (C, V, 3)
    valid: torch.Tensor  # (C, V) bool
    sym: torch.Tensor  # (C,) bool
    diameters: torch.Tensor  # (C,)


def loss_assets_from_bank(bank, symmetry_types: dict, mesh_diameter=None,
                          device=None) -> LossAssets:
    """bank: a MeshBank (numpy fields), for example bank.subsample(n);
    symmetry_types as the configs give them ({'cls_13': {...}, ...});
    mesh_diameter overrides the bank's diameters."""
    dev = resolve_device(device)
    diam = bank.diameters if mesh_diameter is None else mesh_diameter
    return LossAssets(
        torch.as_tensor(np.asarray(bank.verts), device=dev),
        torch.as_tensor(np.asarray(bank.vert_valid), device=dev),
        torch.as_tensor(sym_mask_from_types(symmetry_types, bank.num_class), device=dev),
        torch.as_tensor(np.asarray(diam, np.float32), device=dev))


def render_and_normalize(render_assets: RenderAssets, ref_rotations, ref_translations,
                         k, labels, image_size: Tuple[int, int], norm_mean=NORM_MEAN,
                         norm_std=NORM_STD, chunk: int = 64, backend: str = "xla",
                         augment_fn=None, augment_key=None, cull_backfaces: bool = False):
    """Render at the reference pose and normalize as the data pipeline does
    ((image - mean/255) / (std/255) on [0, 1] images).  Returns (images
    (N, H, W, 3), depths (N, H, W), masks (N, H, W)).  The arguments come in
    the JAX function's order; render augmentations (augment_fn, augment_key)
    are not ported and raise."""
    if augment_fn is not None or augment_key is not None:
        raise NotImplementedError("render augmentations are not ported")
    h, w = image_size
    out = render_batch(*render_assets, ref_rotations, ref_translations, k, labels,
                       h, w, chunk=chunk, backend=backend, cull_backfaces=cull_backfaces)
    dev = out["images"].device
    mean = torch.tensor(norm_mean, dtype=torch.float32, device=dev) / 255.0
    std = torch.tensor(norm_std, dtype=torch.float32, device=dev) / 255.0
    return (out["images"] - mean) / std, out["depths"], out["masks"]


def render_depth(render_assets: RenderAssets, rotations, translations, k, labels,
                 image_size: Tuple[int, int], chunk: int = 64, backend: str = "xla",
                 cull_backfaces: bool = False) -> torch.Tensor:
    """Depth (N, H, W) at a pose, without shading or normalization.  The
    fused kernel path bakes shading into its one kernel, so there the full
    render is the cheap way; elsewhere this only rasterizes."""
    backend = resolve_backend(backend, render_assets.verts.device)
    h, w = image_size
    if backend == "pallas" and h % 8 == 0 and w % 128 == 0:
        return render_batch(*render_assets, rotations, translations, k, labels, h, w,
                            chunk=chunk, backend=backend,
                            cull_backfaces=cull_backfaces)["depths"]
    labels = labels.long()
    verts_cam = (torch.einsum("nij,nvj->nvi", rotations, render_assets.verts[labels])
                 + translations[:, None])
    return rasterize(verts_cam, render_assets.faces[labels], render_assets.face_valid[labels],
                     k, h, w, chunk, cull_backfaces=cull_backfaces).zbuf


def scflow_sequence_losses(out: Dict[str, torch.Tensor], gt_rotations, gt_translations,
                           gt_flow, rendered_masks, labels, assets: LossAssets,
                           gamma: float = 0.8, pose_weight: float = 10.0,
                           flow_weight: float = 0.1, mask_weight: float = 10.0,
                           max_flow: float = 400.0, disentangle_z: bool = True,
                           pose_loss_type: int = 1):
    """The three exponentially weighted sequence losses (reference
    scflow_refiner.py:212-247): iteration i of T weighs gamma^(T-1-i).
    Returns (loss, log_vars) with log_vars seq_{i}_{pose,flow,mask}_loss,
    loss_pose, loss_flow, loss_mask and loss."""
    T = out["rotations"].shape[0]
    # the SIGNED sum of the flow's components, not its magnitude: the
    # reference's occlusion target (raft_refiner_flow_mask.py:193)
    gt_occ = (torch.sum(gt_flow, dim=-1) < max_flow).to(torch.float32)
    log_vars: Dict[str, torch.Tensor] = {}
    loss_pose = loss_flow = loss_mask = 0.0
    for i in range(T):
        wi = gamma ** (T - 1 - i)
        lp = disentangle_point_matching_loss(
            out["rotations"][i], out["translations"][i], gt_rotations, gt_translations, labels,
            assets.points, assets.valid, assets.sym, assets.diameters,
            loss_type=pose_loss_type, disentangle_z=disentangle_z, loss_weight=pose_weight)
        lf = raft_loss(out["flow_from_pred"][i], gt_flow, valid=rendered_masks,
                       max_flow=max_flow) * flow_weight
        lm = l1_loss(out["masks"][i], gt_occ) * mask_weight
        loss_pose = loss_pose + wi * lp
        loss_flow = loss_flow + wi * lf
        loss_mask = loss_mask + wi * lm
        log_vars[f"seq_{i}_pose_loss"] = lp
        log_vars[f"seq_{i}_flow_loss"] = lf
        log_vars[f"seq_{i}_mask_loss"] = lm
    loss = loss_pose + loss_flow + loss_mask
    log_vars.update(loss_pose=loss_pose, loss_flow=loss_flow, loss_mask=loss_mask, loss=loss)
    return loss, log_vars


def _check_lookup(backend: str, variant: str, dev: torch.device) -> None:
    """Raise now, not at the first lookup, on a name corr_lookup refuses."""
    check_variant(variant)
    if resolve_backend(backend, dev) == "xla" and variant != "tent":
        raise ValueError(f"lookup variant {variant!r} needs lookup_backend 'pallas'")


_TRAIN_KEYS = {"real_images": torch.float32, "ref_rotations": torch.float32,
               "ref_translations": torch.float32, "gt_rotations": torch.float32,
               "gt_translations": torch.float32, "labels": torch.int64, "k": torch.float32,
               "gt_masks": torch.float32}


def make_scflow_train_step(
    model,
    render_assets: RenderAssets,
    loss_assets: LossAssets,
    image_size: Tuple[int, int] = (256, 256),
    norm_mean=NORM_MEAN,
    norm_std=NORM_STD,
    max_flow: float = 400.0,
    filter_invalid_flow: bool = True,
    loss_kwargs: Optional[Dict[str, Any]] = None,
    render_chunk: int = 64,
    render_backend: str = "auto",
    render_cull_backfaces: bool = False,
    lookup_backend: str = "xla",
    donate: bool = True,
    render_augmentations: Optional[Any] = None,
    augment_seed: int = 0,
    lookup_variant: str = "tent",
    device=None,
):
    """Returns step(state, batch) -> (state, log_vars), the JAX package's
    train step: render at the reference pose (no gradient), the gt flow from
    the reference to the gt pose on the rendered depth (filtered by the gt
    mask), the network in training mode (BatchNorm on batch statistics, its
    running statistics updated in place), the sequence losses, backward,
    then clip + AdamW (state.tx).  log_vars holds scflow_sequence_losses'
    entries and grad_norm, the global norm before the clip, as 0-d tensors.

    batch: real_images (N, H, W, 3) normalized, ref_rotations,
    ref_translations, gt_rotations, gt_translations, labels, k, gt_masks
    (N, H, W), as numpy arrays or tensors.  state: a TrainState of `model`
    (moved to `device`, None meaning CUDA); render_assets and loss_assets
    must already be there.  Defaults are the JAX function's, so the lookup
    runs its tensor form ('xla'); lookup_backend='pallas' (or 'auto' on a
    card) runs the kernels: K1 forward and K1b backward, K7 or K8 forward
    with lookup_variant 'shift' or 'bdiag'.  donate=True updates the state
    in place and returns it; donate=False leaves the given state as it was
    and returns an updated copy.  Render augmentations are not ported
    (the shipped configuration has none), so augment_seed, their seed in
    the JAX signature, has nothing to seed.  The step computes in full
    float32 (device.full_fp32), whatever the global TF32 flags, and leaves
    them as it found them.  A bf16 model (SCFlowRefiner(dtype=
    torch.bfloat16)) computes its network in bf16, the kernels' bf16
    instances included (K1 or K7/K8 and K1b), while the gt flow, the
    losses, the clip and AdamW stay float32 and the gradients arrive
    float32 on the float32 parameters."""
    if render_augmentations is not None:
        raise NotImplementedError("render augmentations are not ported")
    dev = resolve_device(device)
    resolve_backend(render_backend, dev)
    _check_lookup(lookup_backend, lookup_variant, dev)
    model.to(dev)
    for assets in (render_assets, loss_assets):
        if assets[0].device != dev:
            raise ValueError(f"assets are on {assets[0].device}, the model on {dev}")
    loss_kwargs = dict(loss_kwargs or {})

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with full_fp32():
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if not donate:
            state = copy.deepcopy(state)
        b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev) for k, dt in _TRAIN_KEYS.items()}
        with torch.no_grad():
            rendered, depths, masks = render_and_normalize(
                render_assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                image_size, norm_mean, norm_std, chunk=render_chunk, backend=render_backend,
                cull_backfaces=render_cull_backfaces)
            gt_flow = flow_from_pose_and_depth(
                b["ref_rotations"], b["ref_translations"], b["gt_rotations"],
                b["gt_translations"], depths, b["k"], invalid_num=max_flow)
            if filter_invalid_flow:
                gt_flow = filter_flow_by_mask(gt_flow, b["gt_masks"], max_flow)
        out = state.model(rendered, b["real_images"], b["ref_rotations"],
                          b["ref_translations"], depths, b["k"], b["labels"], train=True,
                          lookup_backend=lookup_backend, lookup_variant=lookup_variant)
        loss, log_vars = scflow_sequence_losses(
            out, b["gt_rotations"], b["gt_translations"], gt_flow, masks, b["labels"],
            loss_assets, max_flow=max_flow, **loss_kwargs)
        state.tx.zero_grad()
        loss.backward()
        log_vars = {k: v.detach() for k, v in log_vars.items()}
        log_vars["grad_norm"] = state.apply_gradients()
        return state, log_vars

    return step


def make_scflow_infer_fn(model, render_assets: RenderAssets,
                         image_size: Tuple[int, int] = (256, 256), norm_mean=NORM_MEAN,
                         norm_std=NORM_STD, iters: Optional[int] = None,
                         render_chunk: int = 64, render_backend: str = "auto",
                         render_cull_backfaces: bool = False, lookup_backend: str = "auto",
                         unroll: bool = False, slim: bool = False,
                         lookup_variant: str = "tent", device=None):
    """Returns infer(batch) -> {"rotations" (N, 3, 3), "translations" (N, 3)}
    in the patch-intrinsics frame, the final pose; with slim=False (the
    default, as in JAX) also "masks" (N, H, W) and "flow" (N, H, W, 2), the
    final iteration's full-resolution mask and predicted flow, which the
    TensorBoard panels and serving read.  slim=True is the pose-only path of
    the reference's test-time forward: no dense depth lift, no
    full-resolution reconstructions.

    The arguments are the JAX function's, in its order, then lookup_variant
    and device.  norm_mean and norm_std normalize the rendered images as
    render_and_normalize does; iters overrides the model's iteration count.
    unroll picks the JAX decoder's loop form (lax.scan or a Python loop) and
    means nothing here, where the recurrence is one Python loop; it must be
    a bool, and unlike JAX a 1-iteration call does not override it.

    batch holds real_images (N, H, W, 3), ref_rotations (N, 3, 3),
    ref_translations (N, 3), k (N, 3, 3) and labels (N,), as numpy arrays or
    tensors.  The model moves to `device` (None means CUDA) in eval mode;
    render_assets must already be there.  render_backend 'auto' renders
    through the kernels on a card and the brute-force path on the CPU
    (device.resolve_backend); lookup_backend likewise picks the corr
    lookup's kernels or its tensor form, and lookup_variant the kernel
    ('tent' K1, 'shift' K7, 'bdiag' K8; ops/corr.py::corr_lookup), in the
    instance of the model's dtype.  A call computes in full float32
    (device.full_fp32), or in bf16 with float32 accumulation for a bf16
    model, whatever the global TF32 and bf16-reduction flags, and leaves
    them as it found them."""
    if not isinstance(unroll, bool):
        raise TypeError(f"unroll must be a bool, got {unroll!r}")
    if iters is not None and (not isinstance(iters, int) or iters < 1):
        raise ValueError(f"iters must be a positive int or None, got {iters!r}")
    dev = resolve_device(device)
    resolve_backend(render_backend, dev)  # an unknown name raises here
    _check_lookup(lookup_backend, lookup_variant, dev)
    model = model.to(dev).eval()
    if render_assets.verts.device != dev:
        raise ValueError(f"render assets are on {render_assets.verts.device}, "
                         f"the model on {dev}")

    def as_tensor(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def infer(batch: Dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), full_fp32():
            R = as_tensor(batch["ref_rotations"], torch.float32)
            t = as_tensor(batch["ref_translations"], torch.float32)
            K = as_tensor(batch["k"], torch.float32)
            labels = as_tensor(batch["labels"], torch.int64)
            real = as_tensor(batch["real_images"], torch.float32)
            rendered, depths, _ = render_and_normalize(
                render_assets, R, t, K, labels, image_size, norm_mean, norm_std,
                chunk=render_chunk, backend=render_backend,
                cull_backfaces=render_cull_backfaces)
            out = model(rendered, real, R, t, depths, K, labels, iters=iters,
                        output_sequences=False, pose_only=slim, lookup_backend=lookup_backend,
                        lookup_variant=lookup_variant)
            res = {"rotations": out["rotations"][-1], "translations": out["translations"][-1]}
            if not slim:
                res["masks"] = out["masks"][-1]
                res["flow"] = out["flow_from_pred"][-1]
            return res

    return infer
