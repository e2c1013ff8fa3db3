"""Entry points: render at the reference pose -> network -> pose (inference)
or -> sequence losses -> optimizer update (training).

Port of scflow_tpu/refiners/system.py: RenderAssets, LossAssets,
render_and_normalize, render_depth, scflow_sequence_losses,
make_scflow_train_step, make_scflow_infer_fn (the JAX signature: the
final pose, and with slim=False the final mask and flow) and
make_scflow_cycled_infer_fn (the reference's multi-pass refinement), and the RAFT
baseline's make_raft_train_step, make_raft_infer_fn (the flow, and with
pnp_backend='device' the pose from it) and make_raft_val_step.  Every entry
point runs a model of either dtype (dtype=torch.bfloat16 computes the
network in bf16); rendering, the gt flow, the losses, PnP, the clip and
AdamW are float32 either way.
"""

import copy
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scflow_tpu_torch.device import full_fp32, resolve_backend, resolve_device
from scflow_tpu_torch.geometry import (cal_epe, filter_flow_by_depth, filter_flow_by_mask,
                                       flow_from_pose_and_depth)
from scflow_tpu_torch.losses.basic import l1_loss, raft_loss
from scflow_tpu_torch.losses.point_matching import (disentangle_point_matching_loss,
                                                    sym_mask_from_types)
from scflow_tpu_torch.models.augment import build_render_augmentation
from scflow_tpu_torch.ops.cuda.corr_lookup import check_variant, check_window
from scflow_tpu_torch.parallel.dist import average_gradients, average_logs, global_batch
from scflow_tpu_torch.pnp import hypothesis_uniforms
from scflow_tpu_torch.refiners.flow_pose import flow_only_score, solve_poses_from_flow_device
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
    the JAX function's order.  augment_fn (models/augment.py, the
    render_augmentations config key) runs as augment_fn(augment_key, images)
    on the [0, 1] rendered images BEFORE normalization, the reference's
    order (base_refiner.py:159-166)."""
    h, w = image_size
    out = render_batch(*render_assets, ref_rotations, ref_translations, k, labels,
                       h, w, chunk=chunk, backend=backend, cull_backfaces=cull_backfaces)
    images = out["images"]
    if augment_fn is not None:
        images = augment_fn(augment_key, images)
    dev = images.device
    mean = torch.tensor(norm_mean, dtype=torch.float32, device=dev) / 255.0
    std = torch.tensor(norm_std, dtype=torch.float32, device=dev) / 255.0
    return (images - mean) / std, out["depths"], out["masks"]


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


def _check_lookup(model, backend: str, variant: str, dev: torch.device,
                  image_size: Tuple[int, int]) -> None:
    """Raise now, not at the first lookup, on what corr_lookup refuses: an
    unknown name; on the card, 'pallas' asked for on an image that is not
    square (no kernel takes such maps; 'xla' runs them); and, where the
    lookup runs the kernels ('pallas', on the card or as their plain
    versions on the CPU), a window no kernel takes: a negative radius or no
    levels (corr_lookup.check_window; every other window launches)."""
    check_variant(variant)
    square = image_size[0] == image_size[1]
    if backend == "pallas" and dev.type == "cuda" and not square:
        raise ValueError(f"lookup_backend 'pallas' needs a square image on the card, got "
                         f"{image_size[0]}x{image_size[1]}; pass 'xla' (the JAX package's "
                         f"own route for such maps)")
    if variant != "tent" and not square:
        raise ValueError(f"lookup variant {variant!r} needs a square image")
    backend = resolve_backend(backend, dev)
    if backend == "xla" and variant != "tent":
        raise ValueError(f"lookup variant {variant!r} needs lookup_backend 'pallas'")
    if backend == "pallas" and square:
        check_window(variant, model.decoder.num_levels, model.decoder.radius)


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
    process_group=None,
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
    and returns an updated copy.  render_augmentations (a config list,
    models/augment.py) augments the rendered images before normalization,
    keyed by (augment_seed, state.step), so a run is deterministic and
    resumes exactly (JAX folds the step into PRNGKey(augment_seed); the
    draws differ from jax.random's).  The step computes in full
    float32 (device.full_fp32), whatever the global TF32 flags, and leaves
    them as it found them.  A bf16 model (SCFlowRefiner(dtype=
    torch.bfloat16)) computes its network in bf16, the kernels' bf16
    instances included (K1 or K7/K8 and K1b), while the gt flow, the
    losses, the clip and AdamW stay float32 and the gradients arrive
    float32 on the float32 parameters.

    process_group (torch.distributed.group.WORLD, or a subgroup; None: this
    process alone) makes the step data-parallel, JAX's step on the sharded
    global batch: each rank passes its local batch (equal shapes on every
    rank), and BatchNorm's training statistics, the flow loss's valid-pixel
    count and the augmentations' draws are the global batch's
    (parallel/dist.py::global_batch); the gradients are averaged over the
    ranks before the clip and the update, and log_vars (grad_norm included)
    are the global batch's on every rank."""
    augment_fn = build_render_augmentation(render_augmentations)
    dev = resolve_device(device)
    resolve_backend(render_backend, dev)
    _check_lookup(model, lookup_backend, lookup_variant, dev, image_size)
    model.to(dev)
    for assets in (render_assets, loss_assets):
        if assets[0].device != dev:
            raise ValueError(f"assets are on {assets[0].device}, the model on {dev}")
    loss_kwargs = dict(loss_kwargs or {})

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with full_fp32(), global_batch(process_group):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if not donate:
            state = copy.deepcopy(state)
        b = {k: torch.as_tensor(batch[k], dtype=dt, device=dev) for k, dt in _TRAIN_KEYS.items()}
        with torch.no_grad():
            rendered, depths, masks = render_and_normalize(
                render_assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                image_size, norm_mean, norm_std, chunk=render_chunk, backend=render_backend,
                cull_backfaces=render_cull_backfaces, augment_fn=augment_fn,
                augment_key=(augment_seed, state.step) if augment_fn is not None else None)
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
        average_gradients(state.tx.params, process_group)
        log_vars = average_logs({k: v.detach() for k, v in log_vars.items()}, process_group)
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
    _check_lookup(model, lookup_backend, lookup_variant, dev, image_size)
    model = model.to(dev).eval()
    if render_assets.verts.device != dev:
        raise ValueError(f"render assets are on {render_assets.verts.device}, "
                         f"the model on {dev}")

    def as_tensor(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def body(batch: Dict) -> Dict[str, torch.Tensor]:
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
                    output_sequences=False, unroll=unroll, pose_only=slim,
                    lookup_backend=lookup_backend, lookup_variant=lookup_variant)
        res = {"rotations": out["rotations"][-1], "translations": out["translations"][-1]}
        if not slim:
            res["masks"] = out["masks"][-1]
            res["flow"] = out["flow_from_pred"][-1]
        return res

    return _with_contexts(body, lambda batch_size: body, dev)


def _with_contexts(body, trace_body, dev: torch.device):
    """The live call: body(batch) under torch.inference_mode() and
    device.full_fp32().  The call carries `trace_body(batch_size)`, the
    body for batches of that size without those contexts (they are run-time
    flags, not graph operations; runtime/export.py traces the body and the
    loaded program applies them again; None: any size), and `device`."""

    def infer(batch: Dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), full_fp32():
            return body(batch)

    infer.trace_body = trace_body
    infer.device = dev
    return infer


def make_scflow_cycled_infer_fn(model, render_assets: RenderAssets, cycles: int = 2,
                                image_size: Tuple[int, int] = (256, 256), norm_mean=NORM_MEAN,
                                norm_std=NORM_STD, iters: Optional[int] = None,
                                render_chunk: int = 64, render_backend: str = "auto",
                                render_cull_backfaces: bool = False,
                                lookup_backend: str = "auto", unroll: bool = False,
                                slim: bool = False, lookup_variant: str = "tent", device=None):
    """Multi-pass refinement (reference forward_multiple_pass,
    base_refiner.py:249-260): after each cycle the object is re-rendered at
    the refined pose and refined again, `cycles` times in all.  The
    intermediate cycles run pose-only; slim controls only the last cycle's
    outputs, as in make_scflow_infer_fn (whose arguments these are, with
    cycles after render_assets as in JAX's signature)."""
    if not isinstance(cycles, int) or cycles < 1:
        raise ValueError(f"cycles must be a positive int, got {cycles!r}")
    steps = [make_scflow_infer_fn(
        model, render_assets, image_size=image_size, norm_mean=norm_mean, norm_std=norm_std,
        iters=iters, render_chunk=render_chunk, render_backend=render_backend,
        render_cull_backfaces=render_cull_backfaces, lookup_backend=lookup_backend,
        unroll=unroll, slim=slim or not last, lookup_variant=lookup_variant, device=device)
        for last in (False, True)]

    def cycled(bodies):
        def body(batch: Dict) -> Dict[str, torch.Tensor]:
            batch = dict(batch)
            for cycle in range(cycles):
                out = bodies[cycle == cycles - 1](batch)
                batch["ref_rotations"], batch["ref_translations"] = (out["rotations"],
                                                                     out["translations"])
            return out

        return body

    return _with_contexts(cycled([step.trace_body(None) for step in steps]),
                          lambda n: cycled([step.trace_body(n) for step in steps]),
                          steps[0].device)


def _raft_setup(model, render_assets: RenderAssets, render_backend: str, lookup_backend: str,
                lookup_variant: str, device, image_size: Tuple[int, int]):
    """Check the names, move the model to the device and return a batch
    reader: the batch's keys of the train step's, numpy arrays or tensors,
    as tensors of their dtypes there."""
    dev = resolve_device(device)
    resolve_backend(render_backend, dev)
    _check_lookup(model, lookup_backend, lookup_variant, dev, image_size)
    model.to(dev)
    if render_assets.verts.device != dev:
        raise ValueError(f"render assets are on {render_assets.verts.device}, the model on {dev}")

    def read(batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k], dtype=dt, device=dev)
                for k, dt in _TRAIN_KEYS.items() if k in batch}

    return read


def _gt_flow(b: Dict[str, torch.Tensor], depths: torch.Tensor, max_flow: float) -> torch.Tensor:
    return flow_from_pose_and_depth(b["ref_rotations"], b["ref_translations"],
                                    b["gt_rotations"], b["gt_translations"], depths, b["k"],
                                    invalid_num=max_flow)


def make_raft_train_step(
    model,
    render_assets: RenderAssets,
    image_size: Tuple[int, int] = (256, 256),
    norm_mean=NORM_MEAN,
    norm_std=NORM_STD,
    max_flow: float = 400.0,
    filter_invalid_flow_by_mask: bool = True,
    filter_invalid_flow_by_depth: bool = False,
    gamma: float = 0.8,
    flow_weight: float = 1.0,
    occlusion_weight: float = 100.0,
    render_chunk: int = 64,
    render_backend: str = "auto",
    render_cull_backfaces: bool = False,
    lookup_backend: str = "xla",
    donate: bool = True,
    render_augmentations: Optional[Any] = None,
    augment_seed: int = 0,
    lookup_variant: str = "tent",
    device=None,
    process_group=None,
):
    """Returns step(state, batch) -> (state, log_vars) for a RAFT refiner
    (refiners/raft.py), the JAX function's step (reference
    raft_refiner_flow_mask.py:169-222): render at the reference pose, the gt
    flow to the gt pose on the rendered depth (no gradient), filtered by
    the gt mask and, with filter_invalid_flow_by_depth, by the depth
    rendered at the gt pose; the occlusion target is the SIGNED sum of the
    gt flow's components < max_flow (the reference's training target; the
    val step uses the magnitude).  The network runs in training mode
    (BatchNorm on batch statistics), the loss is, over the T iterations
    with weight gamma^(T-1-i), flow_weight x raft_loss(flow_i, gt flow,
    rendered mask) + occlusion_weight x l1_loss(occlusion_i, target); then
    backward, clip + AdamW (state.tx).  log_vars: seq_{i}_flow_loss,
    seq_{i}_occ_loss (mask model), loss_flow, loss_occ, loss and
    grad_norm (the global norm before the clip, fp32), as 0-d tensors.

    batch: real_images, ref_rotations, ref_translations, gt_rotations,
    gt_translations, labels, k, gt_masks.  The defaults are JAX's, so the
    lookup is its tensor form ('xla'); lookup_backend='pallas' runs K1
    forward and K1b backward (no flow gradient: the decoder detaches the
    flow).  donate, device, lookup_variant, precision (device.full_fp32)
    and dtypes as in make_scflow_train_step, and so are render_augmentations,
    augment_seed and process_group (the data-parallel step)."""
    augment_fn = build_render_augmentation(render_augmentations)
    read = _raft_setup(model, render_assets, render_backend, lookup_backend, lookup_variant,
                       device, image_size)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with full_fp32(), global_batch(process_group):
            return _step(state, batch)

    def _step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if not donate:
            state = copy.deepcopy(state)
        b = read(batch)
        with torch.no_grad():
            rendered, depths, masks = render_and_normalize(
                render_assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                image_size, norm_mean, norm_std, chunk=render_chunk, backend=render_backend,
                cull_backfaces=render_cull_backfaces, augment_fn=augment_fn,
                augment_key=(augment_seed, state.step) if augment_fn is not None else None)
            gt_flow = _gt_flow(b, depths, max_flow)
            if filter_invalid_flow_by_mask:
                gt_flow = filter_flow_by_mask(gt_flow, b["gt_masks"], max_flow)
            if filter_invalid_flow_by_depth:
                gt_depths = render_depth(render_assets, b["gt_rotations"], b["gt_translations"],
                                         b["k"], b["labels"], image_size, chunk=render_chunk,
                                         backend=render_backend,
                                         cull_backfaces=render_cull_backfaces)
                gt_flow = filter_flow_by_depth(gt_flow, gt_depths, depths, max_flow)
            gt_occ = (torch.sum(gt_flow, dim=-1) < max_flow).to(torch.float32)
        out = state.model(rendered, b["real_images"], train=True, lookup_backend=lookup_backend,
                          lookup_variant=lookup_variant)
        T = out["flow"].shape[0]
        log_vars: Dict[str, torch.Tensor] = {}
        loss_flow = loss_occ = 0.0
        for i in range(T):
            wi = gamma ** (T - 1 - i)
            lf = raft_loss(out["flow"][i], gt_flow, valid=masks, max_flow=max_flow) * flow_weight
            loss_flow = loss_flow + wi * lf
            log_vars[f"seq_{i}_flow_loss"] = lf
            if "occlusion" in out:
                lo = l1_loss(out["occlusion"][i], gt_occ) * occlusion_weight
                loss_occ = loss_occ + wi * lo
                log_vars[f"seq_{i}_occ_loss"] = lo
        loss = loss_flow + loss_occ
        log_vars.update(loss_flow=loss_flow, loss=loss)
        if "occlusion" in out:
            log_vars["loss_occ"] = loss_occ
        state.tx.zero_grad()
        loss.backward()
        average_gradients(state.tx.params, process_group)
        log_vars = average_logs({k: v.detach() for k, v in log_vars.items()}, process_group)
        log_vars["grad_norm"] = state.apply_gradients()
        return state, log_vars

    return step


PNP_BACKENDS = ("host", "device")


def make_raft_infer_fn(model, render_assets: RenderAssets,
                       image_size: Tuple[int, int] = (256, 256), norm_mean=NORM_MEAN,
                       norm_std=NORM_STD, iters: Optional[int] = None, render_chunk: int = 64,
                       render_backend: str = "auto", render_cull_backfaces: bool = False,
                       lookup_backend: str = "auto", pnp_backend: str = "host",
                       pnp_cfg: Optional[Dict[str, Any]] = None, lookup_variant: str = "tent",
                       device=None):
    """Returns infer(batch) -> {"flow" (N, H, W, 2), "occlusion" (N, H, W)
    (mask model), "rendered_depths", "rendered_masks" (N, H, W)}: the final
    iteration's full-resolution flow from the rendered to the real image,
    and the render the host PnP (flow_pose.solve_poses_from_flow) reads.
    Only the final iteration is upsampled (the decoder's
    output_sequences=False), which is what JAX's jitted call computes.

    pnp_backend 'device' also solves the pose on the card
    (flow_pose.solve_poses_from_flow_device with pnp_cfg: occ_thresh,
    num_points, num_hypotheses, reprojection_error, generator) and adds
    "rotations" (N, 3, 3), "translations" (N, 3) and "pnp_ok" (N,);
    'host' leaves the pose to the caller; any other name raises.  Without a
    generator the PnP's random draws (the flow-only score, the hypotheses'
    uniforms) are made once on the device, the uniforms once per batch
    size, from the seeds each call drew them from before (7 and 0), so a
    call gives the same poses and an export holds no generator; with one,
    each call draws from it and the infer fn cannot be exported.

    batch: real_images, ref_rotations, ref_translations, k, labels.  The
    arguments are the JAX function's, in its order, then lookup_variant and
    device (None: CUDA), with make_scflow_infer_fn's rules for the
    backends, the device and the precision (device.full_fp32)."""
    if pnp_backend not in PNP_BACKENDS:
        raise ValueError(f"unknown pnp_backend {pnp_backend!r}; expected one of {PNP_BACKENDS}")
    if iters is not None and (not isinstance(iters, int) or iters < 1):
        raise ValueError(f"iters must be a positive int or None, got {iters!r}")
    pnp_cfg = dict(pnp_cfg or {})
    read = _raft_setup(model, render_assets, render_backend, lookup_backend, lookup_variant,
                       device, image_size)
    model.eval()
    dev = render_assets.verts.device
    drawn = pnp_backend == "device" and pnp_cfg.get("generator") is None
    if drawn:
        # the device PnP's draws, made once (the flow-only score) and once per
        # batch size (the hypotheses' uniforms), from the seeds each call drew
        # them from before: the same values, and no generator in a traced graph
        h, w = image_size
        shape = (pnp_cfg.get("num_hypotheses", 64), min(pnp_cfg.get("num_points", 1024), h * w))
        pnp_cfg["flow_score"] = flow_only_score(h, w, dev)
        uniforms = {}

    def make_body(pnp_kw):
        def body(batch: Dict) -> Dict[str, torch.Tensor]:
            b = read(batch)
            rendered, depths, masks = render_and_normalize(
                render_assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                image_size, norm_mean, norm_std, chunk=render_chunk, backend=render_backend,
                cull_backfaces=render_cull_backfaces)
            out = model(rendered, b["real_images"], iters=iters, lookup_backend=lookup_backend,
                        lookup_variant=lookup_variant, output_sequences=False)
            res = {"flow": out["flow"][-1], "rendered_depths": depths, "rendered_masks": masks}
            if "occlusion" in out:
                res["occlusion"] = out["occlusion"][-1]
            if pnp_backend == "device":
                R, t, ok = solve_poses_from_flow_device(
                    res["flow"], depths, b["ref_rotations"], b["ref_translations"], b["k"],
                    occlusion=res.get("occlusion"), **pnp_kw(depths.shape[0]))
                res.update(rotations=R, translations=t, pnp_ok=ok)
            return res

        return body

    def live_kw(n: int) -> Dict[str, Any]:
        if not drawn:
            return pnp_cfg
        if n not in uniforms:
            uniforms[n] = hypothesis_uniforms(n, *shape, device=dev)
        return {**pnp_cfg, "uniforms": uniforms[n]}

    def trace_body(batch_size: int):
        if not drawn and pnp_backend == "device":
            raise ValueError("pnp_cfg's generator draws the device PnP's hypotheses on every "
                             "call, and torch.export cannot trace a torch.Generator: build "
                             "the infer fn without one to export it")
        kw = pnp_cfg
        if drawn:
            kw = {**pnp_cfg, "uniforms": hypothesis_uniforms(batch_size, *shape, device=dev)}
        return make_body(lambda n: kw)

    return _with_contexts(make_body(live_kw), trace_body, dev)


def make_raft_val_step(model, render_assets: RenderAssets,
                       image_size: Tuple[int, int] = (256, 256), norm_mean=NORM_MEAN,
                       norm_std=NORM_STD, max_flow: float = 400.0, iters: Optional[int] = None,
                       render_backend: str = "auto", render_cull_backfaces: bool = False,
                       lookup_backend: str = "auto", lookup_variant: str = "tent",
                       device=None):
    """Returns val_step(batch) -> metrics (0-d tensors), the JAX function's
    (reference raft_refiner_flow_mask.py:241-283): the final flow's EPE
    against the gt flow over the batch (epe_mean, epe_1px, epe_3px,
    epe_5px), with gt_masks in the batch the same against the gt flow
    filtered by the mask (epe_noc_*), and for the mask model "occ", the
    mean |target - occlusion| with the target the flow MAGNITUDE < max_flow
    (of the filtered flow where there are gt_masks).  batch: as the train
    step's, gt_masks optional.  Arguments and rules as make_raft_infer_fn's
    (JAX's val step renders with the default chunk and takes none)."""
    read = _raft_setup(model, render_assets, render_backend, lookup_backend, lookup_variant,
                       device, image_size)
    model.eval()

    def val_step(batch: Dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), full_fp32():
            b = read(batch)
            rendered, depths, _ = render_and_normalize(
                render_assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                image_size, norm_mean, norm_std, backend=render_backend,
                cull_backfaces=render_cull_backfaces)
            out = model(rendered, b["real_images"], iters=iters, lookup_backend=lookup_backend,
                        lookup_variant=lookup_variant, output_sequences=False)
            flow = out["flow"][-1]
            gt_flow = _gt_flow(b, depths, max_flow)
            metrics = {f"epe_{k}": v for k, v in cal_epe(gt_flow, flow, None, max_flow=max_flow,
                                                         reduction="total_mean").items()}
            if "gt_masks" in b:
                gt_flow = filter_flow_by_mask(gt_flow, b["gt_masks"], max_flow)
                metrics.update({f"epe_noc_{k}": v for k, v in cal_epe(
                    gt_flow, flow, None, max_flow=max_flow, reduction="total_mean").items()})
            occ_gt = (torch.sqrt(torch.sum(gt_flow ** 2, dim=-1)) < max_flow).to(torch.float32)
            if "occlusion" in out:
                metrics["occ"] = torch.abs(occ_gt - out["occlusion"][-1]).mean()
            return metrics

    return val_step
