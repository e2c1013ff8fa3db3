"""Config-driven builders of the test and train workflows: config dict ->
render and loss assets, model weights (seeded, pretrained, or from a
checkpoint), the inference call, the serving pipeline, the train step,
the evaluation callable and the TensorBoard panels.  The port's copy of
scflow_tpu/apis.py (used by cli.test_main, cli.train_main and
cli.serve_main)."""

import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from scflow_tpu_torch.device import resolve_device
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.refiners.system import (LossAssets, RenderAssets, loss_assets_from_bank,
                                              make_raft_infer_fn, make_raft_train_step,
                                              make_scflow_cycled_infer_fn, make_scflow_infer_fn,
                                              make_scflow_train_step)
from scflow_tpu_torch.render.meshbank import MeshBank, resolve_cull_backfaces
from scflow_tpu_torch.runtime.checkpoint import load_params, load_pretrained
from scflow_tpu_torch.runtime.eval_loop import multi_process_test
from scflow_tpu_torch.runtime.logger import get_logger


def build_render_assets(model_cfg: Dict, device=None) -> Tuple[RenderAssets, MeshBank]:
    """The renderer's mesh bank (renderer.mesh_dir) on `device` (None:
    CUDA).  cull_backfaces=True refuses meshes that fail the winding check
    (ValueError); 'force' warns instead."""
    rcfg = model_cfg.get("renderer", {})
    bank = MeshBank.from_dir(rcfg["mesh_dir"])
    resolve_cull_backfaces(bank, rcfg.get("cull_backfaces"))
    return RenderAssets.from_bank(bank, device=device), bank


def build_loss_assets(model_cfg: Dict, num_class: int, device=None) -> Optional[LossAssets]:
    """The point-matching loss's vertex banks: every vertex of the meshes
    under pose_loss_cfg.loss_func_cfg.mesh_path, with its mesh_diameter and
    symmetry_types, on `device` (None: CUDA); None without a mesh_path (a
    RAFT config).  num_class is accepted for the JAX signature; the
    symmetry mask covers the bank's classes, as JAX's does."""
    pcfg = model_cfg.get("pose_loss_cfg", {}).get("loss_func_cfg", {})
    mesh_path = pcfg.get("mesh_path")
    if mesh_path is None:
        return None
    bank = MeshBank.from_dir(mesh_path, diameters=pcfg.get("mesh_diameter"))
    return loss_assets_from_bank(bank, pcfg.get("symmetry_types", {}), device=device)


def norm_stats_from_cfg(cfg) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """(mean, std) of the Normalize transform in the test pipeline (else the
    train pipeline); the reference's (0, 255) when there is none."""

    def scan(node):
        if isinstance(node, dict):
            if node.get("type") == "Normalize":
                return node
            for v in node.values():
                hit = scan(v)
                if hit is not None:
                    return hit
        elif isinstance(node, (list, tuple)):
            for v in node:
                hit = scan(v)
                if hit is not None:
                    return hit
        return None

    hit = scan(cfg.data.get("test", {})) or scan(cfg.data.get("train", {}))
    if hit is None:
        return (0.0, 0.0, 0.0), (255.0, 255.0, 255.0)
    return tuple(hit.get("mean", (0.0,) * 3)), tuple(hit.get("std", (255.0,) * 3))


def init_model_variables(cfg_model: Dict, model: torch.nn.Module, seed: int = 0,
                         device=None) -> Dict[str, torch.Tensor]:
    """Seeded initial weights (JAX's init under PRNGKey(seed)): the model of
    cfg_model built again on a torch RNG seeded `seed` (the global RNG is
    left as it was), its weights copied into `model`, which moves to
    `device` (None: CUDA).  Returns the model's state dict."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        fresh = build_refiner_from_config(cfg_model)
    model.load_state_dict(fresh.state_dict())
    return model.to(dev).state_dict()


def load_init_weights(cfg_model: Dict, model: torch.nn.Module, logger=None) -> torch.nn.Module:
    """The config's init_cfg {'type': 'Pretrained', 'checkpoint': PATH} into
    `model` (checkpoint.load_pretrained: the reference's layout or
    mmflow's, each key the file and the model share).  A missing file
    warns and keeps the weights, as the JAX package does (the shipped
    configs name a file the repo does not hold).  An orbax directory
    raises: the port reads no orbax (ROADMAP §1, out of scope)."""
    logger = logger or get_logger()
    init_cfg = cfg_model.get("init_cfg") or {}
    path = init_cfg.get("checkpoint")
    if init_cfg.get("type") != "Pretrained" or not path:
        return model
    if not os.path.exists(path):
        logger.warning(f"init checkpoint {path} not found; using random init")
        return model
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"init checkpoint {path}: the port reads .pth/.pt files, not orbax "
                         "directories (ROADMAP §1, out of scope)")
    logger.info(f"Loading init checkpoint {path}")
    keys = load_pretrained(path, model)
    logger.info(f"init checkpoint: {len(keys['missing'])} model keys not in the file, "
                f"{len(keys['unexpected'])} file keys not in the model")
    return model


def load_eval_checkpoint(path: str, model: torch.nn.Module, logger=None) -> Dict[str, torch.Tensor]:
    """Load test weights from a `.pth`/`.pt` file in the reference's layout
    (the port's checkpoint.save_params writes it; the reference's own files
    have the same names) into `model`.  Every key and shape is checked
    against the model's; a difference raises ValueError naming the keys.
    Returns the model's state dict."""
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: the port loads .pth/.pt checkpoints (the JAX package's "
                         "orbax directories are not read)")
    (logger or get_logger()).info(f"loading checkpoint {path}")
    load_params(path, model)
    return model.state_dict()


def _raft_pnp_cfg(test_cfg: Dict) -> Dict:
    pnp_cfg = dict(occ_thresh=test_cfg.get("occ_thresh", 0.5),
                   reprojection_error=test_cfg.get("solve_pose_param", {}).get(
                       "reprojectionerror", 3.0))
    sp = test_cfg.get("sample_points")
    if sp and "num" in sp:
        pnp_cfg["num_points"] = sp["num"]
    if sp and sp.get("mode", "random") == "random":
        warnings.warn(
            "pnp_backend='device' always selects points by confidence "
            "top-k (occlusion when predicted, else a fixed "
            "pseudo-random score); sample_points mode='random' is not "
            "honored — use the host backend for reference-exact "
            "sampling semantics")
    return pnp_cfg


def make_serving_from_cfg(cfg, model, render_assets: RenderAssets, device=None):
    """The config's serving pipeline: (serve_fn, fetch_keys, post_fn) for
    runtime.server.PoseService (JAX's make_serving_from_cfg, with `device`,
    None meaning CUDA).  SCFlow serves poses from the device, pose-only
    (slim), and the service fetches rotations and translations; a RAFT
    config with test_cfg.pnp_backend 'device' solves the pose on the device
    too (sample_points' num; mode 'random' warns: the device PnP takes the
    top-k by confidence); with 'host' (the default) the service fetches the
    flow, occlusion, rendered depths, K' and reference poses, and post_fn
    solves the pose with cv2's RANSAC-EPnP on the host (cv_pnp.py's numpy
    rebuild: no cv2) against K', so poses land in the original camera
    frame either way.  The backends are JAX's 'auto': the kernels on a card."""
    from scflow_tpu_torch.serving import make_raft_serving_fn, make_serving_fn

    norm_mean, norm_std = norm_stats_from_cfg(cfg)
    test_cfg = cfg.model.get("test_cfg", {})
    rcfg = cfg.model.get("renderer", {})
    image_size = tuple(rcfg.get("image_size", (256, 256)))
    common = dict(image_size=image_size[0], norm_mean=norm_mean, norm_std=norm_std,
                  iters=test_cfg.get("iters"),
                  render_cull_backfaces=bool(rcfg.get("cull_backfaces", False)), device=device)
    banks = (render_assets.verts, render_assets.vert_valid)
    if cfg.model["type"] == "SCFlowRefiner":
        serve_fn = make_serving_fn(model, render_assets, *banks, slim=True, **common)
        return serve_fn, ("rotations", "translations"), None
    if test_cfg.get("pnp_backend", "host") == "device":
        serve_fn = make_raft_serving_fn(model, render_assets, *banks, pnp_backend="device",
                                        pnp_cfg=_raft_pnp_cfg(test_cfg), **common)
        return serve_fn, ("rotations", "translations"), None

    serve_fn = make_raft_serving_fn(model, render_assets, *banks, **common)
    fetch_keys = ("flow", "occlusion", "rendered_depths", "new_k", "ref_rotations",
                  "ref_translations")

    def post_fn(out):
        from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow

        R, t, _ = solve_poses_from_flow(
            out["flow"], out["rendered_depths"], out["ref_rotations"], out["ref_translations"],
            out["new_k"], occlusion=out.get("occlusion"),
            occ_thresh=test_cfg.get("occ_thresh", 0.5),
            sample_points=test_cfg.get("sample_points"),
            reprojection_error=test_cfg.get("solve_pose_param", {}).get("reprojectionerror", 3.0))
        return {"rotations": R, "translations": t}

    return serve_fn, fetch_keys, post_fn


def make_infer_from_cfg(cfg, model, render_assets: RenderAssets, image_size=(256, 256),
                        slim: bool = False, device=None):
    """(infer, pose_from_output) for the evaluation loop.  SCFlow configs
    refine on the device (slim=True: the pose-only surface of the
    reference's test forward); RAFT configs with test_cfg.pnp_backend
    'device' solve the pose on the device too, and with 'host' (the
    default) return the flow, which pose_from_output solves with cv2's
    RANSAC-EPnP on the host (cv_pnp.py's numpy rebuild: no cv2).  SCFlow with
    test_cfg.cycles > 1 refines that many times through
    make_scflow_cycled_infer_fn, on the same backends; a RAFT config with
    cycles > 1 raises ValueError (JAX's RAFT path ignores cycles).  The
    render takes the kernel's backend ('pallas')
    on either device, where JAX's 'auto' takes its XLA form off the TPU: on
    the CPU the kernel's plain version then computes what the card's kernel
    does, so a CPU run checks a card run (the two raster coverage formulas
    flip edge pixels, which moved one pose of chip_smoke.py's workflow set
    by 4.8 mm).  The lookup does the same on a square image; on any other
    it takes 'auto', JAX's route for such maps (no lookup kernel takes
    them)."""
    mcfg = cfg.model
    test_cfg = mcfg.get("test_cfg", {})
    iters = test_cfg.get("iters")
    cull = bool(mcfg.get("renderer", {}).get("cull_backfaces", False))
    image_size = tuple(image_size)
    lookup = "pallas" if image_size[0] == image_size[1] else "auto"
    common = dict(image_size=image_size, iters=iters, render_cull_backfaces=cull,
                  render_backend="pallas", lookup_backend=lookup, device=device)
    cycles = test_cfg.get("cycles", 1)
    if mcfg["type"] == "SCFlowRefiner":
        if cycles > 1:
            return make_scflow_cycled_infer_fn(model, render_assets, cycles=cycles, slim=slim,
                                               **common), None
        return make_scflow_infer_fn(model, render_assets, slim=slim, **common), None
    if cycles > 1:
        raise ValueError(f"test_cfg.cycles={cycles} on a RAFT config: cycled inference is "
                         "SCFlow's (the JAX package's RAFT path ignores it)")
    if test_cfg.get("pnp_backend", "host") == "device":
        return make_raft_infer_fn(model, render_assets, pnp_backend="device",
                                  pnp_cfg=_raft_pnp_cfg(test_cfg), **common), None
    infer = make_raft_infer_fn(model, render_assets, **common)

    def pose_from_output(out, batch, n):
        from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow

        R, t, _ = solve_poses_from_flow(
            np.asarray(out["flow"])[:n], np.asarray(out["rendered_depths"])[:n],
            np.asarray(batch["ref_rotations"])[:n], np.asarray(batch["ref_translations"])[:n],
            np.asarray(batch["k"])[:n],
            occlusion=np.asarray(out["occlusion"])[:n] if "occlusion" in out else None,
            occ_thresh=test_cfg.get("occ_thresh", 0.5),
            sample_points=test_cfg.get("sample_points"),
            reprojection_error=test_cfg.get("solve_pose_param", {}).get(
                "reprojectionerror", 3.0))
        return R, t

    return infer, pose_from_output


def make_train_step_from_cfg(cfg, model, render_assets: RenderAssets,
                             loss_assets: Optional[LossAssets], image_size=(256, 256),
                             device=None, process_group=None):
    """The train step of the config's refiner (JAX's make_train_step_from_cfg):
    SCFlow with the sequence-loss weights, gamma, disentangle_z and loss
    type of its pose, flow and mask loss configs; RAFT with its flow and
    occlusion losses and filter_invalid_flow_by_mask/_by_depth; max_flow,
    renderer.cull_backfaces, and render_augmentations (models/augment.py,
    seeded with augment_seed 0, as JAX's config-built step).  As
    make_infer_from_cfg, the render takes the kernel backend
    ('pallas') and so does the lookup on a square image ('auto' otherwise)
    on either device, where JAX's config-built step takes its plain 'xla'
    lookup: the same function, and a CPU run checks a card run.
    process_group makes the step data-parallel (make_scflow_train_step)."""
    mcfg = cfg.model
    image_size = tuple(image_size)
    common = dict(image_size=image_size, max_flow=mcfg.get("max_flow", 400.0),
                  render_augmentations=mcfg.get("render_augmentations"),
                  render_cull_backfaces=bool(mcfg.get("renderer", {}).get("cull_backfaces",
                                                                          False)),
                  render_backend="pallas",
                  lookup_backend="pallas" if image_size[0] == image_size[1] else "auto",
                  device=device, process_group=process_group)
    if mcfg["type"] == "SCFlowRefiner":
        pose_lf = mcfg.get("pose_loss_cfg", {}).get("loss_func_cfg", {})
        flow_lf = mcfg.get("flow_loss_cfg", {}).get("loss_func_cfg", {})
        mask_lf = mcfg.get("mask_loss_cfg", {}).get("loss_func_cfg", {})
        loss_kwargs = dict(gamma=mcfg.get("pose_loss_cfg", {}).get("gamma", 0.8),
                           pose_weight=pose_lf.get("loss_weight", 10.0),
                           flow_weight=flow_lf.get("loss_weight", 0.1),
                           mask_weight=mask_lf.get("loss_weight", 10.0),
                           disentangle_z=pose_lf.get("disentangle_z", True),
                           pose_loss_type=int(pose_lf.get("loss_type", "l1")[-1]))
        return make_scflow_train_step(model, render_assets, loss_assets,
                                      filter_invalid_flow=mcfg.get("filter_invalid_flow", True),
                                      loss_kwargs=loss_kwargs, **common)
    flow_lf = mcfg.get("flow_loss_cfg", {}).get("loss_func_cfg", {})
    occ_lf = mcfg.get("occlusion_loss_cfg", {}).get("loss_func_cfg", {})
    return make_raft_train_step(
        model, render_assets,
        filter_invalid_flow_by_mask=mcfg.get("filter_invalid_flow_by_mask", True),
        filter_invalid_flow_by_depth=mcfg.get("filter_invalid_flow_by_depth", False),
        gamma=mcfg.get("flow_loss_cfg", {}).get("gamma", 0.8),
        flow_weight=flow_lf.get("loss_weight", 1.0),
        occlusion_weight=occ_lf.get("loss_weight", 100.0), **common)


def build_eval_fn(cfg, model, render_assets: RenderAssets, dataset, image_size=(256, 256),
                  device=None):
    """The EvalHook's callable: eval_fn(state) -> flat metric dict, for a
    train state whose model is `model` (the call is bound to it).  Under a
    process group each rank refines its shard of the images and every rank
    gets the metrics of the whole set (eval_loop.multi_process_test)."""
    infer, pose_from_output = make_infer_from_cfg(cfg, model, render_assets, image_size,
                                                  slim=True, device=device)
    metric = cfg.get("evaluation", {}).get("metric", {"add": [0.05, 0.10, 0.20, 0.50]})

    def eval_fn(state):
        if state.model is not model:
            raise ValueError("eval_fn was built for another model")
        results = multi_process_test(infer, dataset, pose_from_output=pose_from_output,
                                     progress_interval=0)
        return dataset.evaluate(results, metric=metric)

    return eval_fn



def build_tb_image_fn(cfg, model, render_assets: RenderAssets, image_size=(256, 256),
                      device=None):
    """The TensorboardHook's image_fn(runner) -> {name: (H, W, 3) float image}:
    panels of the first sample of the runner's last batch (reference
    TensorboardImgLoggerHook with base_refiner.add_vis_images): the real
    image, the predicted flow and mask (make_infer_from_cfg, slim=False),
    the rendered image forward-warped by the predicted flow, and the gt
    flow.  As the JAX package's, the gt flow is computed from a zero depth
    map (ROADMAP §3)."""
    from scflow_tpu_torch.geometry import flow_from_pose_and_depth
    from scflow_tpu_torch.refiners.system import render_and_normalize
    from scflow_tpu_torch.visualize import flow2rgb, simple_forward_warp

    infer, _ = make_infer_from_cfg(cfg, model, render_assets, image_size, device=device)
    norm_mean = np.asarray(cfg.get("normalize_mean", [0.0, 0.0, 0.0]))
    norm_std = np.asarray(cfg.get("normalize_std", [255.0, 255.0, 255.0]))
    max_flow = cfg.model.get("max_flow", 400.0)

    def image_fn(runner):
        batch = runner.last_batch
        if batch is None:
            return {}
        out = {k: v.detach().float().cpu().numpy() for k, v in infer(batch).items()
               if isinstance(v, torch.Tensor)}
        imgs = {}
        real = batch["real_images"][0].float().cpu().numpy()
        imgs["train/real_image"] = np.clip((real * norm_std + norm_mean) / 255.0, 0, 1)
        if "flow" in out:
            imgs["train/pred_flow"] = flow2rgb(out["flow"][0], unknown_thr=max_flow - 1)
        if "masks" in out:
            imgs["train/pred_mask"] = np.repeat(out["masks"][0][..., None], 3, axis=-1)
        sel = {k: torch.as_tensor(batch[k][:1]) for k in
               ("ref_rotations", "ref_translations", "k", "labels", "gt_rotations",
                "gt_translations") if k in batch}
        if "flow" in out:
            with torch.no_grad():
                rendered, _, rmasks = render_and_normalize(
                    render_assets, sel["ref_rotations"], sel["ref_translations"], sel["k"],
                    sel["labels"].long(), tuple(image_size), tuple(norm_mean), tuple(norm_std),
                    chunk=1)
            disp = np.clip((rendered[0].cpu().numpy() * norm_std + norm_mean) / 255.0, 0, 1)
            imgs["train/warped_render"] = simple_forward_warp(disp, out["flow"][0],
                                                              rmasks[0].cpu().numpy())
        if "gt_rotations" in sel:
            with torch.no_grad():
                gt_flow = flow_from_pose_and_depth(
                    sel["ref_rotations"], sel["ref_translations"], sel["gt_rotations"],
                    sel["gt_translations"],
                    torch.zeros((1,) + tuple(image_size), device=sel["k"].device), sel["k"],
                    invalid_num=max_flow)
            imgs["train/gt_flow"] = flow2rgb(gt_flow[0].cpu().numpy(), unknown_thr=max_flow - 1)
        return imgs

    return image_fn
