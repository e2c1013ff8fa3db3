"""Config-driven builders of the test workflow: config dict -> render
assets, model weights, the inference call and the evaluation callable.  The
port's copy of the test side of scflow_tpu/apis.py (used by cli.test_main);
the train side (load_init_weights, make_train_step_from_cfg) comes with the
train workflow."""

import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from scflow_tpu_torch.device import resolve_device
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.refiners.system import (RenderAssets, make_raft_infer_fn,
                                              make_scflow_infer_fn)
from scflow_tpu_torch.render.meshbank import MeshBank, resolve_cull_backfaces
from scflow_tpu_torch.runtime.checkpoint import load_params
from scflow_tpu_torch.runtime.eval_loop import single_process_test
from scflow_tpu_torch.runtime.logger import get_logger


def build_render_assets(model_cfg: Dict, device=None) -> Tuple[RenderAssets, MeshBank]:
    """The renderer's mesh bank (renderer.mesh_dir) on `device` (None:
    CUDA).  cull_backfaces=True refuses meshes that fail the winding check
    (ValueError); 'force' warns instead."""
    rcfg = model_cfg.get("renderer", {})
    bank = MeshBank.from_dir(rcfg["mesh_dir"])
    resolve_cull_backfaces(bank, rcfg.get("cull_backfaces"))
    return RenderAssets.from_bank(bank, device=device), bank


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


def make_infer_from_cfg(cfg, model, render_assets: RenderAssets, image_size=(256, 256),
                        slim: bool = False, device=None):
    """(infer, pose_from_output) for the evaluation loop.  SCFlow configs
    refine on the device (slim=True: the pose-only surface of the
    reference's test forward); RAFT configs with test_cfg.pnp_backend
    'device' solve the pose on the device too, and with 'host' (the
    default) return the flow, which pose_from_output solves with cv2's
    RANSAC on the host (not on a machine without cv2).
    test_cfg.cycles > 1 (make_scflow_cycled_infer_fn) raises
    NotImplementedError.  The render takes the kernel's backend ('pallas')
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
    if mcfg["type"] == "SCFlowRefiner":
        if test_cfg.get("cycles", 1) > 1:
            raise NotImplementedError("test_cfg.cycles > 1 (make_scflow_cycled_infer_fn) is "
                                      "not ported (ROADMAP §1 item 9)")
        return make_scflow_infer_fn(model, render_assets, slim=slim, **common), None
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


def build_eval_fn(cfg, model, render_assets: RenderAssets, dataset, image_size=(256, 256),
                  device=None):
    """The EvalHook's callable: eval_fn(state) -> flat metric dict, for a
    train state whose model is `model` (the call is bound to it)."""
    infer, pose_from_output = make_infer_from_cfg(cfg, model, render_assets, image_size,
                                                  slim=True, device=device)
    metric = cfg.get("evaluation", {}).get("metric", {"add": [0.05, 0.10, 0.20, 0.50]})

    def eval_fn(state):
        if state.model is not model:
            raise ValueError("eval_fn was built for another model")
        results = single_process_test(infer, dataset, pose_from_output=pose_from_output,
                                      progress_interval=0)
        return dataset.evaluate(results, metric=metric)

    return eval_fn

