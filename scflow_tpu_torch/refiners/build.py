"""Reference-style model config dicts (configs/refine_models/*) -> the
port's refiner modules: the port's copy of scflow_tpu/refiners/build.py,
reading the same keys with the same defaults (the reference's spellings
`seperate_encoder` and `convex_unsample_flow` included)."""

from typing import Any, Dict

import torch

from scflow_tpu_torch.refiners.raft import RAFTRefinerFlow, RAFTRefinerFlowMask
from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

_DTYPES = {None: None, "fp32": None, "float32": None,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def _norm_of(enc_cfg: Dict[str, Any], default: str) -> str:
    return (enc_cfg or {}).get("norm_cfg", {}).get("type", default)


def build_refiner_from_config(model_cfg: Dict[str, Any]):
    """The refiner of a config's `model` dict.  The port's SCFlowRefiner
    also takes the pose head's class count and the image size, which flax
    infers at init: they come from decoder.pose_head_cfg.num_class (21 when
    absent, the head's default) and renderer.image_size ((256, 256)).  An
    unknown type raises KeyError, an unknown dtype name KeyError."""
    cfg = dict(model_cfg)
    mtype = cfg["type"]
    enc = cfg.get("encoder", {})
    cxt = cfg.get("cxt_encoder", {})
    dec = dict(cfg.get("decoder", {}))
    common = dict(
        seperate_encoder=cfg.get("seperate_encoder", False),
        h_channels=cfg.get("h_channels", 128),
        cxt_channels=cfg.get("cxt_channels", 128),
        encoder_out_channels=enc.get("out_channels", 256),
        encoder_norm=_norm_of(enc, "IN"),
        cxt_norm=_norm_of(cxt, "BN"),
        net_type=dec.get("net_type", "Basic"),
        num_levels=dec.get("num_levels", 4),
        radius=dec.get("radius", 4),
        iters=dec.get("iters", 8),
        gru_type=dec.get("gru_type", "SeqConv"),
        max_flow=cfg.get("max_flow", 400.0),
        dtype=_DTYPES[cfg.get("dtype")],
    )
    if mtype == "SCFlowRefiner":
        head = dict(dec.get("pose_head_cfg", {"type": "MultiClassPoseHead"}))
        return SCFlowRefiner(
            num_class=head.get("num_class", 21),
            image_size=tuple(cfg.get("renderer", {}).get("image_size", (256, 256))),
            detach_flow=dec.get("detach_flow", True),
            detach_mask=dec.get("detach_mask", True),
            detach_pose=dec.get("detach_pose", True),
            detach_depth_for_xy=dec.get("detach_depth_for_xy", False),
            mask_flow=dec.get("mask_flow", False),
            mask_corr=dec.get("mask_corr", False),
            depth_transform=dec.get("depth_transform", "exp"),
            pose_head_cfg=head,
            unroll=dec.get("unroll", cfg.get("unroll", True)),
            **common,
        )
    if mtype in ("RAFTRefinerFlow", "RAFTRefinerFlowMask"):
        common["iters"] = dec.get("iters", 12)
        cls = RAFTRefinerFlow if mtype == "RAFTRefinerFlow" else RAFTRefinerFlowMask
        return cls(convex_upsample_flow=dec.get("convex_unsample_flow", True), **common)
    raise KeyError(f"unknown refiner type {mtype}")
