"""Weight bridge: a flax SCFlowRefiner variables tree -> a PyTorch state dict.

`state_dict_from_flax(variables)` takes the JAX package's
{"params", "batch_stats"} tree (leaves as numpy arrays) and returns a state
dict that `scflow_tpu_torch.refiners.scflow.SCFlowRefiner` loads with
strict=True.  The name mapping is this package's own copy of the one in
scflow_tpu/runtime/convert_torch.py (flax module path -> the reference's
mmcv key); the transposes run the other way: HWIO -> OIHW, (I, O) -> (O, I).
"""

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

_LEAF_PARAM = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_LEAF_STATS = {"mean": "running_mean", "var": "running_var"}
_NORM_ABBR = {"BN": "bn", "IN": "in", "GN": "gn"}


def _torch_prefix(path: Tuple[str, ...]) -> str:
    """flax module path (without the leaf) -> torch key prefix, with norm
    placeholders that _resolve_norm fills in."""
    out = []
    for i, p in enumerate(path):
        if m := re.fullmatch(r"layer(\d+)_block(\d+)", p):
            out.append(f"res_layer{m.group(1)}.{m.group(2)}")
        elif p == "stem_conv":
            out.append("conv1")
        elif p == "stem_norm":
            out.append("__norm1__")
        elif p == "out_conv":
            out.append("conv2")
        elif p == "downsample_conv":
            out.append("downsample.0")
        elif p == "downsample_norm":
            out.append("downsample.1")
        elif m := re.fullmatch(r"(corr_net|flow_net|out_net)(\d+)", p):
            out.append(f"{m.group(1)}.{m.group(2)}")
        elif m := re.fullmatch(r"conv_([zrq])(\d+)", p):
            out.append(f"conv_{m.group(1)}.{m.group(2)}")
        elif m := re.fullmatch(r"delta_flow_enc(\d+)", p):
            out.append(f"delta_flow_encoder.{m.group(1)}")
        elif m := re.fullmatch(r"mask_enc(\d+)", p):
            out.append(f"mask_encoder.{m.group(1)}")
        elif m := re.fullmatch(r"layer(\d+)", p):  # XHead convs
            out.append(f"layers.{m.group(1)}")
        elif p == "predict":
            out.append("predict_layer")
        elif p in ("trunk", "update", "n"):
            pass  # structural levels the torch names do not have
        elif (m := re.fullmatch(r"conv(\d+)", p)) and "pose_pred" in path[:i]:
            out.append(f"conv_layers.{m.group(1)}")
        elif m := re.fullmatch(r"fc(\d+)", p):
            out.append(f"fc_layers.{m.group(1)}.0")
        elif p in ("norm1", "norm2"):
            out.append(f"__{p}__")
        elif p == "norm":  # ConvModule norm
            out.append("__norm__")
        else:
            out.append(p)
    return ".".join(out)


def _norm_kind(path: Tuple[str, ...], encoder_norm: str, cxt_norm: str) -> str:
    if path[0] == "render_encoder":
        return encoder_norm
    if "pose_pred" in path:
        return "GN"
    return cxt_norm


def _resolve_norm(key: str, kind: str) -> str:
    abbr = _NORM_ABBR[kind]
    return (key.replace("__norm1__", f"{abbr}1").replace("__norm2__", f"{abbr}2")
            .replace("__norm__", abbr))


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables: Dict[str, Any], encoder_norm: str = "IN",
                         cxt_norm: str = "BN") -> Dict[str, torch.Tensor]:
    """variables: {"params": ..., "batch_stats": ...} of a flax
    SCFlowRefiner (nested dicts of numpy arrays)."""
    sd = {}
    for coll, leaf_map in (("params", _LEAF_PARAM), ("batch_stats", _LEAF_STATS)):
        for path, leaf in _leaves(variables.get(coll, {})):
            prefix = _resolve_norm(_torch_prefix(path[:-1]),
                                   _norm_kind(path, encoder_norm, cxt_norm))
            w = np.asarray(leaf, np.float32)
            if path[-1] == "kernel" and w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif path[-1] == "kernel" and w.ndim == 2:
                w = w.T  # (I, O) -> (O, I)
            key = f"{prefix}.{leaf_map[path[-1]]}"
            if key in sd:
                raise KeyError(f"two flax leaves map to {key}")
            sd[key] = torch.from_numpy(np.ascontiguousarray(w))
            if path[-1] == "mean":  # BatchNorm2d also keeps a step count
                sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd
