"""Weight bridge: a flax refiner's variables tree -> a PyTorch state dict.

`state_dict_from_flax(variables)` takes the JAX package's
{"params", "batch_stats"} tree (leaves as numpy arrays) of an
SCFlowRefiner, RAFTRefinerFlow or RAFTRefinerFlowMask, or of one of their
modules, with any of their options (a shared or a separate real-image
encoder; 'Basic', 'Small' or 'Large' encoders, the Small one's Bottleneck
blocks included; any norm, None leaving no norm leaves; either pose head
and rotation mode; any radius; fused or unfused GRU gates, whose trees are
the same) and returns a state dict that the port's module of the same name
(`refiners/scflow.py`, `refiners/raft.py`, `models/`) loads with
strict=True.  The name mapping is this package's own copy of the one in
scflow_tpu/runtime/convert_torch.py (flax module path -> the reference's
mmcv key); the transposes run the other way: HWIO -> OIHW, (I, O) -> (O, I).
"""

import re
from typing import Any, Dict, Optional, Tuple

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
        elif p in ("norm1", "norm2", "norm3"):
            out.append(f"__{p}__")
        elif p == "norm":  # ConvModule norm
            out.append("__norm__")
        else:
            out.append(p)
    return ".".join(out)


def _norm_kind(path: Tuple[str, ...], encoder_norm: Optional[str],
               cxt_norm: Optional[str]) -> Optional[str]:
    if path[0] in ("render_encoder", "real_encoder"):
        return encoder_norm
    if "pose_pred" in path:
        return "GN"
    return cxt_norm


def _resolve_norm(key: str, kind: Optional[str]) -> str:
    if kind is None:  # no norm layer, so no placeholder to fill
        return key
    abbr = _NORM_ABBR[kind]
    for i in (1, 2, 3):
        key = key.replace(f"__norm{i}__", f"{abbr}{i}")
    return key.replace("__norm__", abbr)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_key(path: Tuple[str, ...], encoder_norm: Optional[str] = "IN",
              cxt_norm: Optional[str] = "BN") -> str:
    """The torch state-dict key of the flax leaf at `path` (module names,
    then the leaf's name), in a 'params' or 'batch_stats' collection."""
    prefix = _resolve_norm(_torch_prefix(path[:-1]), _norm_kind(path, encoder_norm, cxt_norm))
    return f"{prefix}.{_LEAF_PARAM.get(path[-1]) or _LEAF_STATS[path[-1]]}"


def state_dict_from_flax(variables: Dict[str, Any], encoder_norm: Optional[str] = "IN",
                         cxt_norm: Optional[str] = "BN") -> Dict[str, torch.Tensor]:
    """variables: {"params": ..., "batch_stats": ...} of a flax refiner
    (nested dicts of numpy arrays).  encoder_norm is the norm of the feature
    encoders (render_encoder and, where separate, real_encoder), cxt_norm
    that of the context encoder (and of a lone module's norms), as the
    refiners' fields name them."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(coll, {})):
            w = np.asarray(leaf, np.float32)
            if path[-1] == "kernel" and w.ndim == 4:
                w = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif path[-1] == "kernel" and w.ndim == 2:
                w = w.T  # (I, O) -> (O, I)
            key = torch_key(path, encoder_norm, cxt_norm)
            if key in sd:
                raise KeyError(f"two flax leaves map to {key}")
            sd[key] = torch.from_numpy(np.array(w, order="C"))  # a writable copy
            if path[-1] == "mean":  # BatchNorm2d also keeps a step count
                sd[f"{key.rsplit('.', 1)[0]}.num_batches_tracked"] = torch.tensor(0)
    return sd


def flax_from_state_dict(template: Dict[str, Any], state_dict: Dict[str, torch.Tensor],
                         encoder_norm: Optional[str] = "IN",
                         cxt_norm: Optional[str] = "BN") -> Dict[str, Any]:
    """The inverse of state_dict_from_flax: flax variables of `template`'s
    tree (nested dicts whose leaves have a .shape: arrays or shape structs)
    filled from a state dict by the same key mapping (torch_key), OIHW ->
    HWIO and (O, I) -> (I, O); nested dicts of float32 numpy arrays.  A leaf
    whose key the state dict lacks raises KeyError, a shape mismatch
    ValueError."""
    def fill(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = prefix + (k,)
            if hasattr(v, "items"):
                out[k] = fill(v, path)
                continue
            w = state_dict[torch_key(path, encoder_norm, cxt_norm)].detach().cpu().numpy()
            if k == "kernel" and w.ndim == 4:
                w = w.transpose(2, 3, 1, 0)
            elif k == "kernel" and w.ndim == 2:
                w = w.T
            if w.shape != tuple(v.shape):
                raise ValueError(f"{'/'.join(path)}: {w.shape} against {tuple(v.shape)}")
            out[k] = np.array(w, np.float32)
        return out

    return {coll: fill(tree, ()) for coll, tree in template.items()}


_NORM_RE = re.compile(r"(bn|in|gn)(\d*)")
# torch "name.i" -> flax "name_i"-style module names (the rest keep theirs)
_INDEXED = {"delta_flow_encoder": "delta_flow_enc", "mask_encoder": "mask_enc",
            "layers": "layer", "conv_layers": "conv", "corr_net": "corr_net",
            "flow_net": "flow_net", "out_net": "out_net", "conv_z": "conv_z",
            "conv_r": "conv_r", "conv_q": "conv_q"}


def flax_path(key: str, decoder_update: bool = True) -> Tuple[str, ...]:
    """The inverse of torch_key: the flax path (module names, then the leaf's
    name) of a state-dict key of a refiner.  decoder_update says whether the
    refiner's decoder keeps its update block under 'update', as the SCFlow
    decoder does (the RAFT decoder does not); the flat torch names cannot
    tell.  Raises KeyError for a key no flax leaf maps to (num_batches_tracked
    among them)."""
    parts = key.split(".")
    leaf = parts[-1]
    toks = parts[:-1]
    out = []
    i = 0
    in_encoder = toks and toks[0] in ("render_encoder", "real_encoder", "context")
    is_norm = False
    while i < len(toks):
        p = toks[i]
        nxt = toks[i + 1] if i + 1 < len(toks) else None
        depth_in_encoder = len(out)  # 1 directly under an encoder
        if i == 0 and p == "decoder" and decoder_update:
            out += ["decoder", "update"]
        elif m := re.fullmatch(r"res_layer(\d+)", p):
            out.append(f"layer{m.group(1)}_block{nxt}")
            i += 1
        elif p == "downsample":
            is_norm = nxt == "1"
            out += ["downsample_norm", "n"] if is_norm else ["downsample_conv"]
            i += 1
        elif in_encoder and depth_in_encoder == 1 and p in ("conv1", "conv2"):
            out.append("stem_conv" if p == "conv1" else "out_conv")
        elif in_encoder and (m := _NORM_RE.fullmatch(p)):
            is_norm = True
            out += ["stem_norm" if depth_in_encoder == 1 else f"norm{m.group(2)}", "n"]
        elif p in _INDEXED and nxt is not None and nxt.isdigit():
            if p == "conv_layers":
                out.append("trunk")
            out.append(f"{_INDEXED[p]}{nxt}")
            i += 1
        elif p == "fc_layers":
            out += ["trunk", f"fc{nxt}"]
            i += 2  # the Sequential's index 0
        elif p == "predict_layer":
            out.append("predict")
        elif p == "gn" and "pose_pred" in toks[:i]:
            is_norm = True
            out.append("norm")
        else:
            out.append(p)
        i += 1
    if leaf == "weight":
        out.append("scale" if is_norm else "kernel")
    elif leaf in ("bias", "running_mean", "running_var"):
        out.append({"bias": "bias", "running_mean": "mean", "running_var": "var"}[leaf])
    else:
        raise KeyError(f"no flax leaf maps to {key}")
    return tuple(out)


def flax_param_names(model: torch.nn.Module) -> Dict[str, str]:
    """{parameter name: '/'-joined flax path} of a refiner of this package
    (SCFlowRefiner, RAFTRefinerFlow, RAFTRefinerFlowMask): the names the
    JAX package's configs use for parameters, e.g. in
    optimizer_config.frozen_prefixes.  Each one is checked to map back to
    its parameter's key."""
    update = hasattr(getattr(model, "decoder", None), "pose_pred")
    enc, cxt = model.encoder_norm, model.cxt_norm
    names = {}
    for name, _ in model.named_parameters():
        path = flax_path(name, update)
        if torch_key(path, enc, cxt) != name:
            raise KeyError(f"{name}: its flax path {'/'.join(path)} maps back to "
                           f"{torch_key(path, enc, cxt)}")
        names[name] = "/".join(path)
    return names
