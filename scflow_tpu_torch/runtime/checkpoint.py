"""Checkpoints as torch files in the reference's mmcv layout: the port's
counterpart of scflow_tpu/runtime/checkpoint.py, which writes orbax
directories.

A file holds {"state_dict": {name: tensor}, "meta": {...}} and, for a train
state, "optimizer" (the torch optimizer's state dict).  The names are the
reference's (the port's modules keep them), so the file is a `.pth` that
the JAX package's load_eval_checkpoint reads through its converter and
manifest check, and the reference's own `.pth` files load here.  Loading
checks every key and shape against the model's and raises with the names
of what differs."""

import glob
import json
import os
import re
from typing import Any, Dict, Optional

import torch


_SHARED, _REAL = "render_encoder.", "real_encoder."


def reference_state_dict(model_or_state) -> Dict[str, torch.Tensor]:
    """The weights (of a module or a state dict) as CPU tensors under the
    reference's key set: a refiner with one feature encoder for both images
    (the port's lone render_encoder) also lists it as real_encoder, as the
    reference's module, registered under both names, serialises it."""
    sd = model_or_state.state_dict() if isinstance(model_or_state, torch.nn.Module) \
        else model_or_state
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    if any(k.startswith(_SHARED) for k in sd) and not any(k.startswith(_REAL) for k in sd):
        sd.update({_REAL + k[len(_SHARED):]: v for k, v in list(sd.items())
                   if k.startswith(_SHARED)})
    return sd


def _drop_shared_copy(sd: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                      source: str) -> Dict[str, torch.Tensor]:
    """For a model with a shared feature encoder, the file's real_encoder
    copy, which must equal its render_encoder, is dropped."""
    if any(k.startswith(_REAL) for k in want) or not any(k.startswith(_REAL) for k in sd):
        return sd
    real = {k[len(_REAL):]: v for k, v in sd.items() if k.startswith(_REAL)}
    shared = {k[len(_SHARED):]: v for k, v in sd.items() if k.startswith(_SHARED)}
    if real.keys() != shared.keys() or any(not torch.equal(v, shared[k])
                                           for k, v in real.items()):
        raise ValueError(f"{source}: its real_encoder differs from its render_encoder, but "
                         "the model shares one feature encoder (seperate_encoder=False)")
    return {k: v for k, v in sd.items() if not k.startswith(_REAL)}


def _atomic_save(payload: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_params(path: str, model_or_state, meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a model's weights (a module or its state dict) to `path`."""
    _atomic_save({"state_dict": reference_state_dict(model_or_state),
                  "meta": dict(meta or {})}, path)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The file's dict; a bare state dict (no "state_dict" key) is wrapped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        raise TypeError(f"{path} holds a {type(ckpt).__name__}, not a checkpoint dict")
    return ckpt if "state_dict" in ckpt else {"state_dict": ckpt, "meta": {}}


def check_state_dict(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                     source: str = "the checkpoint",
                     ignore_suffixes=("num_batches_tracked",)) -> None:
    """Raise ValueError naming every key `got` lacks, every key it has that
    `want` lacks, and every shape that differs (the JAX package's manifest
    check, runtime/manifest.py::verify_state_dict, against the model's own
    keys and shapes)."""
    def keys(sd):
        return {k for k in sd if not k.endswith(ignore_suffixes)}

    missing = sorted(keys(want) - keys(got))
    unexpected = sorted(keys(got) - keys(want))
    mismatched = [(k, tuple(got[k].shape), tuple(want[k].shape))
                  for k in sorted(keys(got) & keys(want)) if got[k].shape != want[k].shape]
    if missing or unexpected or mismatched:
        raise ValueError(f"{source} does not fit the model: missing {missing}, "
                         f"unexpected {unexpected}, mismatched (key, file, model) {mismatched}")


def load_params(path: str, model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """The file's state dict (CPU tensors).  With `model`, it is checked
    against the model's (check_state_dict; a shared encoder's real_encoder
    copy must equal its render_encoder) and loaded into it."""
    sd = read_checkpoint(path)["state_dict"]
    if model is not None:
        want = model.state_dict()
        sd = _drop_shared_copy(sd, want, path)
        check_state_dict(sd, want, path)
        model.load_state_dict({k: sd.get(k, want[k]) for k in want})
    return sd


_STEP_FILE = re.compile(r"iter_(\d+)\.pth$")


class CheckpointManager:
    """Train-state checkpoints under work_dir/checkpoints/iter_{step}.pth
    (mmcv's names), keeping the newest `max_to_keep` (None or <= 0: all, as
    mmcv's max_keep_ckpts=-1), and the best one by a metric as
    work_dir/best_ckpt.pth beside best.json (checkpoint_config and
    evaluation.save_best of the reference's configs)."""

    def __init__(self, work_dir: str, max_to_keep: Optional[int] = 5):
        self.work_dir = os.path.abspath(work_dir)
        self.ckpt_dir = os.path.join(self.work_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.max_to_keep = max_to_keep if max_to_keep and max_to_keep > 0 else None
        self._best_path = os.path.join(self.work_dir, "best.json")

    def _steps(self):
        found = (_STEP_FILE.search(p) for p in glob.glob(os.path.join(self.ckpt_dir, "*.pth")))
        return sorted(int(m.group(1)) for m in found if m)

    def path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"iter_{step}.pth")

    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None) -> str:
        """Write state (a train_state.TrainState) at `step`; drop the oldest
        beyond max_to_keep."""
        path = self.path(step)
        _atomic_save({"state_dict": reference_state_dict(state.model),
                      "optimizer": state.tx.tx.state_dict(),
                      "meta": {"iter": int(step), "step": int(state.step), **(extra or {})}},
                     path)
        if self.max_to_keep is not None:
            for old in self._steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state, step: Optional[int] = None):
        """(state with the weights, optimizer state and step count of the
        checkpoint at `step`, default the latest; step), or (state, 0) when
        there is none.  The weights are checked as load_params checks
        them."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state, 0
        ckpt = torch.load(self.path(step), map_location="cpu", weights_only=True)
        want = state.model.state_dict()
        sd = _drop_shared_copy(ckpt["state_dict"], want, self.path(step))
        check_state_dict(sd, want, self.path(step))
        state.model.load_state_dict({k: sd.get(k, want[k]) for k in want})
        state.tx.tx.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["meta"]["step"])
        return state, int(step)

    def maybe_save_best(self, step: int, state, metric_name: str, value: float,
                        rule: str = "greater") -> bool:
        """Keep the weights at `step` as the best if `value` beats the best
        so far by `rule` ('greater' or 'less'); True if it did."""
        if rule not in ("greater", "less"):
            raise ValueError(f"rule must be 'greater' or 'less', got {rule!r}")
        best = None
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                best = json.load(f)
        better = (best is None or (rule == "greater" and value > best["value"])
                  or (rule == "less" and value < best["value"]))
        if better:
            save_params(os.path.join(self.work_dir, "best_ckpt.pth"), state.model,
                        {"iter": int(step), metric_name: float(value)})
            with open(self._best_path, "w") as f:
                json.dump({"metric": metric_name, "value": value, "step": step}, f)
        return better


def duplicate_mmflow_encoder(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """mmflow's RAFT checkpoint layout in the reference's names
    (tools/mmflow_ckpt_converter.py:29-41, the JAX package's
    runtime/convert_torch.py::duplicate_mmflow_encoder): 'encoder.*' becomes
    both 'real_encoder.*' and 'render_encoder.*', 'cxt_encoder.*' becomes
    'context.*'; every other key stays."""
    out = {}
    for k, v in sd.items():
        if k.startswith("encoder."):
            out[_REAL + k[len("encoder."):]] = v
            out[_SHARED + k[len("encoder."):]] = v
        elif k.startswith("cxt_encoder."):
            out["context." + k[len("cxt_encoder."):]] = v
        else:
            out[k] = v
    return out


def load_pretrained(path: str, model: torch.nn.Module,
                    sd: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, list]:
    """A config's init_cfg 'Pretrained' checkpoint into `model`, as the JAX
    package converts one with strict=False: a file without 'real_encoder.*'
    keys is read in mmflow's layout (duplicate_mmflow_encoder); each model
    key the file holds is loaded, a shape that differs raises ValueError,
    the model's other keys keep their values and the file's other keys
    (mmflow's own decoder, say) are ignored.  `sd` is the file's state dict
    when the caller has read it already.  Returns {'missing': model keys
    not in the file, 'unexpected': file keys not in the model}."""
    if sd is None:
        sd = read_checkpoint(path)["state_dict"]
    if not any(k.startswith(_REAL) for k in sd):
        sd = duplicate_mmflow_encoder(sd)
    want = model.state_dict()
    sd = _drop_shared_copy(sd, want, path)
    mismatched = [(k, tuple(v.shape), tuple(want[k].shape)) for k, v in sd.items()
                  if k in want and v.shape != want[k].shape]
    if mismatched:
        raise ValueError(f"{path} does not fit the model: mismatched (key, file, model) "
                         f"{mismatched}")
    model.load_state_dict({k: sd.get(k, v) for k, v in want.items()})
    return {"missing": sorted(k for k in want if k not in sd),
            "unexpected": sorted(k for k in sd if k not in want)}
