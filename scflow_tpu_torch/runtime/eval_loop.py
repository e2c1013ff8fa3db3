"""The evaluation loop (reference tools/eval.py single_gpu_test): the port's
copy of scflow_tpu/runtime/eval_loop.py.

One image at a time (the reference's test_samples_per_gpu=1): its objects'
patches are padded to a power-of-two bucket, refined in one call, and the
poses cut back and remapped to the original image on the host, with one
device-to-host copy per image.  The stages run in order, load -> call ->
fetch -> remap: JAX's overlap (a producer thread and image k launched
before image k-1 is fetched) was slower here, since the thread's decoding
holds the GIL that the launches need.
"""

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from scflow_tpu_torch.datasets.loader import collate_batch
from scflow_tpu_torch.host_geometry import remap_pose_to_origin_resolution
from scflow_tpu_torch.runtime.logger import get_logger


def _bucket(n: int, max_bucket: int = 64, fixed: bool = False) -> int:
    """Padded object count for a batch of n patches: the next power of two,
    at most max_bucket unless n is larger (then its own power of two);
    fixed=True always pads to max_bucket (or n's power of two above it)."""
    b = 1
    while b < n:
        b *= 2
    if fixed:
        return max(max_bucket, b)
    return b if n > max_bucket else min(b, max_bucket)


def pad_batch(batch: Dict[str, np.ndarray], size: int) -> Dict[str, np.ndarray]:
    """Pad the leading (object) axis to `size` by repeating row 0."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        n = v.shape[0]
        if n == size:
            out[k] = v
        else:
            pad = np.repeat(v[:1], size - n, axis=0)
            out[k] = np.concatenate([v, pad], axis=0)
    return out


def fetch(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """An infer call's outputs as numpy arrays, in one device-to-host copy:
    the tensors (float, and bool flags, which come back as bool) are
    flattened into one float32 buffer and split again on the host."""
    keys = sorted(out)
    flat = torch.cat([out[k].reshape(-1).to(torch.float32) for k in keys]).cpu().numpy()
    res, pos = {}, 0
    for k in keys:
        n = out[k].numel()
        v = flat[pos:pos + n].reshape(tuple(out[k].shape))
        res[k] = v.astype(bool) if out[k].dtype == torch.bool else v
        pos += n
    return res


def _finish_result(out, batch, metas, n, pose_from_output):
    """Host post-processing of one image's fetched output: cut the padding,
    solve the pose from the flow (pose_from_output, RAFT with host PnP) and
    remap the poses to the original image frame (pose.py:264-309)."""
    if pose_from_output is None:
        rotations = np.asarray(out["rotations"])[:n]
        translations = np.asarray(out["translations"])[:n]
    else:
        rotations, translations = pose_from_output(out, batch, n)
    labels = np.asarray(batch["labels"])[:n]
    scores = np.ones(n, np.float32)
    meta = metas[0]
    rotations, translations = remap_pose_to_origin_resolution(
        rotations, translations, np.asarray(batch["k"])[:n], meta)
    return dict(pred=dict(labels=labels, rotations=rotations, translations=translations,
                          scores=scores),
                img_metas=dict(img_path=meta["img_path"]))


def single_process_test(infer_fn: Callable, dataset, pose_from_output: Optional[Callable] = None,
                        max_bucket: int = 64, fixed_bucket: bool = False,
                        progress_interval: int = 50, logger=None,
                        stats: Optional[Dict[str, float]] = None) -> List[Dict[str, Any]]:
    """Refine every image of the dataset and return the reference-format
    results, per image {'pred': {labels, rotations, translations, scores},
    'img_metas': {img_path}}, in the dataset's order.

    infer_fn(batch) is an entry point of refiners/system.py (the model and
    the device are bound in it; JAX's infer_fn takes the variables first).
    pose_from_output(out, batch, n) -> (rotations, translations) solves the
    pose from a fetched flow output (RAFT with host PnP).  stats, if given,
    receives the seconds spent: 'load' (the dataset read, collation and
    padding), 'call' (launching the entry point), 'fetch' (waiting for its
    outputs) and 'finish' (the host's cut and remap), and 'images'."""
    logger = logger or get_logger()
    stats = {} if stats is None else stats
    for k in ("load", "call", "fetch", "finish"):
        stats[k] = 0.0
    stats["images"] = 0
    results: List[Dict[str, Any]] = []
    total = len(dataset)
    t_start = time.perf_counter()
    for idx in range(total):
        t0 = time.perf_counter()
        batch = collate_batch([dataset[idx]])
        metas = batch.pop("img_metas")
        batch.pop("per_img_patch_num")
        n = batch["labels"].shape[0]
        padded = pad_batch(batch, _bucket(n, max_bucket, fixed_bucket))
        t1 = time.perf_counter()
        out_dev = infer_fn(padded)
        t2 = time.perf_counter()
        out = fetch(out_dev)
        t3 = time.perf_counter()
        results.append(_finish_result(out, batch, metas, n, pose_from_output))
        t4 = time.perf_counter()
        for k, dt in (("load", t1 - t0), ("call", t2 - t1), ("fetch", t3 - t2),
                      ("finish", t4 - t3)):
            stats[k] += dt
        stats["images"] += 1
        count = stats["images"]
        if progress_interval and count % progress_interval == 0:
            dt = time.perf_counter() - t_start
            logger.info(f"test [{count}/{total}] {count / dt:.2f} img/s "
                        f"({dt / count * 1e3:.1f} ms/img)")
    return results


def multi_process_test(infer_fn: Callable, dataset, **kwargs) -> List[Dict[str, Any]]:
    """single_process_test in one process.  Sharding images over processes
    (the reference's multi_gpu_test, JAX's process_allgather) needs the
    distributed runtime of ROADMAP §1 item 9; an initialised process group
    of more than one process raises."""
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError("multi-process evaluation is not ported (ROADMAP §1 item 9)")
    return single_process_test(infer_fn, dataset, **kwargs)
