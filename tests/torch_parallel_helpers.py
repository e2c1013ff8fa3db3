"""Shared pieces of the data-parallel tests (tests/test_torch_parallel*.py)
and of their rank processes (tests/torch_parallel_worker.py).  It imports
torch and the port only, never JAX, since the rank processes load it.

The global batch: 4 samples at 64^2 of the synthetic bank's 3 classes, the
real images the port's render at the gt pose, the references jittered from
it.  Its halves (rank 0's rows 0-1, rank 1's rows 2-3) differ on purpose:
the second half's objects are nearer, so its renders, which the BatchNorm
context encoder reads, cover more pixels (other feature statistics) and
its flow has more valid pixels: a step that took either half's BatchNorm
statistics or valid-pixel count for the global batch's would show it."""

import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

N, H, NCLASS, ITERS = 4, 64, 3, 2
SYM = {"cls_2": {"z": 0}}
OPT = dict(type="SGD", lr=1e-3, momentum=0.9)
SCFLOW_KW = dict(detach_flow=True, detach_pose=True, detach_depth_for_xy=True)
CLIP = {"scflow": 10.0, "raft": 1.0}
AUGMENT = [dict(type="ColorJiggle", brightness=0.3, contrast=0.3, saturation=0.3, hue=0.05),
           dict(type="RandomGaussianNoise", std=0.05, p=0.5),
           dict(type="RandomGaussianBlur", kernel_size=5, sigma=(0.1, 2.0), p=0.5),
           dict(type="RandomGrayscale", p=0.1)]
AUGMENT_SEED = 3
REPO = Path(__file__).resolve().parents[1]


def assets():
    from scflow_tpu_torch.refiners.system import RenderAssets, loss_assets_from_bank
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS)
    return (RenderAssets.from_bank(bank, device="cpu"),
            loss_assets_from_bank(bank, SYM, device="cpu"))


def make_batch() -> Dict[str, np.ndarray]:
    """The global batch (module docstring)."""
    from scipy.spatial.transform import Rotation

    from scflow_tpu_torch.refiners.system import render_and_normalize

    rng = np.random.default_rng(0)
    gt_R = Rotation.random(N, rng).as_matrix().astype(np.float32)
    z = np.array([440.0, 420.0, 260.0, 280.0], np.float32)
    gt_t = np.stack([rng.normal(size=N) * 10, rng.normal(size=N) * 10, z], -1).astype(np.float32)
    dR = Rotation.from_euler("xyz", rng.normal(size=(N, 3)) * 8,
                             degrees=True).as_matrix().astype(np.float32)
    K = np.tile(np.array([[[120.0, 0, H / 2], [0, 120.0, H / 2], [0, 0, 1]]], np.float32),
                (N, 1, 1))
    labels = np.array([1, 2, 0, 2], np.int32)
    render, _ = assets()
    with torch.no_grad():
        real, _, gt_masks = render_and_normalize(
            render, torch.from_numpy(gt_R), torch.from_numpy(gt_t), torch.from_numpy(K),
            torch.from_numpy(labels).long(), (H, H), chunk=16)
    return dict(real_images=real.numpy(), ref_rotations=np.einsum("nij,njk->nik", dR, gt_R),
                ref_translations=gt_t + rng.normal(size=(N, 3)).astype(np.float32)
                * np.array([5, 5, 15], np.float32),
                gt_rotations=gt_R, gt_translations=gt_t, labels=labels, k=K,
                gt_masks=gt_masks.numpy())


def rows(batch: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, np.ndarray]:
    """Rank `rank`'s local batch: its equal block of the global rows."""
    n = len(batch["labels"]) // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def build_model(kind: str, state_dict: Optional[Dict[str, torch.Tensor]] = None):
    """The port's SCFlowRefiner (3 classes, 64^2, 2 iterations, the shipped
    detach options) or RAFTRefinerFlowMask (2 iterations), from torch's
    initialisation under seed 0 or from `state_dict`."""
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if kind == "scflow":
            model = SCFlowRefiner(num_class=NCLASS, image_size=(H, H), iters=ITERS,
                                  **SCFLOW_KW)
        else:
            model = RAFTRefinerFlowMask(iters=ITERS)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def run_steps(kind: str, state_dict, batch: Dict[str, np.ndarray], group=None,
              steps: int = 2, augment: bool = True) -> Dict[str, object]:
    """`steps` train steps of a fresh model and optimizer on `batch`, with the
    render augmentations on and lookup 'pallas' (the kernels' plain versions
    on the CPU): {'logs': [{name: float} per step], 'state': the weights and
    BatchNorm buffers after them}.  group makes the step data-parallel."""
    from scflow_tpu_torch.refiners.system import make_raft_train_step, make_scflow_train_step
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    model = build_model(kind, state_dict)
    tx, _ = build_optimizer(model, OPT, None, grad_clip=CLIP[kind])
    render, loss = assets()
    common = dict(image_size=(H, H), render_chunk=16, lookup_backend="pallas", device="cpu",
                  render_augmentations=AUGMENT if augment else None,
                  augment_seed=AUGMENT_SEED, process_group=group)
    if kind == "scflow":
        step = make_scflow_train_step(model, render, loss, **common)
    else:
        step = make_raft_train_step(model, render, **common)
    state, logs = TrainState(model, tx), []
    for _ in range(steps):
        state, log = step(state, batch)
        logs.append({k: float(v) for k, v in log.items()})
    return dict(logs=logs, state={k: v.detach().clone() for k, v in model.state_dict().items()})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra) -> Dict[str, str]:
    """The environment of a rank process: the repo and tests/ importable,
    one intra-op thread (the tests run beside other workers), no JAX
    settings it would not read."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), str(REPO / "tests"),
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def start_ranks(args: List[str], world: int, **extra) -> List[subprocess.Popen]:
    """`world` processes of `python args...` as the ranks of one job, with
    torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) set by hand."""
    port = free_port()
    return [subprocess.Popen([sys.executable, *args], cwd=str(REPO),
                             env=child_env(RANK=r, WORLD_SIZE=world, LOCAL_RANK=r,
                                           LOCAL_WORLD_SIZE=world, MASTER_ADDR="127.0.0.1",
                                           MASTER_PORT=port, **extra),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_ranks(procs: List[subprocess.Popen], timeout: float = 300.0) -> List[str]:
    """Every rank's output; a rank that fails fails the test with it."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs
