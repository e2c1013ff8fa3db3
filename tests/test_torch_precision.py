"""The entry points compute in full float32 whatever PyTorch's global TF32
flags (torch.backends.cudnn.allow_tf32 is True by default, so a user's
float32 convolutions on a card would otherwise run in TF32), and leave the
flags as they found them.

Imports no JAX: on a machine with a card and no JAX it runs as
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_precision.py
"""

import numpy as np
import pytest
import torch

from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
from scflow_tpu_torch.refiners.system import (RenderAssets, loss_assets_from_bank,
                                              make_scflow_infer_fn, make_scflow_train_step)
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.runtime.optim import build_optimizer
from scflow_tpu_torch.runtime.train_state import TrainState

from torch_port_helpers import keep_torch_rng  # noqa: F401

N, NCLASS = 2, 3


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


def _set_flags(cudnn, matmul):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul


@pytest.fixture
def restore_flags():
    saved = _flags()
    yield
    _set_flags(*saved)


def _batch(img, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        real_images=(0.2 * rng.normal(size=(N, img, img, 3))).astype(np.float32),
        ref_rotations=np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)),
        ref_translations=np.array([[5.0, -4.0, 400.0], [-6.0, 3.0, 420.0]], np.float32),
        gt_rotations=np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)),
        gt_translations=np.array([[3.0, -2.0, 410.0], [-4.0, 5.0, 415.0]], np.float32),
        k=np.tile(np.array([[[150.0, 0, img / 2], [0, 150.0, img / 2], [0, 0, 1]]], np.float32),
                  (N, 1, 1)),
        labels=np.array([0, 2], np.int64),
        gt_masks=np.ones((N, img, img), np.float32))


def _model(img, iters):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return SCFlowRefiner(num_class=NCLASS, image_size=(img, img), iters=iters)


def _record_flags(model, seen):
    model.register_forward_pre_hook(lambda *_: seen.append(_flags()))


@pytest.mark.parametrize("outside", [(True, True), (True, False), (False, False)])
def test_infer_computes_in_fp32_and_restores_the_flags(outside, restore_flags):
    model = _model(64, 1)
    seen = []
    _record_flags(model, seen)
    bank = make_synthetic_bank(NCLASS)
    infer = make_scflow_infer_fn(model, RenderAssets.from_bank(bank, device="cpu"),
                                 image_size=(64, 64), device="cpu")
    _set_flags(*outside)
    out = infer(_batch(64))
    assert seen == [(False, False)] and _flags() == outside
    assert torch.isfinite(out["rotations"]).all()
    bad = dict(_batch(64), labels=np.array([0, NCLASS + 5]))  # a label outside the bank
    with pytest.raises((IndexError, RuntimeError)):
        infer(bad)
    assert _flags() == outside  # restored when the call raises too


@pytest.mark.parametrize("outside", [(True, True), (False, True)])
def test_train_step_computes_in_fp32_and_restores_the_flags(outside, restore_flags):
    model = _model(64, 1)
    seen = []
    _record_flags(model, seen)
    bank = make_synthetic_bank(NCLASS)
    tx, _ = build_optimizer(model.parameters(), dict(type="AdamW", lr=1e-4), None)
    step = make_scflow_train_step(model, RenderAssets.from_bank(bank, device="cpu"),
                                  loss_assets_from_bank(bank, {}, device="cpu"),
                                  image_size=(64, 64), device="cpu")
    _set_flags(*outside)
    _, logs = step(TrainState(model, tx), _batch(64))
    assert seen == [(False, False)] and _flags() == outside
    assert torch.isfinite(logs["loss"])


@pytest.mark.cuda
def test_infer_poses_do_not_follow_the_global_tf32_flag(restore_flags):
    """On the card: the poses with cuDNN's TF32 allowed globally (PyTorch's
    default) equal those with it off, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    img = 128
    model = _model(img, 2)
    with torch.no_grad():  # pose-head output weights that move the poses
        for lin in (model.decoder.pose_pred.rotation_pred,
                    model.decoder.pose_pred.translation_pred):
            lin.weight.copy_(0.005 * torch.randn(lin.weight.shape,
                                                 generator=torch.Generator().manual_seed(1)))
    infer = make_scflow_infer_fn(model, RenderAssets.from_bank(make_synthetic_bank(NCLASS)),
                                 image_size=(img, img), render_cull_backfaces=True)
    poses = {}
    for cudnn in (False, True):
        _set_flags(cudnn, False)
        out = infer(_batch(img))
        torch.cuda.synchronize()
        poses[cudnn] = out
        assert _flags() == (cudnn, False)
    assert torch.equal(poses[True]["rotations"], poses[False]["rotations"])
    assert torch.equal(poses[True]["translations"], poses[False]["translations"])
    moved = (poses[True]["translations"].cpu() - torch.from_numpy(
        _batch(img)["ref_translations"])).abs().max()
    assert moved > 1e-3
