"""The port's config layer against the JAX package's: Config.fromfile on
every shipped config, --cfg-options parsing, build_refiner_from_config on
both shipped model configs and on a RAFT-S and an SCFlow option-set config
(the same module: flax's variables load into it with strict=True, and its
outputs equal flax's at 64^2 within the option tests' bounds), the JAX
manifest's keys in the checkpoints the port writes, and the checkpoint
module (the reference's layout, strict loading, CheckpointManager)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.config import Config as JConfig
from scflow_tpu.refiners import build_refiner_from_config as j_build
from scflow_tpu.runtime.manifest import manifest_for_config
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.models.pose_head import ID_BIAS
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.runtime.checkpoint import (CheckpointManager, load_params,
                                                 reference_state_dict, save_params)
from scflow_tpu_torch.runtime.optim import build_optimizer
from scflow_tpu_torch.runtime.train_state import TrainState

from torch_port_helpers import (keep_torch_rng, lecun_variables, no_tf32,  # noqa: F401
                                scflow_init_args)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "*.py")))
SCFLOW_CFG = os.path.join(REPO, "configs", "refine_models", "scflow.py")
RAFT_CFG = os.path.join(REPO, "configs", "refine_models", "raft.py")
N, IMG = 2, 64


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_fromfile_matches_jax(path):
    got, want = Config.fromfile(path), JConfig.fromfile(path)
    assert _plain(got) == _plain(want)
    assert got.model == want.model and got.filename == want.filename


def test_cfg_options_parse_and_merge_as_jax():
    opts = ["model.dtype=bfloat16", "model.test_cfg.pnp_backend=device",
            "model.decoder.iters=4", "data.test.image_list=/x/y.txt", "a.b=(1,2)", "c=1,2",
            "d=[3, 'x']", "e=True", "f=none"]
    got, want = Config.fromfile(SCFLOW_CFG), JConfig.fromfile(SCFLOW_CFG)
    assert Config.parse_options(opts) == JConfig.parse_options(opts)
    got.merge_from_dict(Config.parse_options(opts))
    want.merge_from_dict(JConfig.parse_options(opts))
    assert _plain(got) == _plain(want)
    assert got.model.dtype == "bfloat16" and got.model.decoder.iters == 4


def _model_cfg(which):
    """Model config dicts at 64^2 and 2 iterations: the shipped SCFlow and
    RAFT configs, RAFT-S, and the SCFlow option set."""
    if which in ("scflow", "option_set"):
        cfg = Config.fromfile(SCFLOW_CFG)
        cfg.merge_from_dict({"model.renderer.image_size": (IMG, IMG), "model.decoder.iters": 2})
        if which == "option_set":
            cfg.merge_from_dict({
                "model.seperate_encoder": True, "model.decoder.radius": 3,
                "model.decoder.mask_flow": True, "model.decoder.mask_corr": True,
                "model.decoder.detach_mask": False, "model.decoder.depth_transform": "linear",
                "model.decoder.pose_head_cfg.rotation_mode": "quaternion"})
        return dict(cfg.model)
    cfg = Config.fromfile(RAFT_CFG)
    cfg.merge_from_dict({"model.decoder.iters": 2})
    if which == "raft_small":
        cfg.merge_from_dict({
            "model.h_channels": 96, "model.cxt_channels": 64,
            "model.encoder.out_channels": 128, "model.cxt_encoder.norm_cfg": dict(type=None),
            "model.decoder.net_type": "Small", "model.decoder.radius": 3,
            "model.decoder.gru_type": "Conv", "model.decoder.convex_unsample_flow": False})
    return dict(cfg.model)


def _norms(mcfg):
    return (mcfg["encoder"]["norm_cfg"]["type"], mcfg["cxt_encoder"]["norm_cfg"]["type"])


@pytest.mark.parametrize("which", ["scflow", "raft", "raft_small", "option_set"])
def test_build_refiner_from_config_matches_jax(which, no_tf32):
    mcfg = _model_cfg(which)
    fmodel, port = j_build(mcfg), build_refiner_from_config(mcfg)
    assert type(port).__name__ == type(fmodel).__name__
    scflow = which in ("scflow", "option_set")
    args = scflow_init_args(1, IMG) if scflow else scflow_init_args(1, IMG)[:2]
    variables = lecun_variables(fmodel, 5, *args)
    if scflow:  # poses that move: the head's kernels small, its rotation bias the identity
        head = variables["params"]["decoder"]["update"]["pose_pred"]
        rng = np.random.default_rng(6)
        for name in ("rotation_pred", "translation_pred"):
            head[name]["kernel"] = rng.normal(0, 0.02, head[name]["kernel"].shape).astype(
                np.float32)
        mode = mcfg["decoder"]["pose_head_cfg"]["rotation_mode"]
        bias = np.asarray(ID_BIAS[mode], np.float32)
        head["rotation_pred"]["bias"] = np.tile(bias, 21)
    port.load_state_dict(state_dict_from_flax(variables, *_norms(mcfg)), strict=True)
    port.eval()
    rng = np.random.default_rng(8)
    render, real = (rng.uniform(0, 1, (N, IMG, IMG, 3)).astype(np.float32) for _ in range(2))
    if scflow:
        from test_torch_options_scflow import _scene
        R, t, depth, K, label = _scene(9)
        inputs = (render, real, R, t, depth, K, label)
    else:
        inputs = (render, real)
    f = jax.jit(lambda v, *a: fmodel.apply(v, *a, lookup_backend="xla"))
    want = {k: np.asarray(v, np.float32)
            for k, v in f(variables, *map(jnp.asarray, inputs)).items()}
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.asarray(a)) for a in inputs), lookup_backend="pallas")
    assert set(got) == set(want)
    if scflow:
        assert np.abs(want["translations"][-1] - inputs[3]).max() > 0.5  # the poses moved
    for k, w in want.items():
        g = got[k].float().numpy()
        assert g.shape == w.shape, k
        if scflow:  # the SCFlow option tests' bound
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3, err_msg=k)
        else:  # the RAFT option tests' bound
            atol = 1e-4 + 1e-4 * np.abs(w).max() if k == "flow" else 1e-5
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


def test_build_refiner_from_config_reads_dtype_and_refuses_unknown_types():
    mcfg = _model_cfg("scflow")
    assert build_refiner_from_config(dict(mcfg, dtype="bf16")).dtype == torch.bfloat16
    assert build_refiner_from_config(dict(mcfg, dtype="fp32")).dtype is None
    for build in (j_build, build_refiner_from_config):
        with pytest.raises(KeyError):
            build(dict(mcfg, type="PoseRefiner"))


@pytest.mark.parametrize("path", [SCFLOW_CFG, RAFT_CFG], ids=["scflow", "raft"])
def test_reference_manifest_keys_in_port_checkpoints(path):
    """Every key of JAX's manifest for the shipped config is in the state
    dict the port writes, with the manifest's shape, and the port writes
    no other key but BatchNorm's step counts."""
    mcfg = Config.fromfile(path).model
    with torch.random.fork_rng(devices=[]):
        sd = reference_state_dict(build_refiner_from_config(mcfg))
    manifest = manifest_for_config(dict(mcfg))
    for k, shape in manifest.items():
        assert k in sd, k
        assert tuple(sd[k].shape) == tuple(shape), k
    assert {k for k in sd if k not in manifest} <= {k for k in sd
                                                    if k.endswith("num_batches_tracked")}


def _tiny_model(seed=0, **kw):
    mcfg = dict(_model_cfg("scflow"), **kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_refiner_from_config(mcfg)


def test_checkpoint_round_trip_and_strict_loading(tmp_path):
    src, dst = _tiny_model(0), _tiny_model(1)
    path = str(tmp_path / "w.pth")
    save_params(path, src, {"note": "x"})
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"state_dict", "meta"} and ckpt["meta"] == {"note": "x"}
    # the shared encoder is written twice, as the reference's module is
    assert torch.equal(ckpt["state_dict"]["real_encoder.conv1.weight"],
                       ckpt["state_dict"]["render_encoder.conv1.weight"])
    load_params(path, dst)
    for k, v in src.state_dict().items():
        assert torch.equal(v, dst.state_dict()[k]), k
    sd = dict(ckpt["state_dict"])
    broken = {"missing": {k: v for k, v in sd.items() if k != "context.conv2.bias"},
              "unexpected": dict(sd, extra=torch.zeros(1)),
              "mismatched": dict(sd, **{"context.conv2.bias": torch.zeros(3)}),
              "shared copy": dict(sd, **{"real_encoder.conv1.bias":
                                         sd["real_encoder.conv1.bias"] + 1})}
    names = {"missing": "context.conv2.bias", "unexpected": "extra",
             "mismatched": "context.conv2.bias", "shared copy": "real_encoder"}
    for what, bad in broken.items():
        torch.save({"state_dict": bad, "meta": {}}, str(tmp_path / "bad.pth"))
        with pytest.raises(ValueError, match=names[what]):
            load_params(str(tmp_path / "bad.pth"), _tiny_model(2))


def test_checkpoint_manager(tmp_path):
    model = _tiny_model(0)
    tx, _ = build_optimizer(model, dict(type="AdamW", lr=1e-3))
    state = TrainState(model, tx, 0)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore(state)[1] == 0
    for step in (10, 20, 30):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        state.apply_gradients()
        mgr.save(step, state)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["iter_20.pth", "iter_30.pth"]
    assert mgr.latest_step() == 30
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = _tiny_model(1)
    other = TrainState(fresh, build_optimizer(fresh, dict(type="AdamW", lr=1e-3))[0])
    other, step = mgr.restore(other)
    assert step == 30 and other.step == 3
    for k, v in saved.items():
        assert torch.equal(other.model.state_dict()[k], v), k
    assert other.tx.tx.state_dict()["state"][0]["step"] == 3
    assert mgr.maybe_save_best(10, state, "average/add_10", 0.5)
    assert not mgr.maybe_save_best(20, state, "average/add_10", 0.4)
    assert mgr.maybe_save_best(30, state, "average/add_10", 0.6)
    load_params(str(tmp_path / "best_ckpt.pth"), _tiny_model(3))
