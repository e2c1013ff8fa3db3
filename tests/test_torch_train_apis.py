"""The train side of the port's apis.py against the JAX package's, on the
synthetic BOP set of tests/synthetic_bop.py with the train config of
tests/torch_train_helpers.py (64^2, 2 iterations, 2 classes, batch 2):
build_loss_assets; make_train_step_from_cfg for SCFlow, one step of each
package from the same weights (PyTorch's initialisation carried to flax,
and to the port's config-built model by convert.state_dict_from_flax) on
the loader's first batch, at the train-step parity bounds (loss and logs
rtol 1e-3, every gradient leaf rel L2 <= 2e-2; test_torch_train.py's
protocol: JAX's gradients read from its Adam state), with the port on its
kernels' route ('pallas': the plain versions here) where JAX's
config-built step takes its 'xla' lookup (at 64^2 both render on the
brute-force raster); the route it picks; and load_init_weights: a missing
file, a reference-layout .pth, an mmflow-layout .pth written from a
model's own weights (loaded by both packages to equal parameters), an
orbax directory."""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scflow_tpu import apis as japis
from scflow_tpu.config import Config as JConfig
from scflow_tpu.refiners.build import build_refiner_from_config as j_build_refiner
from scflow_tpu.runtime import TrainState as JTrainState
from scflow_tpu.runtime import build_optimizer as j_build_optimizer
from scflow_tpu_torch import apis
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.datasets import DataLoader
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.registry import build_dataset
from scflow_tpu_torch.runtime.checkpoint import reference_state_dict, save_params
from scflow_tpu_torch.runtime.optim import build_optimizer
from scflow_tpu_torch.runtime.train_state import TrainState

from synthetic_bop import build_synthetic_bop
from test_torch_train import _worst_grad_rel
from torch_port_helpers import keep_torch_rng, lecun_variables, no_tf32, np_tree  # noqa: F401
from torch_port_helpers import scflow_init_args
from torch_train_helpers import keep_global_rngs, seed_all, train_config_text  # noqa: F401

IMG = 64


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The config, the loader's first batch, and the same weights in both
    packages: the port's model from PyTorch's initialisation (seed 0, the
    pose head's output weights normal(0, 0.005)), carried to flax by the
    JAX package's converter."""
    from scflow_tpu.runtime.convert_torch import convert_state_dict_to_variables

    root = tmp_path_factory.mktemp("train_apis")
    info = build_synthetic_bop(root / "data", num_images=3, render_images=True)
    path = root / "cfg.py"
    path.write_text(train_config_text(root / "data", info["diameters"], root / "work"))
    cfg, jcfg = Config.fromfile(str(path)), JConfig.fromfile(str(path))
    with torch.random.fork_rng(devices=[]):
        seed_all(0)
        it = iter(DataLoader(build_dataset(cfg.data["train"]), samples_per_step=2,
                             num_workers=1, seed=0))
        batch = next(it)
        it.close()
        torch.manual_seed(0)
        port = build_refiner_from_config(cfg.model)
        g = torch.Generator().manual_seed(1)
        head = port.decoder.pose_pred
        with torch.no_grad():
            for lin in (head.rotation_pred, head.translation_pred):
                lin.weight.copy_(0.005 * torch.randn(lin.weight.shape, generator=g))
    fmodel = j_build_refiner(jcfg.model)
    template = lecun_variables(fmodel, 0, *scflow_init_args(1, IMG))
    variables = np_tree(convert_state_dict_to_variables(
        {k: v.numpy() for k, v in port.state_dict().items()}, template))
    batch = {k: v for k, v in batch.items() if k not in ("img_metas", "per_img_patch_num")}
    return dict(root=root, path=str(path), cfg=cfg, jcfg=jcfg, batch=batch, fmodel=fmodel,
                variables=variables)


def test_build_loss_assets_matches_jax(setup):
    got = apis.build_loss_assets(setup["cfg"].model, 2, device="cpu")
    want = japis.build_loss_assets(setup["jcfg"].model, 2)
    for name in ("points", "valid", "sym", "diameters"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    no_mesh = dict(setup["cfg"].model, pose_loss_cfg={})
    assert apis.build_loss_assets(no_mesh, 2, device="cpu") is None


def test_scflow_step_from_cfg_matches_jax(setup, no_tf32):
    cfg, jcfg, batch = setup["cfg"], setup["jcfg"], setup["batch"]
    j_render, j_bank = japis.build_render_assets(jcfg.model)
    tx, _ = j_build_optimizer(dict(jcfg.optimizer), dict(jcfg.lr_config),
                              jcfg.optimizer_config["grad_clip"]["max_norm"])
    v = setup["variables"]
    j_step = japis.make_train_step_from_cfg(jcfg, setup["fmodel"], j_render,
                                            japis.build_loss_assets(jcfg.model, j_bank.num_class),
                                            (IMG, IMG))
    j_new, j_logs = j_step(JTrainState.create(v["params"], tx, v["batch_stats"]),
                           {k: jnp.asarray(x) for k, x in batch.items()})
    adam = [x for x in jax.tree_util.tree_leaves(
        j_new.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)][0]
    j_grads = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - 0.9), adam.mu)})

    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    model.load_state_dict(state_dict_from_flax(v), strict=False)
    render, bank = apis.build_render_assets(cfg.model, device="cpu")
    ptx, _ = build_optimizer(model, dict(cfg.optimizer), dict(cfg.lr_config),
                             cfg.optimizer_config.grad_clip.max_norm)
    step = apis.make_train_step_from_cfg(cfg, model, render,
                                         apis.build_loss_assets(cfg.model, bank.num_class,
                                                                device="cpu"),
                                         (IMG, IMG), device="cpu")
    state, logs = step(TrainState(model, ptx), batch)
    assert set(logs) == set(j_logs) and state.step == 1
    for k, w in j_logs.items():
        np.testing.assert_allclose(float(logs[k]), float(w), rtol=1e-3, err_msg=k)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert set(grads) == set(j_grads)
    assert _worst_grad_rel(grads, j_grads) <= 2e-2


@pytest.mark.parametrize("size,lookup", [((IMG, IMG), "pallas"), ((IMG, 48), "auto")])
def test_step_from_cfg_takes_the_kernel_route(setup, monkeypatch, size, lookup):
    """'pallas' render and, on a square image, 'pallas' lookup (else
    'auto', JAX's route for such maps), with the config's loss fields."""
    seen = {}
    monkeypatch.setattr(apis, "make_scflow_train_step", lambda *a, **kw: seen.update(kw))
    cfg = setup["cfg"]
    apis.make_train_step_from_cfg(cfg, None, None, None, size, device="cpu")
    assert seen["render_backend"] == "pallas" and seen["lookup_backend"] == lookup
    assert seen["image_size"] == size and seen["render_cull_backfaces"] is False
    assert seen["loss_kwargs"] == dict(gamma=0.8, pose_weight=10.0, flow_weight=0.1,
                                       mask_weight=10.0, disentangle_z=True, pose_loss_type=1)
    assert seen["render_augmentations"] is None
    aug = copy.deepcopy(cfg)
    aug.model["render_augmentations"] = [dict(type="ColorJiggle", brightness=0.3)]
    apis.make_train_step_from_cfg(aug, None, None, None, size, device="cpu")
    assert seen["render_augmentations"] == [dict(type="ColorJiggle", brightness=0.3)]
    # a dict where the config wants a list of dicts: the step refuses it
    bad = copy.deepcopy(cfg)
    bad.model["render_augmentations"] = dict(type="ColorJiggle")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="render augmentations must be a list"):
        apis.make_train_step_from_cfg(bad, None, None, None, size, device="cpu")


def _model_pair(setup, seed):
    """A port model of the config with weights from torch seed `seed`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_refiner_from_config(setup["cfg"].model)
    return model


def _mmflow(sd):
    """The reference layout in mmflow's names, with a foreign decoder key."""
    out = {}
    for k, v in sd.items():
        if k.startswith("real_encoder."):
            out["encoder." + k[len("real_encoder."):]] = v
        elif k.startswith("context."):
            out["cxt_encoder." + k[len("context."):]] = v
        elif not k.startswith("render_encoder."):
            out[k] = v
    out["decoder.mmflow_only.weight"] = torch.ones(3)
    return out


def test_load_init_weights(setup, tmp_path, caplog):
    cfg = setup["cfg"]
    src = _model_pair(setup, 1)
    want = reference_state_dict(src)

    def load(path):
        model = _model_pair(setup, 2)
        mcfg = dict(cfg.model, init_cfg=dict(type="Pretrained", checkpoint=str(path)))
        logger = logging.getLogger("test_load_init_weights")
        return apis.load_init_weights(mcfg, model, logger)

    before = reference_state_dict(_model_pair(setup, 2))
    with caplog.at_level(logging.WARNING, logger="test_load_init_weights"):
        kept = reference_state_dict(load(tmp_path / "missing.pth"))
    assert "not found; using random init" in caplog.text
    assert all(torch.equal(kept[k], v) for k, v in before.items())

    save_params(str(tmp_path / "ref.pth"), src)
    got = reference_state_dict(load(tmp_path / "ref.pth"))
    assert all(torch.equal(got[k], v) for k, v in want.items())

    partial = {k: v for k, v in want.items() if not k.startswith("decoder.")}
    partial["unknown.weight"] = torch.zeros(2)
    torch.save({"state_dict": partial, "meta": {}}, tmp_path / "partial.pth")
    got = reference_state_dict(load(tmp_path / "partial.pth"))
    assert all(torch.equal(got[k], v if k in partial else before[k]) for k, v in want.items())

    torch.save({"state_dict": _mmflow(want)}, tmp_path / "mmflow.pth")
    got = reference_state_dict(load(tmp_path / "mmflow.pth"))
    assert all(torch.equal(got[k], v) for k, v in want.items())
    fmodel = setup["fmodel"]
    template = lecun_variables(fmodel, 3, *scflow_init_args(1, IMG))
    jvars = japis.load_init_weights(
        dict(setup["jcfg"].model, init_cfg=dict(type="Pretrained",
                                                checkpoint=str(tmp_path / "mmflow.pth"))),
        template)
    jsd = state_dict_from_flax(np_tree(jvars))
    for k, v in jsd.items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0, msg=k)

    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        load(tmp_path / "orbax")
    wrong = dict(want)
    wrong["decoder.pose_pred.rotation_pred.weight"] = torch.zeros(3, 3)
    torch.save({"state_dict": wrong}, tmp_path / "wrong.pth")
    with pytest.raises(ValueError, match="mismatched"):
        load(tmp_path / "wrong.pth")


def test_visualize_helpers_match_jax():
    """flow2rgb (cv2's HSV2RGB in the JAX package, imops.hsv2bgr here) and
    simple_forward_warp on random flows (with unknown and non-finite
    entries for flow2rgb)."""
    from scflow_tpu.utils import visualize as jvis
    from scflow_tpu_torch import visualize

    rng = np.random.default_rng(0)
    flow = rng.normal(0, 20, (37, 45, 2)).astype(np.float32)
    flow[3, 4] = 500.0
    flow[5, 6, 1] = np.nan
    np.testing.assert_array_equal(visualize.flow2rgb(flow, unknown_thr=399.0),
                                  jvis.flow2rgb(flow, unknown_thr=399.0))
    np.testing.assert_array_equal(visualize.flow2rgb(np.zeros((4, 5, 2), np.float32)),
                                  jvis.flow2rgb(np.zeros((4, 5, 2), np.float32)))
    image = rng.uniform(0, 1, (37, 45, 3)).astype(np.float32)
    mask = (rng.uniform(size=(37, 45)) > 0.4).astype(np.float32)
    flow = np.nan_to_num(flow)
    np.testing.assert_array_equal(visualize.simple_forward_warp(image, flow, mask),
                                  jvis.simple_forward_warp(image, flow, mask))


def test_tb_image_fn_panels(setup):
    """The TensorBoard panels of the runner's last batch: each (H, W, 3) in
    [0, 1]; the gt flow, from a zero depth as in the JAX package, is all
    unknown (black)."""
    from types import SimpleNamespace

    cfg = setup["cfg"]
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    render, _ = apis.build_render_assets(cfg.model, device="cpu")
    image_fn = apis.build_tb_image_fn(cfg, model, render, (IMG, IMG), device="cpu")
    assert image_fn(SimpleNamespace(last_batch=None)) == {}
    batch = {k: torch.as_tensor(v) for k, v in setup["batch"].items()}
    panels = image_fn(SimpleNamespace(last_batch=batch))
    assert sorted(panels) == ["train/gt_flow", "train/pred_flow", "train/pred_mask",
                              "train/real_image", "train/warped_render"]
    for name, img in panels.items():
        assert img.shape == (IMG, IMG, 3) and 0 <= img.min() and img.max() <= 1, name
    assert not panels["train/gt_flow"].any()
