"""make_train_step_from_cfg for the RAFT family against the JAX package's
config-built step: one step of each package on the synthetic BOP set with
the train config of tests/torch_train_helpers.py as RAFTRefinerFlowMask
(64^2, 2 iterations, batch 2, the loader's first batch), from PyTorch's
initialisation carried to flax and back to the port's config-built model
by convert.state_dict_from_flax.  As tests/test_torch_raft_train.py, JAX's
network runs in float64 (its float32 feature-encoder gradients sit 2.4e-2
from its own float64 ones on such weights): the loss and logs within rtol
1e-3, every gradient leaf within rel L2 2e-2.  The port takes its kernels'
route ('pallas': the plain versions here), JAX's config-built step its
'xla' lookup; the decoder detaches the flow, so the two backwards form
the same level gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from scflow_tpu_torch.runtime.optim import build_optimizer
from scflow_tpu_torch.runtime.train_state import TrainState

from synthetic_bop import build_synthetic_bop
from test_torch_train import _worst_grad_rel
from torch_port_helpers import keep_torch_rng, lecun_variables, no_tf32, np_tree  # noqa: F401
from torch_train_helpers import keep_global_rngs, seed_all, train_config_text  # noqa: F401

IMG = 64


def test_raft_step_from_cfg_matches_jax_float64(tmp_path, no_tf32):
    from scflow_tpu.runtime.convert_torch import convert_state_dict_to_variables

    info = build_synthetic_bop(tmp_path / "data", num_images=2, render_images=True)
    path = tmp_path / "cfg.py"
    path.write_text(train_config_text(tmp_path / "data", info["diameters"], tmp_path / "work",
                                      "RAFTRefinerFlowMask", "RAFTDecoderMask"))
    cfg, jcfg = Config.fromfile(str(path)), JConfig.fromfile(str(path))
    with torch.random.fork_rng(devices=[]):
        seed_all(0)
        it = iter(DataLoader(build_dataset(cfg.data["train"]), samples_per_step=2,
                             num_workers=1, seed=0))
        batch = next(it)
        it.close()
        torch.manual_seed(1)
        port = build_refiner_from_config(cfg.model)
    batch = {k: v for k, v in batch.items() if k not in ("img_metas", "per_img_patch_num")}
    fmodel = j_build_refiner(jcfg.model)
    z = jnp.zeros((1, IMG, IMG, 3))
    variables = np_tree(convert_state_dict_to_variables(
        {k: v.numpy() for k, v in port.state_dict().items()}, lecun_variables(fmodel, 0, z, z)))

    j_render, _ = japis.build_render_assets(jcfg.model)
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    b64 = dict(batch, real_images=np.asarray(batch["real_images"], np.float64))
    clip = jcfg.optimizer_config["grad_clip"]["max_norm"]
    with jax.enable_x64(True):
        tx, _ = j_build_optimizer(dict(jcfg.optimizer), dict(jcfg.lr_config), clip)
        j_step = japis.make_train_step_from_cfg(jcfg, fmodel, j_render, None, (IMG, IMG))
        j_new, j_logs = j_step(JTrainState.create(v64["params"], tx, v64["batch_stats"]),
                               {k: jnp.asarray(x) for k, x in b64.items()})
        adam = [x for x in jax.tree_util.tree_leaves(
            j_new.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(x, optax.ScaleByAdamState)][0]
        j_grads = state_dict_from_flax({"params": jax.tree_util.tree_map(
            lambda m: np.asarray(m) / (1 - 0.9), adam.mu)})
        j_logs = {k: float(x) for k, x in j_logs.items()}

    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    model.load_state_dict(state_dict_from_flax(variables), strict=False)
    render, _ = apis.build_render_assets(cfg.model, device="cpu")
    ptx, _ = build_optimizer(model, dict(cfg.optimizer), dict(cfg.lr_config), clip)
    step = apis.make_train_step_from_cfg(cfg, model, render, None, (IMG, IMG), device="cpu")
    state, logs = step(TrainState(model, ptx), batch)
    assert set(logs) == set(j_logs) and "loss_occ" in logs
    for k, w in j_logs.items():
        np.testing.assert_allclose(float(logs[k]), w, rtol=1e-3, err_msg=k)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert set(grads) == set(j_grads)
    assert _worst_grad_rel(grads, j_grads) <= 2e-2
