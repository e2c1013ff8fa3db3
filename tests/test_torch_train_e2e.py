"""The reference's train workflow end to end on the CPU: the JAX package's
`train_main` and the port's (`python -m scflow_tpu_torch.cli train`, the
kernels' plain versions) in one process on the synthetic BOP set of
tests/synthetic_bop.py with the train config of tests/torch_train_helpers.py
(the shipped colour transforms; 64^2, 2 iterations, 2 classes, batch 2,
one thread worker, seed 0, 3 steps, a log line per step), both from one
init_cfg "Pretrained" .pth: PyTorch's initialisation (seed 0, the pose
head's output weights normal(0, 0.005)) carried to flax by the JAX
package's converter and written back through convert.state_dict_from_flax.
JAX's model.init is traced, not compiled (its variables are overwritten by
the .pth), and its mesh holds one of tests/conftest.py's 8 virtual
devices, so that it steps one card's batch.  Both packages draw the same samples (train_main seeds Python's
`random` and numpy's global RNG; the test seeds JAX's side alike).

Bounds: each step's logged (window-mean) loss and its terms within rtol
2e-3 (measured: 1e-4); the saved weights as test_saved_weights_match_jax
states, the effect of the one-step gradient bound of
tests/test_torch_train_apis.py (2e-2) through Adam's normalised steps
(measured: weight-leaf updates 13-15% apart at worst, 8.9% in all).  Then `cli.main(['train', ..., '--resume',
'--max-iters', '5'])` logs "Resumed from iter 3" and runs to 5,
`--launcher pytorch` raises, and without --device cpu on a host without a
card train_main raises."""

import logging
import re
import threading

import numpy as np
import pytest
import torch

from scflow_tpu_torch import cli
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.runtime.checkpoint import read_checkpoint, save_params

from synthetic_bop import build_synthetic_bop
from torch_port_helpers import keep_torch_rng, lecun_variables, np_tree  # noqa: F401
from torch_port_helpers import scflow_init_args
from torch_train_helpers import keep_global_rngs, seed_all, train_config_text  # noqa: F401

IMG, STEPS = 64, 3
LINE = re.compile(r"Iter \[(\d+)/\d+\] lr: ([0-9.e+-]+), [0-9.]+ it/s, (.*)$")


def _logged(log_text):
    """{step: {'lr': lr, name: value}} of a train_main log."""
    out = {}
    for line in log_text.splitlines():
        m = LINE.search(line)
        if m:
            out[int(m.group(1))] = dict(lr=float(m.group(2)), **{
                k: float(v) for k, v in (kv.split(": ") for kv in m.group(3).split(", "))})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import scflow_tpu.apis as japis
    import scflow_tpu.parallel as jparallel
    import scflow_tpu.runtime as jruntime
    from scflow_tpu.cli import train_main as j_train_main
    from scflow_tpu.runtime.convert_torch import convert_state_dict_to_variables

    root = tmp_path_factory.mktemp("train_e2e")
    info = build_synthetic_bop(root / "data", num_images=3, render_images=True)
    cfg_path = root / "cfg.py"
    text = train_config_text(root / "data", info["diameters"], root / "work")
    text += (f'\nmodel["init_cfg"] = dict(type="Pretrained", '
             f'checkpoint=r"{root / "init.pth"}")\n')
    cfg_path.write_text(text)
    cfg = Config.fromfile(str(cfg_path))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        port = build_refiner_from_config(cfg.model)
        g = torch.Generator().manual_seed(1)
        head = port.decoder.pose_pred
        with torch.no_grad():
            for lin in (head.rotation_pred, head.translation_pred):
                lin.weight.copy_(0.005 * torch.randn(lin.weight.shape, generator=g))
    from scflow_tpu.refiners.build import build_refiner_from_config as j_build_refiner
    from scflow_tpu.config import Config as JConfig

    template = lecun_variables(j_build_refiner(JConfig.fromfile(str(cfg_path)).model), 0,
                               *scflow_init_args(1, IMG))
    variables = np_tree(convert_state_dict_to_variables(
        {k: v.numpy() for k, v in port.state_dict().items()}, template))
    save_params(str(root / "init.pth"), state_dict_from_flax(variables))

    final = {}
    run = jruntime.IterRunner.run

    def keep_final(self):
        final["state"] = run(self)
        return final["state"]

    common = [str(cfg_path), "--max-iters", str(STEPS), "--num-workers", "1", "--seed", "0"]
    threads = set(threading.enumerate())
    jax_lines = _Lines()  # JAX's get_logger keeps the first log file a process gave it
    logging.getLogger("scflow_tpu").addHandler(jax_lines)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japis, "init_model_variables",
                   lambda c, model, image_size, seed=0: lecun_variables(
                       model, seed, *scflow_init_args(1, IMG)))
        mp.setattr(jruntime.IterRunner, "run", keep_final)
        # one card's batch: tests/conftest.py gives JAX 8 virtual CPU devices,
        # and train_main steps samples_per_gpu x devices samples
        make_mesh = jparallel.make_mesh
        mp.setattr(jparallel, "make_mesh", lambda: make_mesh(1))
        seed_all(0)
        try:
            j_train_main(common + ["--work-dir", str(root / "jax")])
        finally:
            logging.getLogger("scflow_tpu").removeHandler(jax_lines)
    for t in set(threading.enumerate()) - threads:  # JAX's loader threads draw on after its run
        t.join(timeout=60)
    state = final["state"]
    jax_weights = state_dict_from_flax(np_tree({"params": state.params,
                                                "batch_stats": state.batch_stats}))
    runner = cli.train_main(common + ["--work-dir", str(root / "port"), "--device", "cpu"])
    return dict(root=root, cfg_path=cfg_path, init=state_dict_from_flax(variables),
                jax_weights=jax_weights, runner=runner, jax_log="\n".join(jax_lines.lines))


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _log_text(work_dir):
    return "\n".join(p.read_text() for p in sorted(work_dir.glob("*.log")))


def test_logged_losses_match_jax(runs):
    want = _logged(runs["jax_log"])
    got = _logged(_log_text(runs["root"] / "port"))
    assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
    for step in want:
        assert set(got[step]) == set(want[step]) >= {"loss", "loss_pose", "loss_flow",
                                                      "loss_mask", "grad_norm", "lr"}
        for k in ("lr", "loss", "loss_pose", "loss_flow", "loss_mask"):
            np.testing.assert_allclose(got[step][k], want[step][k], rtol=2e-3,
                                       err_msg=f"step {step} {k}")


def test_saved_weights_match_jax(runs):
    """The port's final checkpoint against JAX's final state.  Adam's first
    steps move each element by about lr x sign(gradient), so an element
    whose gradient is float32 noise (conv biases before a norm) or small
    enough for the packages' 2e-2 gradient difference to flip its sign
    moves the other way: each weight leaf's update over the 3 steps within
    rel L2 0.25 of JAX's (all updates together within 0.15), every element
    within twice the 3 steps' summed lr, the BatchNorm statistics within
    5e-3 of their largest value."""
    saved = read_checkpoint(str(runs["root"] / "port" / "checkpoints" / f"iter_{STEPS}.pth"))
    got, want, init = saved["state_dict"], runs["jax_weights"], runs["init"]
    runner = runs["runner"]
    assert saved["meta"]["step"] == STEPS
    budget = 2 * sum(runner.lr_schedule(i) for i in range(STEPS))
    params = dict(runner.state.model.named_parameters())
    num = den = 0.0
    for k in params:
        assert float((got[k] - want[k]).abs().max()) <= budget, k
        dw, dg = want[k] - init[k], got[k] - init[k]
        num, den = num + float((dg - dw).pow(2).sum()), den + float(dw.pow(2).sum())
        if k.endswith("weight"):
            assert float((dg - dw).norm() / dw.norm()) <= 0.25, k
    assert (num / den) ** 0.5 <= 0.15
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            assert float((got[k] - want[k]).abs().max()) <= 5e-3 * float(want[k].abs().max()), k


def test_resume_and_dispatch(runs):
    root = runs["root"]
    cli.main(["train", str(runs["cfg_path"]), "--work-dir", str(root / "port"), "--resume",
              "--max-iters", "5", "--num-workers", "1", "--device", "cpu"])
    text = _log_text(root / "port")
    assert "Resumed from iter 3" in text and "Start training: iter 3 -> 5" in text
    assert sorted(_logged(text)) == [1, 2, 3, 4, 5]
    assert read_checkpoint(str(root / "port" / "checkpoints" / "iter_5.pth"))["meta"]["step"] == 5
    with pytest.raises(NotImplementedError, match="launcher 'pytorch'"):
        cli.main(["train", str(runs["cfg_path"]), "--launcher", "pytorch"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train_main([str(runs["cfg_path"]), "--work-dir", str(root / "card")])
