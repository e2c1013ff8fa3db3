"""The port's workflows over the ranks of a job on the CPU (gloo), each
against its single-process run, on tests/synthetic_bop.py's set with
tests/test_e2e_cli.py's config (64^2, 2 iterations, batch 2 per rank):

- `cli test --launcher pytorch` under `python -m torch.distributed.run
  --standalone --nproc_per_node 2` on an odd image count (3: shards of 2
  and 1 images) writes the single-process run's --out results and BOP
  export (scene_gt.json less its per-image time), in dataset order;
- `cli train --launcher pytorch` at 2 ranks for 3 steps, then a job
  resumed from its step-2 checkpoint that restores it bit for bit
  (weights, BatchNorm buffers, optimizer state, step);
- IterRunner on a rank other than 0 writes no checkpoint, log or
  eval_history (in one process, with the rank patched in);
- PoseService over Mesh(['cpu', 'cpu']) answers the one-device service's
  responses, with its bucket rounded to a multiple of 2.

The rank processes import torch and the port only."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_helpers as tph
from scflow_tpu_torch import cli
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.runtime.checkpoint import save_params

from synthetic_bop import build_synthetic_bop
from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import keep_global_rngs  # noqa: F401


def torchrun(args, timeout=300):
    """`python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    scflow_tpu_torch.cli ARGS` from the repo root; its output on failure."""
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node", "2", "-m", "scflow_tpu_torch.cli", *args],
                       cwd=str(tph.REPO), env=tph.child_env(), capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, (r.stdout + r.stderr)[-6000:]
    return r.stdout + r.stderr


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from test_e2e_cli import CONFIG_TMPL

    root = tmp_path_factory.mktemp("parallel_cli")
    info = build_synthetic_bop(root / "data", num_images=3)
    cfg_path = root / "cfg.py"
    cfg_path.write_text(CONFIG_TMPL.format(root=str(root / "data"), diameters=info["diameters"],
                                           work_dir=str(root / "work"),
                                           model_type="SCFlowRefiner",
                                           decoder_type="SCFlowDecoder"))
    cfg = Config.fromfile(str(cfg_path))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        save_params(str(root / "w.pth"), build_refiner_from_config(cfg.model))
    return dict(root=root, cfg_path=cfg_path, cfg=cfg)


def _scene_gts(save_dir):
    out = {}
    for path in sorted(save_dir.rglob("scene_gt.json")):
        content = json.loads(path.read_text())
        for preds in content.values():
            for p in preds:
                p.pop("time")  # each run's seconds per image
        out[str(path.relative_to(save_dir))] = content
    return out


def test_cli_test_on_two_ranks_equals_one_process(setup):
    root = setup["root"]
    common = [str(setup["cfg_path"]), "--checkpoint", str(root / "w.pth"), "--device", "cpu",
              "--format-only"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' count: the same arithmetic
    try:
        one = cli.test_main(common + ["--out", str(root / "one.json"),
                                      "--save-dir", str(root / "bop_one")])
    finally:
        torch.set_num_threads(threads)
    log = torchrun(["test", *common, "--launcher", "pytorch", "--out", str(root / "two.json"),
                    "--save-dir", str(root / "bop_two")])
    assert "rank 1 of 2 (local 1 of 2) on cpu, backend gloo (the CPU)" in log
    want = json.loads((root / "one.json").read_text())
    got = json.loads((root / "two.json").read_text())
    assert len(want) == len(one["results"]) == 3
    assert [r["img_metas"]["img_path"] for r in got] == [r["img_metas"]["img_path"]
                                                          for r in want]
    assert got == want
    assert _scene_gts(root / "bop_two") == _scene_gts(root / "bop_one") != {}


def test_cli_train_on_two_ranks_then_resume_restores_bit_for_bit(setup):
    """3 steps at 2 ranks (checkpoints at 2 and 3, one log file), then a
    job resumed from the step-2 checkpoint with --max-iters 2: it restores
    the weights, BatchNorm buffers, optimizer state and step, and its
    end-of-run checkpoint equals the one it read bit for bit.  (The loader
    restarts its index stream on resume, as JAX's does, so a resumed run's
    later steps see other batches than the unbroken run's.)"""
    root = setup["root"]
    common = [str(setup["cfg_path"]), "--launcher", "pytorch", "--device", "cpu",
              "--num-workers", "1", "--cfg-options", "checkpoint_config.interval=2"]
    log = torchrun(["train", *common, "--work-dir", str(root / "straight"), "--max-iters", "3"])
    assert "2 devices / 2 processes, global batch 4 (local 2)" in log
    ckpts = root / "straight" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["iter_2.pth", "iter_3.pth"]
    assert len(list((root / "straight").glob("*.log"))) == 1
    (root / "resumed" / "checkpoints").mkdir(parents=True)
    shutil.copy(ckpts / "iter_2.pth", root / "resumed" / "checkpoints")
    log = torchrun(["train", *common, "--work-dir", str(root / "resumed"), "--resume",
                    "--max-iters", "2"])
    assert "Resumed from iter 2" in log and "Start training: iter 2 -> 2" in log
    a = torch.load(ckpts / "iter_2.pth", weights_only=True)
    b = torch.load(root / "resumed" / "checkpoints" / "iter_2.pth", weights_only=True)
    assert a["meta"]["step"] == b["meta"]["step"] == 2
    assert a["state_dict"].keys() == b["state_dict"].keys()
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k, v in sa[i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb[i][k])), (i, k)
    last = torch.load(ckpts / "iter_3.pth", weights_only=True)["state_dict"]
    assert any(not torch.equal(v, last[k]) for k, v in a["state_dict"].items())


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    """IterRunner's hooks on rank 1 of 2: the step runs, nothing is written;
    on rank 0 the checkpoints and eval_history.json are."""
    from scflow_tpu_torch.runtime import runner as runner_mod
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    barriers = []
    monkeypatch.setattr(runner_mod, "barrier", lambda: barriers.append(1))

    def run(rank, work):
        monkeypatch.setattr(runner_mod, "rank_world", lambda: (rank, 2))
        model = torch.nn.Linear(2, 2)
        tx, _ = build_optimizer(model.parameters(), dict(type="SGD", lr=0.1), None)

        def step(state, batch):
            state.tx.zero_grad()
            state.model(torch.ones(1, 2)).sum().backward()
            return state, {"loss": torch.tensor(1.0), "grad_norm": state.apply_gradients()}

        hooks = [runner_mod.CheckpointHook(interval=1),
                 runner_mod.EvalHook(lambda s: {"m": 1.0}, interval=1, save_best="m")]
        runner = runner_mod.IterRunner(step, TrainState(model, tx), iter([{}] * 2), 2,
                                       work_dir=str(tmp_path / work), hooks=hooks)
        runner.run()
        return runner

    r1 = run(1, "rank1")
    assert r1.step == 2 and not r1.is_main
    assert not any((tmp_path / "rank1").rglob("*.*"))
    assert len(barriers) == 5  # 2 checkpoints, 2 evaluations, the last checkpoint
    run(0, "rank0")
    names = {p.name for p in (tmp_path / "rank0").rglob("*.*")}
    assert {"iter_1.pth", "iter_2.pth", "eval_history.json", "best_ckpt.pth"} <= names


def test_pose_service_over_a_mesh_equals_one_device():
    """PoseService(mesh=Mesh(['cpu', 'cpu'])) with a serve fn per device
    (parallel.replicate's replicas): the one-device service's responses on
    the same requests, under the fixed and the power-of-two buckets, with
    the bucket a multiple of 2 (3 objects: 4 rows, 2 per device)."""
    from test_torch_server import HW, IMG, NCLASS, make_request

    from scflow_tpu_torch.parallel import Mesh, replicate
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from scflow_tpu_torch.runtime.server import PoseService
    from scflow_tpu_torch.serving import make_serving_fn

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=2).eval()
    ra = RenderAssets.from_bank(make_synthetic_bank(NCLASS), device="cpu")
    mesh = Mesh(["cpu", "cpu"])
    fns = [make_serving_fn(m, ra, ra.verts, ra.vert_valid, image_size=IMG, device="cpu")
           for m in replicate(model, mesh)]
    reqs = [make_request(p=2, hw=HW, seed=0), make_request(p=1, hw=HW, seed=1)]
    seen = []
    for fixed in (True, False):
        one = PoseService(fns[0], frame_hw=HW, num_class=NCLASS, max_frames=4, max_objects=8,
                          fixed_bucket=fixed, device="cpu")

        def spy(fn):
            def call(frames, frame_idx, *rest):
                seen.append(frame_idx.shape[0])
                return fn(frames, frame_idx, *rest)
            return call

        two = PoseService([spy(f) for f in fns], frame_hw=HW, num_class=NCLASS, max_frames=4,
                          max_objects=8, fixed_bucket=fixed, mesh=mesh)
        want, got = one.run(reqs), two.run(reqs)
        for w, g in zip(want, got):
            for k in ("rotations", "translations"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-4, err_msg=k)
    assert seen == [4, 4, 2, 2]  # fixed: 8 rows in halves; pow2: 3 -> 4 rows, 2 each
