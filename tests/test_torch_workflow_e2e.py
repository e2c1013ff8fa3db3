"""The reference's test workflow end to end: the port's
`cli.test_main --eval --format-only` (on the CPU, the kernels' plain
versions) against the JAX package's on the synthetic BOP set of
tests/synthetic_bop.py with tests/test_e2e_cli.py's config at 128^2 (2
iterations, 2 classes), through one `.pth` that the port's save_params
wrote from seeded weights whose poses move (the pose head's output
kernels normal(0, 0.02)).  Both sides render with the raster kernel's
formula: the port's test_main takes K2's plain version on the CPU, and
JAX's run is made to take its K2 in interpret mode (its 'auto' would take
its XLA raster, whose coverage test flips edge pixels against the
kernel's); 128^2 is the smallest size JAX's kernel takes.  The lookup is
the port's K1 plain version against JAX's XLA form (equal to 1e-6).

JAX's load_eval_checkpoint checks a `.pth` against its manifest of the
reference's 256^2 network, whose pose-head FC width depends on the image
size; the test hands it the same manifest at 128^2's feature size
(scflow_refiner_manifest(feat_size=(16, 16))).  Bounds: per-object poses
within tests/test_torch_slice.py's entry-point bounds (rotations atol
2e-3; translations rtol 2e-3, atol 2e-2); the port's evaluate on JAX's
poses equals JAX's metrics to 1e-9; the BOP exports agree to those bounds;
the `python -m scflow_tpu_torch.cli test` command runs."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from scflow_tpu_torch import cli
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.registry import build_dataset
from scflow_tpu_torch.runtime.checkpoint import save_params

from synthetic_bop import build_synthetic_bop
from test_e2e_cli import CONFIG_TMPL
from torch_port_helpers import keep_torch_rng  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ROT, TRANS = dict(atol=2e-3), dict(rtol=2e-3, atol=2e-2)
IMG = 128  # the smallest size JAX's raster kernel takes (tiles 128 pixels wide)


def _jax_kernel_render(mp):
    """JAX's render through its raster kernel (K2, interpret mode), as the
    port's test_main renders through K2's plain version on the CPU: JAX's
    'auto' takes its XLA raster off the TPU, whose coverage formula flips
    edge pixels against the kernel's."""
    import scflow_tpu.ops.pallas.rasterize as jrz
    import scflow_tpu.refiners.system as jsystem

    resolve, v3 = jsystem.resolve_backend, jrz.rasterize_shaded_pallas_v3
    traced = []

    def interpret(*a, **kw):
        traced.append(1)
        return v3(*a, **{**kw, "interpret": True})

    mp.setattr(jsystem, "resolve_backend",
               lambda name: "pallas" if name == "auto" else resolve(name))
    mp.setattr(jrz, "rasterize_shaded_pallas_v3", interpret)
    return traced


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import scflow_tpu.runtime.manifest as manifest
    from scflow_tpu.cli import test_main as j_test_main

    root = tmp_path_factory.mktemp("workflow_e2e")
    info = build_synthetic_bop(root / "data", num_images=3, render_images=True)
    cfg_path = root / "cfg.py"
    text = CONFIG_TMPL.format(root=str(root / "data"), diameters=info["diameters"],
                              work_dir=str(root / "work"), model_type="SCFlowRefiner",
                              decoder_type="SCFlowDecoder")
    assert "image_scale = 64" in text
    cfg_path.write_text(text.replace("image_scale = 64", f"image_scale = {IMG}"))
    cfg = Config.fromfile(str(cfg_path))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_refiner_from_config(cfg.model)
        head = model.decoder.pose_pred
        with torch.no_grad():
            for lin in (head.rotation_pred, head.translation_pred):
                lin.weight.normal_(0.0, 0.02)
    ckpt = str(root / "w.pth")
    save_params(ckpt, model)
    common = [str(cfg_path), "--checkpoint", ckpt, "--eval", "--format-only"]
    rng = torch.get_rng_state()
    port = cli.test_main(common + ["--save-dir", str(root / "bop_port"), "--out",
                               str(root / "port.json"), "--device", "cpu"])
    port["rng_kept"] = torch.equal(rng, torch.get_rng_state())
    head_cfg = cfg.model["decoder"]["pose_head_cfg"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(manifest, "manifest_for_config",
                   lambda mcfg: manifest.scflow_refiner_manifest(
                       num_class=head_cfg["num_class"], feat_size=(IMG // 8, IMG // 8)))
        traced = _jax_kernel_render(mp)
        j_test_main(common + ["--save-dir", str(root / "bop_jax"), "--out",
                              str(root / "jax.json")])
    assert traced  # JAX's render went through its kernel
    return root, cfg_path, ckpt, port


def _load(path):
    return json.loads(Path(path).read_text())


def test_poses_match_jax(runs):
    root, _, _, port = runs
    got, want = _load(root / "port.json"), _load(root / "jax.json")
    assert [r["img_metas"] for r in got] == [r["img_metas"] for r in want]
    initial = _load(root / "data" / "initial_poses" / "000001" / "scene_gt.json")
    moved = 0.0
    for i, (g, w, res) in enumerate(zip(got, want, port["results"])):
        assert g["pred"]["labels"] == w["pred"]["labels"]
        np.testing.assert_allclose(g["pred"]["rotations"], w["pred"]["rotations"], **ROT)
        np.testing.assert_allclose(g["pred"]["translations"], w["pred"]["translations"], **TRANS)
        np.testing.assert_allclose(res["pred"]["rotations"], g["pred"]["rotations"], atol=1e-6)
        t0 = np.array([o["cam_t_m2c"] for o in initial[str(i)]])
        moved = max(moved, float(np.abs(np.asarray(w["pred"]["translations"]) - t0).max()))
    assert moved > 1.0  # mm: the refinement moved the poses well beyond the bounds
    assert port["metrics"] is not None and port["stats"]["images"] == 3


def test_metrics_and_exports_match_jax(runs):
    root, cfg_path, _, port = runs
    evals = sorted((root / "work").glob("eval_*.json"))
    assert evals  # both wrote one; same second or not, each parses
    want_results = [dict(pred={k: np.asarray(v) for k, v in r["pred"].items()},
                         img_metas=r["img_metas"]) for r in _load(root / "jax.json")]
    dataset = build_dataset(dict(Config.fromfile(str(cfg_path)).data["test"]))
    metric = Config.fromfile(str(cfg_path)).evaluation["metric"]
    from scflow_tpu.config import Config as JConfig
    from scflow_tpu.datasets import build_dataset as j_build_dataset

    want = j_build_dataset(dict(JConfig.fromfile(str(cfg_path)).data["test"])).evaluate(
        want_results, metric=metric)
    got = dataset.evaluate(want_results, metric=metric)
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-9, k
    assert set(port["metrics"]) == set(want)
    g = _load(root / "bop_port" / "000001" / "scene_gt.json")
    w = _load(root / "bop_jax" / "000001" / "scene_gt.json")
    assert set(g) == set(w) == {"0", "1", "2"}
    for img_id in w:
        assert [o["obj_id"] for o in g[img_id]] == [o["obj_id"] for o in w[img_id]]
        for go, wo in zip(g[img_id], w[img_id]):
            np.testing.assert_allclose(go["cam_R_m2c"], wo["cam_R_m2c"], **ROT)
            np.testing.assert_allclose(go["cam_t_m2c"], wo["cam_t_m2c"], **TRANS)


def test_cli_module_runs_the_test_command(runs, tmp_path):
    root, cfg_path, ckpt, _ = runs
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "scflow_tpu_torch.cli", "test", str(cfg_path),
                        "--checkpoint", ckpt, "--device", "cpu", "--limit", "1",
                        "--out", str(tmp_path / "one.json")],
                       cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "1 images in" in r.stderr and len(_load(tmp_path / "one.json")) == 1
    # train is ported (tests/test_torch_train_e2e.py): without a card it needs
    # --device cpu; serve is not ported and names its ROADMAP item
    r = subprocess.run([sys.executable, "-m", "scflow_tpu_torch.cli", "train", str(cfg_path)],
                       cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device is available" in r.stderr
    r = subprocess.run([sys.executable, "-m", "scflow_tpu_torch.cli", "serve", str(cfg_path)],
                       cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "item 9" in r.stderr


def test_test_main_leaves_torch_rng_alone(runs):
    """test_main builds its model from the config on a forked RNG (the
    weights come from the seed and the checkpoint), so torch's global RNG,
    which tests/test_grad_parity.py draws from unseeded, is left as found
    (this module's fixture runs outside keep_torch_rng)."""
    assert runs[3]["rng_kept"]


def test_eval_loop_counts_every_stage(runs):
    """single_process_test, the loop test_main runs (load, call, fetch,
    remap per image), called alone on the same weights gives test_main's
    results in the dataset's order, the same labels and poses within 1e-6
    (a CPU call repeated later in the process differs by up to 5e-7), and
    counts every image's stages."""
    from scflow_tpu_torch.apis import (build_render_assets, load_eval_checkpoint,
                                       make_infer_from_cfg)
    from scflow_tpu_torch.runtime.eval_loop import single_process_test

    _, cfg_path, ckpt, port = runs
    cfg = Config.fromfile(str(cfg_path))
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    load_eval_checkpoint(ckpt, model)
    assets, _ = build_render_assets(cfg.model, device="cpu")
    infer, _ = make_infer_from_cfg(cfg, model, assets, (IMG, IMG), slim=True, device="cpu")
    np.random.seed(0)
    stats = {}
    got = single_process_test(infer, build_dataset(cfg.data["test"]), stats=stats)
    assert stats["images"] == 3 and all(stats[k] > 0 for k in ("load", "call", "fetch"))
    assert len(got) == len(port["results"])
    for a, b in zip(got, port["results"]):
        assert a["img_metas"] == b["img_metas"]
        np.testing.assert_array_equal(a["pred"]["labels"], b["pred"]["labels"])
        for k in ("rotations", "translations"):
            np.testing.assert_allclose(a["pred"][k], b["pred"][k], rtol=0, atol=1e-6)


def test_non_square_config_takes_jax_lookup_route(runs, monkeypatch):
    """A config whose renderer.image_size is not square (256x192, its test
    pipeline resizing to 192 and padding to 256x192) builds its inference
    call with the lookup on 'auto', JAX's route for such maps, which the
    card accepts (_check_lookup refuses 'pallas' there on a CUDA device),
    and the call runs on one image of the synthetic set: finite
    orthonormal poses."""
    from scflow_tpu_torch import apis
    from scflow_tpu_torch.refiners.system import _check_lookup
    from scflow_tpu_torch.runtime.eval_loop import single_process_test

    _, cfg_path, _, _ = runs
    cfg = Config.fromfile(str(cfg_path))
    cfg.merge_from_dict({"model.renderer.image_size": (256, 192)})
    for t in cfg.data["test"]["pipeline"]:
        if t["type"] == "Resize":
            t["img_scale"] = 192
        elif t["type"] == "Pad":
            t["size"] = (256, 192)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_refiner_from_config(cfg.model)
    seen = {}
    build = apis.make_scflow_infer_fn

    def record(*args, **kw):
        seen.update(kw)
        return build(*args, **kw)

    monkeypatch.setattr(apis, "make_scflow_infer_fn", record)
    assets, _ = apis.build_render_assets(cfg.model, device="cpu")
    infer, _ = apis.make_infer_from_cfg(cfg, model, assets, (256, 192), slim=True,
                                        device="cpu")
    assert seen["lookup_backend"] == "auto" and seen["render_backend"] == "pallas"
    card = torch.device("cuda", 0)
    _check_lookup(model, seen["lookup_backend"], "tent", card, (256, 192))
    with pytest.raises(ValueError, match="square"):
        _check_lookup(model, "pallas", "tent", card, (256, 192))
    dataset = build_dataset(cfg.data["test"])
    dataset.img_files = dataset.img_files[:1]
    np.random.seed(0)
    (res,) = single_process_test(infer, dataset)
    R, t = res["pred"]["rotations"], res["pred"]["translations"]
    assert np.isfinite(R).all() and np.isfinite(t).all()
    np.testing.assert_allclose(np.einsum("nji,njk->nik", R, R), np.broadcast_to(
        np.eye(3), R.shape), atol=1e-4)


def test_init_model_variables_is_seeded(runs):
    """init_model_variables gives the model the weights of a build on a
    torch RNG seeded `seed`: the same seed the same state, another seed
    another, and torch's global RNG left as it was."""
    from scflow_tpu_torch.apis import init_model_variables

    _, cfg_path, _, _ = runs
    cfg = Config.fromfile(str(cfg_path))
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    rng = torch.get_rng_state()
    a = {k: v.clone() for k, v in init_model_variables(cfg.model, model, 0, "cpu").items()}
    b = init_model_variables(cfg.model, model, 0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = init_model_variables(cfg.model, model, 1, "cpu")
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert torch.equal(rng, torch.get_rng_state())


def test_shipped_config_runs_on_the_cpu(runs, tmp_path):
    """`python -m scflow_tpu_torch.cli test` on the shipped
    configs/refine_models/scflow.py (256^2, 8 iterations, 21 classes),
    `_base_`d with only the data paths pointed at the synthetic set, on one
    image on the CPU: it writes the metric JSON and the BOP export."""
    root, _, _, _ = runs
    data = root / "data"
    cfg_path = tmp_path / "shipped.py"
    cfg_path.write_text(f'''_base_ = {str(REPO / "configs" / "refine_models" / "scflow.py")!r}
_data = {str(data)!r}
_dataset = load_cfg_vars({str(REPO / "configs" / "refine_datasets" / "ycbv_real.py")!r})
data = dict(test=dict(
    data_root=_data + "/train_real", ref_annots_root=_data + "/initial_poses",
    image_list=_data + "/image_lists/train.txt", keypoints_json=_data + "/keypoints.json",
    meshes_eval=_data + "/models_eval",
    pipeline=[dict(t, mesh_dir=_data + "/models_eval") if t["type"] == "ComputeBbox" else t
              for t in _dataset["test_pipeline"]]))
model = dict(renderer=dict(mesh_dir=_data + "/models_1024"))
work_dir = {str(tmp_path / "work")!r}
del _dataset
''')
    cfg = Config.fromfile(str(cfg_path))
    assert cfg.model.decoder.iters == 8 and tuple(cfg.model.renderer.image_size) == (256, 256)
    with torch.random.fork_rng(devices=[]):
        save_params(str(tmp_path / "shipped.pth"), build_refiner_from_config(cfg.model))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-m", "scflow_tpu_torch.cli", "test", str(cfg_path),
                        "--checkpoint", str(tmp_path / "shipped.pth"), "--device", "cpu",
                        "--limit", "1", "--eval", "--format-only", "--save-dir",
                        str(tmp_path / "bop")],
                       cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    metrics = json.loads(next((tmp_path / "work").glob("eval_*.json")).read_text())
    assert "average/add_10" in metrics and "master_chef_can/auc" in metrics
    bop = _load(tmp_path / "bop" / "000001" / "scene_gt.json")
    assert list(bop) == ["0"] and len(bop["0"]) == 2
