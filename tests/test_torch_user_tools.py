"""The port's user tools `cli keypoints`, `cli browse`, `cli visualize` and
`cli mmflow-convert` (scflow_tpu_torch/tools/) and its pose overlays
(visualize.py) against the JAX package's on the CPU, in this process: the
keypoint json of every mode, farthest point sampling, each imshow_* and
make_grid, CopyFields, a browse sample with PoseJitter skipped (ref = gt),
visualize's panels on a small SCFlow config, the shipped configs' models
against JAX's state-dict manifests, --strict against JAX's verify_state_dict
on tests/test_manifest.py's planted cases, and the converter on the
scenario of tests/test_tools_cli.py's mmflow test (without orbax)."""

import importlib.util
import json
import random
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from scflow_tpu import apis as j_apis
from scflow_tpu.ops.fps import farthest_point_sample as j_fps
from scflow_tpu.render.renderer import render_batch as j_render_batch
from scflow_tpu.runtime import manifest as j_manifest
from scflow_tpu.runtime.convert_torch import duplicate_mmflow_encoder as j_duplicate
from scflow_tpu.utils import visualize as j_vis
from scflow_tpu_torch import cli, visualize
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.datasets.loader import collate_batch
from scflow_tpu_torch.datasets.pipelines.imops import imread
from scflow_tpu_torch.ops.fps import farthest_point_sample
from scflow_tpu_torch.refiners.build import build_refiner_from_config
from scflow_tpu_torch.registry import build_dataset
from scflow_tpu_torch.render.renderer import render_batch
from scflow_tpu_torch.runtime.checkpoint import load_params, reference_state_dict, save_params
from scflow_tpu_torch.tools.browse_dataset import skip_transforms
from scflow_tpu_torch.tools.mmflow_ckpt_converter import check_mmflow, mmflow_encoders

from synthetic_bop import build_synthetic_bop
from test_e2e_cli import CONFIG_TMPL
from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import keep_global_rngs  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
IMAGE = 128  # the visualize config's patch size


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A 2-image synthetic set, the e2e template's SCFlow config at 128^2
    (2 iterations) and its RAFT config, and a .pth of seeded weights."""
    root = tmp_path_factory.mktemp("user_tools")
    info = build_synthetic_bop(root / "data", num_images=2)
    for name, model, decoder in (("scflow", "SCFlowRefiner", "SCFlowDecoder"),
                                 ("raft", "RAFTRefinerFlowMask", "RAFTDecoderMask")):
        text = CONFIG_TMPL.format(root=str(root / "data"), diameters=info["diameters"],
                                  work_dir=str(root / "work"), model_type=model,
                                  decoder_type=decoder)
        (root / f"{name}.py").write_text(text.replace("image_scale = 64",
                                                      f"image_scale = {IMAGE}"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = build_refiner_from_config(Config.fromfile(str(root / "scflow.py")).model)
    save_params(str(root / "scflow.pth"), model)
    return root


def _flags(text: str) -> set:
    """The positional arguments and --flags a tool's parser declares."""
    return set(re.findall(r'add_argument\(\s*"([a-z_]+|--[a-z-]+)"', text))


@pytest.mark.parametrize("name,command", [
    ("collect_3d_keypoints", "keypoints"), ("browse_dataset", "browse"),
    ("visualize", "visualize"), ("mmflow_ckpt_converter", "mmflow-convert")])
def test_tool_flags_are_jaxs(name, command, capsys):
    """The JAX tool's arguments, and --device where the command uses a
    device (keypoints is host numpy, as JAX's); the command's --help
    exits 0."""
    port = (REPO / "scflow_tpu_torch" / "tools" / f"{name}.py").read_text()
    jax_flags = _flags((REPO / "tools" / f"{name}.py").read_text())
    device = set() if command == "keypoints" else {"--device"}
    assert len(jax_flags) >= 3 and _flags(port) == jax_flags | device
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0 and ("--device" in capsys.readouterr().out) == bool(device)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("k", [1, 5, 64, 200])
def test_farthest_point_sample_matches_jax(k):
    pts = np.random.default_rng(k).normal(size=(200, 3)).astype(np.float32)
    np.testing.assert_array_equal(farthest_point_sample(pts, k), j_fps(pts, k))
    with pytest.raises(ValueError, match="cannot FPS-sample"):
        farthest_point_sample(pts[: k - 1], k) if k > 1 else farthest_point_sample(pts[:0], 1)


@pytest.mark.parametrize("mode", ["bbox", "obb", "fps"])
def test_keypoints_json_matches_jax(workspace, mode, monkeypatch, capsys):
    meshes = str(workspace / "data" / "models_eval")
    want_path, got_path = workspace / f"jax_kp_{mode}.json", workspace / f"kp_{mode}.json"
    monkeypatch.setattr(sys, "argv", ["collect_3d_keypoints.py", meshes, "--out",
                                      str(want_path), "--mode", mode, "--num", "8"])
    _jax_tool("collect_3d_keypoints").main()
    want_lines = capsys.readouterr().out.replace(str(want_path), "OUT")
    got = cli.COMMANDS["keypoints"]([meshes, "--out", str(got_path), "--mode", mode, "--num",
                                     "8"])
    assert capsys.readouterr().out.replace(str(got_path), "OUT") == want_lines
    assert json.loads(got_path.read_text()) == json.loads(want_path.read_text()) == got


def _pose(rng, z=(400.0, 900.0)):
    R = Rotation.random(random_state=int(rng.integers(1 << 30))).as_matrix().astype(np.float32)
    t = np.array([rng.uniform(-80, 80), rng.uniform(-60, 60), rng.uniform(*z)], np.float32)
    return R, t


@pytest.mark.parametrize("fn", ["imshow_projected_points", "imshow_pose_axis",
                                "imshow_pose_contour", "imshow_2d_keypoints", "make_grid"])
def test_overlays_match_jax(fn):
    rng = np.random.default_rng(len(fn))
    K = np.array([[500.0, 0, 80], [0, 500.0, 60], [0, 0, 1]], np.float32)
    for case in range(12):
        img = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
        # a third of the poses put the object near or behind the camera plane
        R, t = _pose(rng, (-40.0, 60.0) if case % 3 == 0 else (400.0, 900.0))
        if fn == "imshow_projected_points":
            pts = rng.normal(scale=60.0, size=(300, 3)).astype(np.float32)
            args, kw = (img, pts, K, R, t), dict(radius=int(rng.integers(0, 3)))
        elif fn == "imshow_pose_axis":
            args, kw = (img, K, R, t), dict(thickness=int(rng.integers(1, 4)))
        elif fn == "imshow_pose_contour":
            yy, xx = np.mgrid[:120, :160]
            mask = (((yy - rng.uniform(0, 120)) / rng.uniform(5, 60)) ** 2
                    + ((xx - rng.uniform(0, 160)) / rng.uniform(5, 60)) ** 2 < 1)
            mask = (mask & (rng.random((120, 160)) > 0.05)).astype(np.float32)
            args, kw = (img, mask), dict(thickness=int(rng.integers(1, 3)))
        elif fn == "imshow_2d_keypoints":
            kps = rng.uniform(-40, 200, (8 if case % 2 else 5, 2))
            args, kw = (img, kps), dict(radius=int(rng.integers(1, 4)))
        else:
            args, kw = ([img[:40, :50] + i for i in range(int(rng.integers(1, 8)))],), \
                dict(cols=int(rng.integers(1, 5)), pad=int(rng.integers(0, 3)))
        got = getattr(visualize, fn)(*args, **kw)
        want = getattr(j_vis, fn)(*args, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), (fn, case)


def test_copy_fields_matches_jax():
    """CopyFields copies arrays (not views) like JAX's; a length mismatch
    raises."""
    from scflow_tpu.datasets.pipelines.formatting import Compose as JCompose
    from scflow_tpu_torch.datasets.pipelines import Compose

    steps = [dict(type="CopyFields", src=["gt_rotations", "gt_translations"],
                  dst=["ref_rotations", "ref_translations"])]
    outs = []
    for chain in (Compose(steps), JCompose(steps)):
        data = chain({"gt_rotations": np.eye(3, dtype=np.float32)[None],
                      "gt_translations": [1, 2, 3]})
        assert data["ref_rotations"] is not data["gt_rotations"]
        data["gt_rotations"][0, 0, 0] = 5.0  # the copy keeps its values
        outs.append(data)
    assert outs[0]["ref_rotations"].tolist() == outs[1]["ref_rotations"].tolist()
    assert outs[0]["ref_translations"] == outs[1]["ref_translations"] == [1, 2, 3]
    with pytest.raises(ValueError, match="source fields"):
        Compose([dict(type="CopyFields", src=["a"], dst=["b", "c"])])


def _assets(workspace):
    from scflow_tpu_torch.apis import build_render_assets

    assets, _ = build_render_assets(Config.fromfile(str(workspace / "scflow.py")).model,
                                    device="cpu")
    return (assets.verts, assets.faces, assets.face_valid, assets.colors, assets.normals,
            assets.vert_valid)


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("config", ["scflow.py", "raft.py"])
def test_model_is_jaxs_manifest(config):
    """The shipped config's model serialises JAX's manifest (keys and
    shapes), and its encoders under mmflow's names are JAX's mmflow RAFT
    manifest, which --strict holds a file to."""
    model_cfg = Config.fromfile(str(REPO / "configs" / "refine_models" / config)).model
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(model_cfg)
    assert _shapes(reference_state_dict(model)) == j_manifest.manifest_for_config(model_cfg)
    assert _shapes(mmflow_encoders(model)) == j_manifest.mmflow_raft_manifest()


def _planted(case):
    """tests/test_manifest.py's planted cases on an mmflow RAFT state dict
    (JAX's synthetic_state_dict of its mmflow manifest, plus a decoder
    key)."""
    sd = j_manifest.synthetic_state_dict(j_manifest.mmflow_raft_manifest())
    sd["decoder.gru.conv_z.0.conv.weight"] = np.zeros((128, 384, 1, 5), np.float32)
    if case == "missing":
        del sd["cxt_encoder.res_layer2.0.conv1.weight"]
    elif case == "shape":
        sd["encoder.conv1.weight"] = sd["encoder.conv1.weight"][:32]
    elif case == "unexpected":
        sd["foreign.weight"] = np.zeros((3, 3), np.float32)
    elif case == "unexpected_decoder":
        sd["decoder.foreign.weight"] = np.zeros((3, 3), np.float32)
    elif case == "old_torch":
        sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    elif case == "many":  # more than 20 diffs of a kind: JAX names the first 20
        sd = {k: v for i, (k, v) in enumerate(sd.items()) if i % 3}
    return sd


@pytest.mark.parametrize("case", ["clean", "missing", "shape", "unexpected",
                                  "unexpected_decoder", "old_torch", "many"])
def test_strict_names_jaxs_keys(case):
    """--strict (check_mmflow against the shipped raft.py's model) passes
    where JAX's verify_state_dict(mmflow manifest, 'decoder.' allowed)
    passes, and otherwise names every key JAX's message names."""
    sd = _planted(case)
    model_cfg = Config.fromfile(str(REPO / "configs" / "refine_models" / "raft.py")).model
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(model_cfg)

    def outcome(fn):
        try:
            fn()
            return "ok", ""
        except ValueError as e:
            return "raised", str(e)

    got = outcome(lambda: check_mmflow({k: torch.from_numpy(np.asarray(v))
                                        for k, v in sd.items()}, model, "planted.pth"))
    want = outcome(lambda: j_manifest.verify_state_dict(
        sd, j_manifest.mmflow_raft_manifest(), allow_unexpected_prefixes=("decoder.",)))
    assert got[0] == want[0] == ("ok" if case in ("clean", "unexpected_decoder", "old_torch")
                                 else "raised")
    named = re.findall(r"^  (?:missing|shape|unexpected) +([\w.]+)", want[1], re.M)
    assert all(f"'{k}'" in got[1] for k in named), (named, got[1])
    assert len(named) == {"missing": 1, "shape": 1, "unexpected": 1, "many": 20}.get(case, 0)


def test_mmflow_convert(workspace, tmp_path, capsys):
    """An mmflow-layout state dict of a seeded port RAFT model ('encoder.*',
    'cxt_encoder.*', its decoder): --save-torch writes JAX's duplicated
    keys and values, --out loads into the port's RAFT model with every
    tensor equal, --strict passes it and names a removed key."""
    cfg_path = str(workspace / "raft.py")
    model_cfg = Config.fromfile(cfg_path).model
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        source = build_refiner_from_config(model_cfg)
    mmflow = {}
    for k, v in source.state_dict().items():
        if k.startswith("render_encoder."):
            k = "encoder." + k[len("render_encoder."):]
        elif k.startswith("context."):
            k = "cxt_encoder." + k[len("context."):]
        mmflow[k] = v
    src = tmp_path / "mmflow_raft.pth"
    torch.save({"state_dict": mmflow}, str(src))
    out, dup = tmp_path / "params.pth", tmp_path / "dup.pth"
    cli.main(["mmflow-convert", str(src), "--config", cfg_path, "--out", str(out),
              "--save-torch", str(dup), "--strict", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == [
        f"wrote duplicated torch checkpoint {dup}", f"wrote params {out}"]
    got = torch.load(str(dup), map_location="cpu", weights_only=True)["state_dict"]
    want = j_duplicate({k: v.numpy() for k, v in mmflow.items()})
    assert set(got) == set(want)
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    with torch.random.fork_rng(devices=[]):
        loaded = build_refiner_from_config(model_cfg)
    load_params(str(out), loaded)
    for k, v in source.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    del mmflow["cxt_encoder.res_layer2.0.conv1.weight"]
    torch.save({"state_dict": mmflow}, str(src))
    with pytest.raises(ValueError, match=r"missing \['cxt_encoder\.res_layer2\.0\.conv1\.weight'\]"):
        cli.main(["mmflow-convert", str(src), "--config", cfg_path, "--out", str(out),
                  "--strict", "--device", "cpu"])
