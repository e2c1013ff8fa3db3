"""The port's user tools (scflow_tpu_torch/tools/, reached as cli
subcommands) against the JAX package's tools/: bf16_parity's per-pose
comparison against tools/bf16_parity.py's own functions on the same --out
files (that module imports safely under JAX_PLATFORMS=cpu), its config
template verbatim, every tool's flags, and `cli serve-bench` and `cli
warmup` on the CPU at a tiny size, printing the JAX tools' lines."""

import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu_torch import cli
from scflow_tpu_torch.datasets.synthetic import build_synthetic_bop
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.tools import bf16_parity, serve_bench, warmup_cache

from torch_port_helpers import keep_torch_rng  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
NUM_CLASS, SYM = 5, {1, 4}  # 0-based labels of the symmetric classes


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_bf16_parity",
                                                  REPO / "tools" / "bf16_parity.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _verts(bank):
    """bf16_parity.main's vertex banks: at most 400 vertices per class."""
    out = []
    for c in range(NUM_CLASS):
        v = bank.verts[c][bank.vert_valid[c]].astype(np.float64)
        if len(v) > 400:
            v = v[np.linspace(0, len(v) - 1, 400).astype(int)]
        out.append(v)
    return out


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    """A 4-image synthetic set and two --out files of its poses: the ground
    truth moved by noise, the second file's poses a little further, so
    some poses cross the thresholds."""
    root = tmp_path_factory.mktemp("parity")
    info = build_synthetic_bop(root / "data", num_images=4, num_class=NUM_CLASS, seed=1)
    scene = json.loads((root / "data" / "train_real" / "000001" / "scene_gt.json").read_text())
    files = {}
    for tag, scale in (("fp32", 1.0), ("bf16", 1.3)):
        rng_tag = np.random.default_rng(5)
        results = []
        for img_id in range(4):
            anns = scene[str(img_id)]
            labels = np.asarray([a["obj_id"] - 1 for a in anns])
            R = np.stack([np.asarray(a["cam_R_m2c"]).reshape(3, 3) for a in anns])
            t = np.stack([np.asarray(a["cam_t_m2c"]) for a in anns])
            dR = Rotation.from_rotvec(rng_tag.normal(size=(len(anns), 3)) * 0.08
                                      * scale).as_matrix()
            results.append(dict(
                pred=dict(rotations=np.einsum("nij,njk->nik", dR, R).tolist(),
                          translations=(t + rng_tag.normal(size=t.shape) * 6 * scale).tolist(),
                          labels=labels.tolist()),
                img_metas=dict(img_path=f"000001/rgb/{img_id:06d}.png")))
        files[tag] = root / f"out_{tag}.json"
        files[tag].write_text(json.dumps(results))
    return dict(root=root, diameters=info["diameters"], **files)


def test_pose_divergence_matches_jax(jax_tool, outs):
    got = bf16_parity.pose_divergence(outs["fp32"], outs["bf16"])
    assert got == jax_tool.pose_divergence(outs["fp32"], outs["bf16"])
    assert got["poses"] == 4 * NUM_CLASS and got["rot_max_deg"] > 0


def test_per_pose_add_and_crossings_match_jax(jax_tool, outs):
    """ADD(-S) per pose (nearest neighbours for the symmetric classes) from
    each package's vertex banks, and the crossings at the tool's
    thresholds, equal; the fixture's noise makes some poses cross."""
    data = outs["root"] / "data"
    thresholds = (0.05, 0.1, 0.2, 0.5)
    errs = {}
    for tag in ("fp32", "bf16"):
        got = bf16_parity.per_pose_add(outs[tag], data, _verts(make_synthetic_bank(
            NUM_CLASS, size=60.0)), SYM)
        want = jax_tool.per_pose_add(outs[tag], data, _verts(j_bank(NUM_CLASS, size=60.0)),
                                     SYM)
        assert got == want
        errs[tag] = got
    cross = bf16_parity.threshold_crossings(errs["fp32"], errs["bf16"], outs["diameters"],
                                            thresholds)
    assert cross == jax_tool.threshold_crossings(errs["fp32"], errs["bf16"],
                                                 outs["diameters"], thresholds)
    assert sum(cross.values()) > 0
    with pytest.raises(ValueError, match="misaligned"):
        bf16_parity.threshold_crossings(errs["fp32"], errs["bf16"][::-1], outs["diameters"],
                                        thresholds)


def test_parity_config_template_is_jaxs(jax_tool):
    assert bf16_parity.CONFIG_TMPL == jax_tool.CONFIG_TMPL


def _flags(text: str) -> set:
    return set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', text))


@pytest.mark.parametrize("name", ["bf16_parity", "serve_bench", "warmup_cache"])
def test_tool_flags_are_jaxs(name):
    """The JAX tool's flags, and --device (the port's commands all take
    it)."""
    port = (REPO / "scflow_tpu_torch" / "tools" / f"{name}.py").read_text()
    jax_flags = _flags((REPO / "tools" / f"{name}.py").read_text())
    assert jax_flags and _flags(port) == jax_flags | {"--device"}


def test_cli_lists_the_tools():
    with pytest.raises(SystemExit) as e:
        cli.main([])
    for name in ("overfit", "bf16-parity", "serve-bench", "warmup"):
        assert name in str(e.value)
    with pytest.raises(SystemExit) as e:
        cli.main(["serve-bench", "--help"])
    assert e.value.code == 0


def test_serve_bench_on_the_cpu(capsys):
    """The tool's two lines (JAX's format) and its synthetic call: 2
    objects from 1 frame at 64^2 and 1 iteration."""
    cli.main(["serve-bench", "--device", "cpu", "--batch", "2", "--img", "64",
              "--frame-hw", "48", "64", "--frames", "1", "--iters", "1", "--nclass", "2",
              "--rounds", "2", "--dtype", "fp32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "1 device(s), backend=cpu, render=xla, dtype=fp32"
    assert re.fullmatch(r"serving: [\d.]+ refinements/s total, [\d.]+ /s/chip \([\d.]+ ms / "
                        r"2-object step, incl\. device-side crop\+render\)", lines[1]), lines[1]
    assert serve_bench.parse_args([]).dtype == "bf16"  # JAX's default


@pytest.fixture
def e2e_config(tmp_path):
    """tests/test_e2e_cli.py's config (64^2, 2 iterations, 2 classes, batch
    2) on the port's synthetic set."""
    from test_e2e_cli import CONFIG_TMPL

    info = build_synthetic_bop(tmp_path / "data", num_images=2)
    path = tmp_path / "cfg.py"
    path.write_text(CONFIG_TMPL.format(root=str(tmp_path / "data"), diameters=info["diameters"],
                                       work_dir=str(tmp_path / "work"),
                                       model_type="SCFlowRefiner",
                                       decoder_type="SCFlowDecoder"))
    return path


def test_warmup_on_the_cpu(e2e_config, capsys):
    """Nothing built on the CPU; each infer bucket (1, 2), the serving fn
    and the train step called once, under the JAX tool's markers, then
    'cache warm'."""
    times = warmup_cache.main([str(e2e_config), "--device", "cpu", "--frame-hw", "48", "64",
                               "--max-objects", "2", "--cfg-options",
                               "model.test_cfg.max_bucket=2"])
    out = capsys.readouterr().out
    assert "no kernel to build" in out and times["build_s"] is None
    assert "backend=cpu, 1 device(s), image_size=(64, 64)" in out
    for marker in ("infer bucket 1 ", "infer bucket 2 ", "serving fn ", "train step (batch 2) "):
        assert marker in out, marker
    assert out.strip().splitlines()[-1] == "cache warm"
    assert sorted(times["infer_s"]) == [1, 2] and times["serve_s"] and times["train_s"]
