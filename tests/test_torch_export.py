"""Export (scflow_tpu_torch/runtime/export.py, `cli export`) on the CPU:
the loaded program equals the live infer fn (rtol and atol 1e-5, JAX's
roundtrip bound in tests/test_export.py) for a tiny SCFlow as
tests/test_export.py builds it (64^2, 2 iterations, batch 3), a cycled one,
a bf16 one and RAFT with the device PnP (whose draws, made once, equal the
per-call generator's bit for bit); at 128^2 on the kernels' route (K2 and
K1 as `scflow::` ops, their plain versions on the CPU) the port's loaded
artifact against JAX's loaded artifact of the same flax weights, whose
raster kernel runs in interpret mode so that both render K2's formula
(tests/test_torch_slice.py's bounds: rotations atol 2e-3, translations
rtol 2e-3, atol 2e-2); the container's rules (read_meta's errors, the
reserved keys, the platforms, a JAX artifact refused) on a toy infer fn;
a loader in a fresh process that imports no model code; and `cli export
--platforms cpu` on tests/synthetic_bop.py's meshes."""

import io
import json
import logging
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from scflow_tpu_torch.refiners.system import (RenderAssets, make_raft_infer_fn,
                                              make_scflow_cycled_infer_fn, make_scflow_infer_fn)
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.runtime.export import (FORMAT, batch_spec, export_infer, load_exported,
                                             read_meta)

from torch_port_helpers import keep_torch_rng  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
EXACT = dict(rtol=1e-5, atol=1e-5)
N, NCLASS = 3, 2


def _batch(img: int, n: int = N, seed: int = 3):
    """tests/test_export.py's batch: random rotations, t ~ (5 N, 5 N, U(400,
    500)), focal 120 at the crop's centre, random labels (int32)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    R = Rotation.random(n, rng).as_matrix().astype(np.float32)
    t = np.stack([rng.normal(size=n) * 5, rng.normal(size=n) * 5, rng.uniform(400, 500, n)],
                 -1).astype(np.float32)
    K = np.tile(np.array([[[120.0, 0, img / 2], [0, 120.0, img / 2], [0, 0, 1]]], np.float32),
                (n, 1, 1))
    return {"real_images": rng.uniform(0, 255, (n, img, img, 3)).astype(np.float32),
            "ref_rotations": R, "ref_translations": t, "k": K,
            "labels": rng.integers(0, NCLASS, n).astype(np.int32)}


def _bank():
    return make_synthetic_bank(NCLASS, kind="cube", size=80.0, subdivisions=1)


def _scflow(img: int, iters: int = 2, dtype=None):
    """A port SCFlowRefiner with PyTorch's initialisation from seed 0 (on a
    forked RNG) and pose-head output weights normal(0, 0.02), so that the
    poses move."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = SCFlowRefiner(num_class=NCLASS, image_size=(img, img), iters=iters, dtype=dtype)
        with torch.no_grad():
            for lin in (model.decoder.pose_pred.rotation_pred,
                        model.decoder.pose_pred.translation_pred):
                lin.weight.normal_(0.0, 0.02)
    return model


def _steady(fn, batch):
    """fn's second call on the batch: at several threads the first CPU call
    of new shapes in a process can differ from the later ones in the last
    bits (one flow value in 1e-4 seen), in the live call as in the loaded
    one, so both sides are compared after a first call."""
    fn(batch)
    return fn(batch)


def _close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), err_msg=k, **tol)


def _export(make, img, n=N, **kw):
    return export_infer(make, batch_spec(n, (img, img)), platforms=["cpu"], **kw)


@pytest.fixture(scope="module")
def tiny():
    """The 64^2 SCFlow of tests/test_export.py (JAX's default backends: the
    tensor routes on the CPU), its artifact and batch."""
    model = _scflow(64)
    assets = RenderAssets.from_bank(_bank(), device="cpu")

    def make(device):
        return make_scflow_infer_fn(model, assets, image_size=(64, 64), device="cpu")

    data = _export(make, 64, meta={"config": "tiny-test", "iters": 2})
    return make, data, _batch(64)


def test_roundtrip_matches_live(tiny):
    make, data, batch = tiny
    call, meta = load_exported(data, device="cpu")
    assert meta["config"] == "tiny-test" and meta["format"] == FORMAT
    assert meta["platforms"] == ["cpu"] and meta["torch"] == torch.__version__
    assert meta["inputs"]["real_images"] == {"shape": [N, 64, 64, 3], "dtype": "float32"}
    assert meta["inputs"]["labels"]["dtype"] == "int32"
    assert meta["outputs"] == ["flow", "masks", "rotations", "translations"]
    _close(_steady(call, batch), _steady(make("cpu"), batch), **EXACT)
    # tensors in, and the live call's dict out
    got = call({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["rotations"].dtype == torch.float32 and got["flow"].shape == (N, 64, 64, 2)


def test_cycled_bf16_export(tiny):
    """A cycled infer fn (cycles=2, so two renders and two passes) of a bf16
    model (1 iteration), exported and called: equal to its live call."""
    _, _, batch = tiny
    assets = RenderAssets.from_bank(_bank(), device="cpu")
    bf16 = _scflow(64, iters=1, dtype=torch.bfloat16)

    def make(device):
        return make_scflow_cycled_infer_fn(bf16, assets, cycles=2, image_size=(64, 64),
                                           slim=True, device="cpu")

    call, meta = load_exported(_export(make, 64), device="cpu")
    assert meta["outputs"] == ["rotations", "translations"]
    _close(_steady(call, batch), _steady(make(None), batch), **EXACT)


@pytest.fixture(scope="module")
def jax_and_port():
    """One flax SCFlow (lecun weights) and the port's copy at 128^2, each
    exported for the CPU: JAX's through its K2 in interpret mode (render
    backend 'pallas'), the port's on the kernels' route (render and lookup
    'pallas': K2 and K1 as ops, their plain versions here)."""
    import scflow_tpu.ops.pallas.rasterize as jrz
    from scflow_tpu.refiners.system import RenderAssets as JaxAssets
    from scflow_tpu.refiners.system import make_scflow_infer_fn as jax_make
    from scflow_tpu.render.meshbank import make_synthetic_bank as jax_bank
    from scflow_tpu.runtime import export as jexport

    from torch_port_helpers import scflow_options_pair

    img = 128
    fmodel, variables, port = scflow_options_pair(img, 2, num_class=NCLASS)
    v3 = jrz.rasterize_shaded_pallas_v3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrz, "rasterize_shaded_pallas_v3",
                   lambda *a, **kw: v3(*a, **{**kw, "interpret": True}))
        jinfer = jax_make(fmodel, JaxAssets.from_bank(jax_bank(NCLASS, kind="cube", size=80.0,
                                                               subdivisions=1)),
                          image_size=(img, img), render_backend="pallas", slim=True)
        jax_data = jexport.export_infer(jinfer, variables, jexport.batch_spec(N, (img, img)),
                                        platforms=("cpu",))
    assets = RenderAssets.from_bank(_bank(), device="cpu")

    def make(device):
        return make_scflow_infer_fn(port, assets, image_size=(img, img), render_backend="pallas",
                                    lookup_backend="pallas", slim=True, device="cpu")

    return jax_data, _export(make, img), make, _batch(img)


def test_port_artifact_matches_jax_artifact(jax_and_port):
    from scflow_tpu.runtime import export as jexport

    jax_data, data, make, batch = jax_and_port
    jcall, _ = jexport.load_exported(jax_data)
    want = {k: np.asarray(v) for k, v in jcall(batch).items()}
    call, _ = load_exported(data, device="cpu")
    got = _steady(call, batch)
    assert sorted(got) == sorted(want) == ["rotations", "translations"]
    assert np.abs(got["translations"].numpy() - batch["ref_translations"]).max() > 1.0  # moved
    np.testing.assert_allclose(got["rotations"].numpy(), want["rotations"], atol=2e-3)
    np.testing.assert_allclose(got["translations"].numpy(), want["translations"],
                               rtol=2e-3, atol=2e-2)
    _close(got, _steady(make(None), batch), **EXACT)


def test_kernel_route_exports_the_custom_ops(jax_and_port):
    """The 128^2 program names K2 once and K1 once per iteration, as
    scflow:: ops."""
    _, data, _, _ = jax_and_port
    meta = read_meta(data)
    off, length = meta["programs"]["cpu"]
    start = 16 + struct.unpack_from("<Q", data, 8)[0] + off
    ep = torch.export.load(io.BytesIO(data[start: start + length]))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("scflow.raster_v3.default") == 1
    assert targets.count("scflow.corr_lookup.default") == 2
    assert not [t for t in targets if "scflow" in t and "raster_v3" not in t
                and "corr_lookup" not in t]


def test_load_refuses_a_jax_artifact(jax_and_port):
    jax_data = jax_and_port[0]
    assert read_meta(jax_data)["format"] == 1
    with pytest.raises(ValueError, match="JAX"):
        load_exported(jax_data, device="cpu")


def _raft(mask: bool, **cfg):
    """(make(device, **pnp_cfg), batch): a port RAFT refiner (PyTorch's
    initialisation from seed 0, 1 iteration) with the device PnP at 64^2."""
    from scflow_tpu_torch.refiners import raft

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = getattr(raft, "RAFTRefinerFlowMask" if mask else "RAFTRefinerFlow")(iters=1)
    assets = RenderAssets.from_bank(_bank(), device="cpu")
    pnp = dict(num_points=200, num_hypotheses=16, occ_thresh=0.0)

    def make(device, **cfg):
        return make_raft_infer_fn(model, assets, image_size=(64, 64), pnp_backend="device",
                                  pnp_cfg={**pnp, **cfg}, device="cpu")

    return make, _batch(64)


@pytest.mark.parametrize("mask", [True, False])
def test_raft_device_pnp_draws_once(mask):
    """The device PnP's draws, made once (the uniforms once per batch size,
    the flow-only score of the model without occlusion once), give the
    poses of an infer fn that draws from a generator seeded as each call
    seeded one before (0), bit for bit, call after call."""
    make, batch = _raft(mask)
    half = {k: v[:2] for k, v in batch.items()}  # another batch size, its own draw
    live = make(None)
    live(batch), live(half)  # _steady's first calls
    for b in (batch, half):
        want = live(b)
        per_call = make(None, generator=torch.Generator().manual_seed(0))(b)
        for k in ("rotations", "translations", "pnp_ok"):
            assert torch.equal(want[k], per_call[k]), k
    assert torch.equal(live(batch)["rotations"], _steady(live, batch)["rotations"])


def test_raft_device_pnp_export():
    """RAFT with the device PnP: the loaded program equals the live call; an
    infer fn with its own generator cannot be exported."""
    make, batch = _raft(True)
    call, meta = load_exported(_export(make, 64), device="cpu")
    assert {"rotations", "translations", "pnp_ok", "flow", "occlusion"} <= set(meta["outputs"])
    _close(_steady(call, batch), _steady(make(None), batch), **EXACT)
    with pytest.raises(ValueError, match="generator"):
        _export(lambda dev: make(dev, generator=torch.Generator().manual_seed(0)), 64)


def _toy(device=None):
    """A toy infer fn with the entry points' attributes: cheap to trace."""
    dev = torch.device(device or "cpu")
    w = torch.tensor(2.0, device=dev)

    def body(batch):
        return {"rotations": batch["ref_rotations"] * w,
                "translations": batch["ref_translations"] + batch["labels"][:, None]}

    def infer(batch):
        with torch.inference_mode():
            return body(batch)

    infer.trace_body = lambda batch_size: body
    infer.device = dev
    return infer


def _splice(data: bytes, **changes) -> bytes:
    meta = read_meta(data)
    (n,) = struct.unpack_from("<Q", data, 8)
    meta.update(changes)
    payload = json.dumps(meta).encode()
    return b"SCFLOWX1" + struct.pack("<Q", len(payload)) + payload + data[16 + n:]


def test_container_rules():
    """JAX's rules: the reserved keys win over the caller's meta; no
    platforms means the infer fn's device; the spec's dtypes reach the
    program."""
    data = export_infer(_toy, batch_spec(2, (8, 8)), platforms=["cpu"],
                        meta={"platforms": ["bogus"], "format": 999, "inputs": {},
                              "outputs": [], "programs": {}, "torch": "0", "note": "kept"})
    meta = read_meta(data)
    assert meta["platforms"] == ["cpu"] and meta["format"] == FORMAT
    assert meta["note"] == "kept" and meta["outputs"] == ["rotations", "translations"]
    assert meta["torch"] == torch.__version__ and set(meta["programs"]) == {"cpu"}
    for platforms in (None, ()):
        assert read_meta(export_infer(_toy, batch_spec(2, (8, 8)),
                                      platforms=platforms))["platforms"] == ["cpu"]
    call, _ = load_exported(data, device="cpu")
    batch = {k: np.ones(s["shape"], s["dtype"]) for k, s in meta["inputs"].items()}
    got = call(batch)
    assert torch.equal(got["rotations"], torch.full((2, 3, 3), 2.0))
    assert got["translations"].dtype == torch.float32  # labels came in as int32


def test_platform_errors():
    spec = batch_spec(2, (8, 8))
    for bad in (["tpu"], ["cpu", "rocm"]):
        with pytest.raises(ValueError, match="unknown export platform"):
            export_infer(_toy, spec, platforms=bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            export_infer(_toy, spec, platforms=["cuda"])
    data = export_infer(_toy, spec, platforms=["cpu"])
    # a program for a platform this device is not
    cuda_only = _splice(data, platforms=["cuda"],
                        programs={"cuda": read_meta(data)["programs"]["cpu"]})
    with pytest.raises(ValueError, match=r"\['cuda'\].*cpu"):
        load_exported(cuda_only, device="cpu")
    with pytest.raises(ValueError, match="unknown export artifact format"):
        load_exported(_splice(data, format=2), device="cpu")


def test_read_meta_errors():
    """read_meta's four errors, with JAX's messages."""
    with pytest.raises(ValueError, match="bad magic"):
        read_meta(b"NOTANARTIFACT" * 4)
    with pytest.raises(ValueError, match="truncated"):
        read_meta(b"SCFLOWX1")
    with pytest.raises(ValueError, match="truncated"):
        read_meta(b"SCFLOWX1" + b"\x04\x00")
    with pytest.raises(ValueError, match="exceeds file"):
        read_meta(b"SCFLOWX1" + struct.pack("<Q", 1 << 20) + b"{}")
    bad = b"\xff\xfenot-json"
    with pytest.raises(ValueError, match="corrupt"):
        read_meta(b"SCFLOWX1" + struct.pack("<Q", len(bad)) + bad)


LOADER = """
import sys
import numpy as np
from scflow_tpu_torch.runtime.export import load_exported
call, meta = load_exported(sys.argv[1], device="cpu")
batch = dict(np.load(sys.argv[2]))
call(batch)
np.savez(sys.argv[3], **{k: v.numpy() for k, v in call(batch).items()})
names = ("models", "refiners", "config", "apis", "registry", "runtime.checkpoint")
print(sorted(m for m in sys.modules
             if any(m == "scflow_tpu_torch." + n or m.startswith("scflow_tpu_torch." + n + ".")
                    for n in names) or m.split(".")[0] in ("scflow_tpu", "jax")))
"""


def test_loader_in_a_fresh_process_imports_no_model_code(tiny, tmp_path):
    make, data, batch = tiny
    (tmp_path / "model.scflowx").write_bytes(data)
    np.savez(tmp_path / "batch.npz", **batch)
    r = subprocess.run([sys.executable, "-c", LOADER, str(tmp_path / "model.scflowx"),
                        str(tmp_path / "batch.npz"), str(tmp_path / "out.npz")],
                       cwd=str(REPO), env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
    _close(dict(np.load(tmp_path / "out.npz")), _steady(make(None), batch), **EXACT)


CFG = """
model = dict(
    type="SCFlowRefiner",
    cxt_channels=128, h_channels=128, seperate_encoder=False, max_flow=400.0,
    encoder=dict(type="RAFTEncoder", in_channels=3, out_channels=256,
                 net_type="Basic", norm_cfg=dict(type="IN")),
    cxt_encoder=dict(type="RAFTEncoder", in_channels=3, out_channels=256,
                     net_type="Basic", norm_cfg=dict(type="BN")),
    decoder=dict(
        type="SCFlowDecoder", net_type="Basic", num_levels=4, radius=4,
        iters=2, detach_flow=True, detach_mask=True, detach_pose=True,
        detach_depth_for_xy=True, mask_flow=False, mask_corr=False,
        pose_head_cfg=dict(type="MultiClassPoseHead", num_class=2,
                           in_channels=224, rotation_mode="ortho6d"),
        gru_type="SeqConv"),
    train_cfg=dict(),
    test_cfg=dict(iters=2),
    renderer=dict(mesh_dir=r"{mesh_dir}", image_size=(64, 64),
                  shader_type="Phong", background_color=(0.5, 0.5, 0.5)),
)
"""


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_export_on_the_cpu(tmp_path):
    """`cli export --platforms cpu` (tests/test_export.py's config on
    synthetic_bop's meshes, init weights): JAX's meta, and the artifact
    equals make_infer_from_cfg's live call on the same seeded weights."""
    from scflow_tpu_torch import cli
    from scflow_tpu_torch.apis import (build_render_assets, init_model_variables,
                                       make_infer_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.logger import get_logger

    from synthetic_bop import build_synthetic_bop

    build_synthetic_bop(tmp_path / "data", num_images=1, render_images=False)
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text(CFG.format(mesh_dir=tmp_path / "data" / "models_1024"))
    out = tmp_path / "model.scflowx"
    records = _Records()
    logger = get_logger()
    logger.addHandler(records)
    try:
        meta = cli.export_main([str(cfg_path), "--out", str(out), "--batch-size", "2",
                                "--platforms", "cpu"])
    finally:
        logger.removeHandler(records)
    assert meta == read_meta(out.read_bytes())
    assert any("INIT weights" in line for line in records.lines)
    assert records.lines[-1].startswith(f"wrote {out} (")
    assert (meta["config"], meta["checkpoint"], meta["model_type"], meta["image_size"],
            meta["batch_size"], meta["platforms"]) == ("tiny.py", "", "SCFlowRefiner",
                                                       [64, 64], 2, ["cpu"])
    cfg = Config.fromfile(str(cfg_path))
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    assets, _ = build_render_assets(cfg.model, device="cpu")
    init_model_variables(cfg.model, model, device="cpu")
    live, _ = make_infer_from_cfg(cfg, model, assets, (64, 64), slim=True, device="cpu")
    batch = {k: v[:2] for k, v in _batch(64).items()}
    call, _ = load_exported(str(out), device="cpu")
    got = _steady(call, batch)
    assert np.isfinite(got["rotations"].numpy()).all()
    _close(got, _steady(live, batch), **EXACT)
