"""The port's whole inference slice against the JAX package, plus the port's
purity (no JAX anywhere in it) and its refusal to run on a host without a
card unless asked for the CPU.

Pose tolerances are those of tests/test_convert_torch.py's whole-network
parity: rotations atol 2e-3; translations rtol 2e-3, atol 2e-2."""

import ast
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.ops.pallas import rasterize as jrz
from scflow_tpu.refiners import system as jsystem
from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu.render.renderer import render_batch as j_render
from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
from scflow_tpu_torch.refiners.system import RenderAssets, make_scflow_infer_fn
from scflow_tpu_torch.render.meshbank import make_synthetic_bank

from torch_port_helpers import keep_torch_rng, no_tf32, scflow_pair  # noqa: F401

N, IMG, NCLASS, ITERS = 2, 128, 3, 3
SIZE = 160.0  # mm: the spheres cover a good part of the 128^2 crop
REPO = Path(__file__).resolve().parents[1]
BANK_FIELDS = ("verts", "faces", "face_valid", "colors", "normals", "vert_valid")


@pytest.fixture(scope="module")
def models():
    return scflow_pair(NCLASS, IMG, ITERS)


@pytest.fixture(scope="module")
def batch():
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(5)
    R = np.stack([Rotation.random(random_state=10 + i).as_matrix()
                  for i in range(N)]).astype(np.float32)
    return dict(
        real_images=(0.2 * rng.normal(size=(N, IMG, IMG, 3))).astype(np.float32),
        ref_rotations=R,
        ref_translations=np.array([[5.0, -4.0, 400.0], [-6.0, 3.0, 420.0]], np.float32),
        k=np.tile(np.array([[[150.0, 0, 64], [0, 150.0, 64], [0, 0, 1]]], np.float32), (N, 1, 1)),
        labels=np.array([0, 2], np.int32),
    )


def _assert_poses(R, t, R_want, t_want):
    np.testing.assert_allclose(R, R_want, atol=2e-3)
    np.testing.assert_allclose(t, t_want, rtol=2e-3, atol=2e-2)


def test_refiner_matches_flax(models, batch, no_tf32):
    """SCFlowRefiner on the same rendered inputs, every iteration's pose."""
    fmodel, variables, port = models
    bank = j_bank(NCLASS, kind="sphere", size=SIZE, subdivisions=2)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    out = j_render(*(jnp.asarray(getattr(bank, f)) for f in BANK_FIELDS), b["ref_rotations"],
                   b["ref_translations"], b["k"], b["labels"], IMG, IMG, backend="xla")
    render, depth = np.asarray(out["images"]), np.asarray(out["depths"])
    assert (depth > 0).mean() > 0.1
    want = fmodel.apply(variables, jnp.asarray(render), b["real_images"], b["ref_rotations"],
                        b["ref_translations"], jnp.asarray(depth), b["k"], b["labels"],
                        pose_only=True, lookup_backend="xla")
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.array(a)) for a in (
            render, batch["real_images"], batch["ref_rotations"], batch["ref_translations"],
            depth, batch["k"], batch["labels"])))
    assert got["rotations"].shape == (ITERS, N, 3, 3)
    # the poses moved, so the pose chain and its feedback were exercised
    assert np.abs(got["translations"][-1].numpy() - batch["ref_translations"]).max() > 1.0
    _assert_poses(got["rotations"].numpy(), got["translations"].numpy(),
                  np.asarray(want["rotations"]), np.asarray(want["translations"]))
    np.testing.assert_allclose(got["delta_rotations"].numpy(),
                               np.asarray(want["delta_rotations"]), atol=2e-3)


def test_infer_fn_matches_jax(models, batch, monkeypatch, no_tf32):
    """make_scflow_infer_fn(slim) end to end: render, encoders, decoder."""
    fmodel, variables, port = models
    monkeypatch.setattr(jrz, "rasterize_shaded_pallas_v3",
                        functools.partial(jrz.rasterize_shaded_pallas_v3, interpret=True))
    j_infer = jsystem.make_scflow_infer_fn(
        fmodel, jsystem.RenderAssets.from_bank(j_bank(NCLASS, kind="sphere", size=SIZE, subdivisions=2)),
        image_size=(IMG, IMG), render_backend="pallas", lookup_backend="xla",
        render_cull_backfaces=True, slim=True)
    want = j_infer(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    assets = RenderAssets.from_bank(make_synthetic_bank(NCLASS, kind="sphere", size=SIZE, subdivisions=2),
                                    device="cpu")
    infer = make_scflow_infer_fn(port, assets, image_size=(IMG, IMG), render_backend="pallas",
                                 render_cull_backfaces=True, slim=True, device="cpu")
    got = infer(batch)
    assert got["rotations"].shape == (N, 3, 3) and got["translations"].shape == (N, 3)
    _assert_poses(got["rotations"].numpy(), got["translations"].numpy(),
                  np.asarray(want["rotations"]), np.asarray(want["translations"]))


def test_infer_fn_brute_force_render_matches_jax(models, batch, no_tf32):
    """The default render_backend 'auto' on the CPU renders by the
    brute-force path, held against the JAX package's 'xla' render."""
    fmodel, variables, port = models
    j_infer = jsystem.make_scflow_infer_fn(
        fmodel, jsystem.RenderAssets.from_bank(j_bank(NCLASS, kind="sphere", size=SIZE, subdivisions=2)),
        image_size=(IMG, IMG), render_backend="xla", lookup_backend="xla", slim=True)
    want = j_infer(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    assets = RenderAssets.from_bank(make_synthetic_bank(NCLASS, kind="sphere", size=SIZE, subdivisions=2),
                                    device="cpu")
    got = make_scflow_infer_fn(port, assets, image_size=(IMG, IMG), slim=True, device="cpu")(batch)
    _assert_poses(got["rotations"].numpy(), got["translations"].numpy(),
                  np.asarray(want["rotations"]), np.asarray(want["translations"]))


def test_entry_points_refuse_cpu_without_asking(monkeypatch):
    """device=None means CUDA: with no card, the entry points raise rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bank = make_synthetic_bank(1, kind="sphere", subdivisions=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderAssets.from_bank(bank)
    assets = RenderAssets.from_bank(bank, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_scflow_infer_fn(SCFlowRefiner(num_class=1, image_size=(128, 128)), assets)


def test_infer_fn_rejects_unknown_render_backend():
    assets = RenderAssets.from_bank(make_synthetic_bank(1, kind="sphere"), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        make_scflow_infer_fn(SCFlowRefiner(num_class=1, image_size=(128, 128)), assets,
                             render_backend="triton", device="cpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "scflow_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py"])
def test_port_imports_no_jax(path):
    banned = ("jax", "jaxlib", "flax", "scflow_tpu")
    for mod in _imported_modules(REPO / path):
        assert mod.split(".")[0] not in banned, f"{path} imports {mod}"
