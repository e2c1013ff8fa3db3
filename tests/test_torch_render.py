"""The port's renderer against the JAX package's fused-kernel render path.

The plain raster kernel (what a CPU tensor runs) is held against the TPU
kernel itself, `rasterize_shaded_pallas_v3` in interpret mode, on the same
packed rows.  XLA's CPU code contracts a*b + c into an FMA, which the port
does not, so beside the exact mask and winner id the depth plane
z = a px + b py + c, whose terms cancel, differs by several float32 ulps
(up to 4.9e-4 at depth ~350 on this scene).  Depth is therefore checked with
tests/test_pallas_raster.py's bound (|d depth| > 0.05 on < 2e-3 of pixels)
and a relative 2e-6; normals, colours and barycentrics with atol 1e-4."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.ops.pallas import rasterize as jrz
from scflow_tpu.render import renderer as jrend
from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu.render.rasterizer import _gather_tri, gather_corner_attrs, project_to_screen
from scflow_tpu.render.shading import phong_lighting as j_phong
from scflow_tpu_torch.ops.cuda import rasterize as trz
from scflow_tpu_torch.render import rasterizer as trast
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.render.renderer import render_batch
from scflow_tpu_torch.render.shading import phong_lighting

IMG = 128
BANK_FIELDS = ("verts", "faces", "face_valid", "colors", "normals", "vert_valid")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    from scipy.spatial.transform import Rotation

    n = 2
    bank = make_synthetic_bank(3, kind="sphere", size=60.0, subdivisions=2)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, n)
    K = np.tile(np.array([[[150.0, 0, 64], [0, 150.0, 64], [0, 0, 1]]], np.float32), (n, 1, 1))
    R = np.stack([Rotation.random(random_state=i).as_matrix() for i in range(n)]).astype(np.float32)
    t = np.concatenate([rng.uniform(-10, 10, (n, 2)), rng.uniform(300, 400, (n, 1))],
                       1).astype(np.float32)
    verts_cam = np.einsum("nij,nvj->nvi", R, bank.verts[labels]) + t[:, None]
    normals_cam = np.einsum("nij,nvj->nvi", R, bank.normals[labels])
    faces = jnp.asarray(bank.faces[labels])
    xy, z = project_to_screen(jnp.asarray(verts_cam), jnp.asarray(K))
    tri_xy, tri_z = _gather_tri(xy, z, faces)
    corner = gather_corner_attrs(
        jnp.concatenate([jnp.asarray(normals_cam), jnp.asarray(bank.colors[labels])], -1), faces)
    return dict(bank=bank, labels=labels, K=K, R=R, t=t, verts_cam=verts_cam,
                faces=bank.faces[labels], face_valid=bank.face_valid[labels],
                tri_xy=np.asarray(tri_xy), tri_z=np.asarray(tri_z), corner=np.asarray(corner))


@pytest.mark.parametrize("kind,sub", [("sphere", 2), ("uvsphere", 0)])
def test_meshbank_matches(kind, sub):
    got, want = make_synthetic_bank(3, kind=kind, subdivisions=sub), j_bank(3, kind=kind, subdivisions=sub)
    for field in BANK_FIELDS + ("diameters",):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_projection_and_gathers(scene):
    xy_j, z_j = project_to_screen(jnp.asarray(scene["verts_cam"]), jnp.asarray(scene["K"]))
    xy, z = trast.project_to_screen(_t(scene["verts_cam"]), _t(scene["K"]))
    np.testing.assert_allclose(xy.numpy(), np.asarray(xy_j), atol=1e-4)
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_j))
    tri_xy, tri_z = trast.gather_tri(_t(xy_j), _t(z_j), _t(scene["faces"]))
    np.testing.assert_array_equal(tri_xy.numpy(), scene["tri_xy"])
    np.testing.assert_array_equal(tri_z.numpy(), scene["tri_z"])


@pytest.mark.parametrize("cull", [False, True])
def test_pack_shaded_and_bin_matches(scene, cull):
    """Same corners in, same sort out: active and perm exactly equal, and
    the rows too (no FMA-contractible arithmetic differs here; measured
    bit-identical)."""
    want = jrz.pack_shaded_and_bin(*map(jnp.asarray, (scene["tri_xy"], scene["tri_z"],
                                                      scene["face_valid"], scene["corner"])),
                                   IMG, IMG, 8, 128, 128, cull_backfaces=cull)
    got = trz.pack_shaded_and_bin(*map(_t, (scene["tri_xy"], scene["tri_z"],
                                            scene["face_valid"], scene["corner"])),
                                  IMG, IMG, cull_backfaces=cull)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _check_maps(got, want):
    fg = want[:, 1] > 0.5
    assert fg.mean() > 0.02  # the scene is not empty
    np.testing.assert_array_equal(got[:, 1], want[:, 1])  # mask
    np.testing.assert_array_equal(got[:, 2], want[:, 2])  # winner sorted id
    d = np.abs(got[:, 0] - want[:, 0])
    assert (d > 0.05).mean() < 2e-3
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=2e-6, atol=0)
    np.testing.assert_allclose(got[:, 3:12], want[:, 3:12], atol=1e-4)
    np.testing.assert_array_equal(got[:, 12:], 0.0)


@pytest.mark.parametrize("cull", [False, True])
def test_plain_raster_matches_pallas_v3(scene, cull):
    rows, active, _ = jrz.pack_shaded_and_bin(
        *map(jnp.asarray, (scene["tri_xy"], scene["tri_z"], scene["face_valid"], scene["corner"])),
        IMG, IMG, 8, 128, 128, cull_backfaces=cull)
    id_bits = trz.id_bits_for(rows.shape[-1])
    want = jrz.rasterize_shaded_pallas_v3(rows, active, IMG, IMG, th=8, tw=128, fc=128,
                                          id_bits=id_bits, interpret=True)
    got = trz.rasterize_shaded_v3(_t(rows), _t(active), IMG, IMG, id_bits)
    assert got.shape == (2, 16, IMG, IMG)
    _check_maps(got.numpy(), np.asarray(want))


def test_phong_lighting_matches(rng):
    pos = rng.normal(size=(2, 8, 16, 3)).astype(np.float32) * 50 + np.float32([0, 0, 400])
    nrm = rng.normal(size=(2, 8, 16, 3)).astype(np.float32)
    tex = rng.uniform(size=(2, 8, 16, 3)).astype(np.float32)
    light = (100 * rng.normal(size=(2, 3))).astype(np.float32)
    fg = rng.uniform(size=(2, 8, 16)) > 0.3
    want = j_phong(*map(jnp.asarray, (pos, nrm, tex, light, fg)))
    got = phong_lighting(*map(_t, (pos, nrm, tex, light, fg)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_render_batch_matches(scene, monkeypatch):
    """The whole render against JAX render_batch(backend='pallas'), whose
    v3 kernel runs in interpret mode (_render_pallas imports it at call
    time, so patching the module attribute reaches it)."""
    monkeypatch.setattr(jrz, "rasterize_shaded_pallas_v3",
                        functools.partial(jrz.rasterize_shaded_pallas_v3, interpret=True))
    bank = scene["bank"]
    args = (scene["R"], scene["t"], scene["K"], scene["labels"])
    want = jrend.render_batch(*(jnp.asarray(getattr(bank, f)) for f in BANK_FIELDS),
                              *map(jnp.asarray, args), IMG, IMG, backend="pallas",
                              cull_backfaces=True)
    got = render_batch(*(_t(getattr(bank, f)) for f in BANK_FIELDS), *map(_t, args),
                       IMG, IMG, cull_backfaces=True)
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(want["masks"]))
    np.testing.assert_allclose(got["depths"].numpy(), np.asarray(want["depths"]), rtol=2e-6, atol=0)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), atol=1e-5)


def test_render_batch_rejects_untiled_crop(scene):
    bank = scene["bank"]
    with pytest.raises(ValueError, match="not supported"):
        render_batch(*(_t(getattr(bank, f)) for f in BANK_FIELDS),
                     *map(_t, (scene["R"], scene["t"], scene["K"], scene["labels"])), 64, 64)
