"""The port's mesh banks, shading and renderer against the JAX package's.

The plain v3 raster kernel (what a CPU tensor runs) is held against the TPU
kernel itself, `rasterize_shaded_pallas_v3` in interpret mode, on the same
packed rows, with torch_port_helpers.check_maps's tolerances (XLA's CPU
code contracts a*b + c into an FMA, which the port does not, so depth
differs by several float32 ulps: up to 4.9e-4 at depth ~350 on this scene).

Whole renders on the fused path are held to depth rtol 2e-6 and images
atol 1e-5 with equal masks.  On the brute-force path the same contraction
moves barycentrics by a few ulps and can flip a pixel on a face's edge or a
tie between two faces: masks agree on all but 2e-3 of the pixels, and where
both cover a pixel, depth to 1e-3 and images to 1e-3 on all but 2e-3 of the
pixels."""

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
from scflow_tpu_torch.ops import raster_pack as tpk
from scflow_tpu_torch.ops.cuda import rasterize as trz
from scflow_tpu_torch.render import rasterizer as trast
from scflow_tpu_torch.render.meshbank import make_synthetic_bank
from scflow_tpu_torch.render.renderer import render_batch
from scflow_tpu_torch.render.shading import phong_lighting

from torch_port_helpers import check_maps, keep_torch_rng  # noqa: F401

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


@pytest.mark.parametrize("kind,sub", [("sphere", 2), ("uvsphere", 0), ("cube", 0), ("cube", 1)])
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
    got = tpk.pack_shaded_and_bin(*map(_t, (scene["tri_xy"], scene["tri_z"],
                                            scene["face_valid"], scene["corner"])),
                                  IMG, IMG, 8, 128, 128, cull_backfaces=cull)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cull", [False, True])
def test_plain_raster_matches_pallas_v3(scene, cull):
    rows, active, _ = jrz.pack_shaded_and_bin(
        *map(jnp.asarray, (scene["tri_xy"], scene["tri_z"], scene["face_valid"], scene["corner"])),
        IMG, IMG, 8, 128, 128, cull_backfaces=cull)
    id_bits = tpk.id_bits_for(rows.shape[-1])
    want = jrz.rasterize_shaded_pallas_v3(rows, active, IMG, IMG, th=8, tw=128, fc=128,
                                          id_bits=id_bits, interpret=True)
    got = trz.rasterize_shaded_v3(_t(rows), _t(active), IMG, IMG, id_bits)
    assert got.shape == (2, 16, IMG, IMG)
    check_maps(got.numpy(), np.asarray(want))


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
                       IMG, IMG, backend="pallas", cull_backfaces=True)
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(want["masks"]))
    np.testing.assert_allclose(got["depths"].numpy(), np.asarray(want["depths"]), rtol=2e-6, atol=0)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]), atol=1e-5)


def _bank_args(bank, conv):
    return tuple(conv(getattr(bank, f)) for f in BANK_FIELDS)


def _render_both(scene, monkeypatch, h, w, K=None, **kw):
    """JAX render_batch (its Pallas kernels in interpret mode) and the
    port's on the same bank and poses."""
    for name in ("rasterize_shaded_pallas_v3", "rasterize_shaded_pallas_v4",
                 "rasterize_packed_pallas"):
        monkeypatch.setattr(jrz, name, functools.partial(getattr(jrz, name), interpret=True))
    args = (scene["R"], scene["t"], scene["K"] if K is None else K, scene["labels"])
    want = jrend.render_batch(*_bank_args(scene["bank"], jnp.asarray), *map(jnp.asarray, args),
                              h, w, **kw)
    got = render_batch(*_bank_args(scene["bank"], _t), *map(_t, args), h, w, **kw)
    return got, {k: np.asarray(v) for k, v in want.items()}


def _assert_render_close(got, want, fused: bool):
    g = {k: v.numpy() for k, v in got.items()}
    assert g["images"].shape == want["images"].shape and want["masks"].mean() > 0.02
    if fused:
        np.testing.assert_array_equal(g["masks"], want["masks"])
        np.testing.assert_allclose(g["depths"], want["depths"], rtol=2e-6, atol=0)
        np.testing.assert_allclose(g["images"], want["images"], atol=1e-5)
        return
    both = (g["masks"] > 0) & (want["masks"] > 0)
    assert (g["masks"] != want["masks"]).mean() < 2e-3
    np.testing.assert_allclose(g["depths"][both], want["depths"][both], atol=1e-3)
    assert (np.abs(g["images"] - want["images"]).max(-1) > 1e-3).mean() < 2e-3


# (render_batch keyword arguments, does JAX take its fused kernel path)
BRANCHES = {
    "xla-phong": (dict(backend="xla"), False),
    "xla-flat": (dict(backend="xla", shading="flat"), False),
    "xla-gouraud": (dict(backend="xla", shading="gouraud"), False),
    "xla-flat_shading-cull": (dict(backend="xla", flat_shading=True, cull_backfaces=True), False),
    "pallas-gouraud": (dict(backend="pallas", shading="gouraud"), False),
    "pallas-v4": (dict(backend="pallas", raster_version=4, cull_backfaces=True), True),
    "pallas-v4-nocull": (dict(backend="pallas", raster_version=4), True),
    # the three light branches: one light per object at R (0, 0, lz) with
    # the reference's own light colours; one for the batch at znear / 4;
    # pytorch3d's default light at (0, 1, 0)
    "pallas-v3-lights-own-colours": (dict(backend="pallas", default_lights=False), True),
    "pallas-v3-lights-batch": (dict(backend="pallas", seperate_lights=False,
                                    default_lights=False, background_color=(0.1, 0.2, 0.3)),
                               True),
    "xla-lights-pytorch3d-default": (dict(backend="xla", seperate_lights=False), False),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_render_batch_branches_match(scene, monkeypatch, branch):
    kw, fused = BRANCHES[branch]
    got, want = _render_both(scene, monkeypatch, IMG, IMG, **kw)
    _assert_render_close(got, want, fused)


def test_render_batch_rejects_untiled_crop(scene, monkeypatch):
    """The fused kernel path rejects a crop its 8x128 tiles do not divide:
    render_batch sends a 64x64 crop with backend 'pallas' to the
    brute-force path, as the JAX package does, and matches it."""
    K = scene["K"].copy()
    K[:, :2, 2] = 32.0
    got, want = _render_both(scene, monkeypatch, 64, 64, K=K, backend="pallas",
                             cull_backfaces=True)
    assert got["images"].shape == (2, 64, 64, 3)
    _assert_render_close(got, want, fused=False)


def test_render_batch_auto_backend_on_cpu(scene):
    """'auto' means the brute-force path on the CPU; an unknown backend and
    raster version raise."""
    bank, args = _bank_args(scene["bank"], _t), tuple(
        map(_t, (scene["R"], scene["t"], scene["K"], scene["labels"])))
    auto = render_batch(*bank, *args, IMG, IMG, backend="auto")
    xla = render_batch(*bank, *args, IMG, IMG, backend="xla")
    for k in auto:
        assert torch.equal(auto[k], xla[k])
    with pytest.raises(ValueError, match="unknown backend"):
        render_batch(*bank, *args, IMG, IMG, backend="cuda")
    with pytest.raises(ValueError, match="raster_version"):
        render_batch(*bank, *args, IMG, IMG, backend="pallas", raster_version=2)


@pytest.mark.parametrize("mode", ["phong", "flat", "gouraud"])
def test_shade_phong_matches(scene, mode):
    """shade_phong on the same fragments (the JAX package's brute-force
    rasterization, as numpy)."""
    from scflow_tpu.render.rasterizer import Fragments as JFragments
    from scflow_tpu.render.rasterizer import rasterize as j_rasterize
    from scflow_tpu.render.shading import shade_phong as j_shade
    from scflow_tpu_torch.render.shading import shade_phong

    args = (scene["verts_cam"], scene["faces"], scene["face_valid"], scene["K"])
    frag = j_rasterize(*map(jnp.asarray, args), IMG, IMG)
    normals = np.einsum("nij,nvj->nvi", scene["R"], scene["bank"].normals[scene["labels"]])
    colors = scene["bank"].colors[scene["labels"]]
    light = (scene["t"] + np.float32([30.0, -20.0, -300.0])).astype(np.float32)
    inputs = (scene["faces"], scene["verts_cam"].astype(np.float32), normals.astype(np.float32),
              colors, light)
    kw = dict(ambient=0.4, diffuse=0.5, specular=0.3, shininess=32.0,
              background_color=(0.2, 0.3, 0.4), mode=mode)
    want = j_shade(JFragments(*frag), *map(jnp.asarray, inputs), **kw)
    got = shade_phong(trast.Fragments(*(_t(a) for a in frag)), *map(_t, inputs), **kw)
    assert (np.asarray(frag.face_id) >= 0).mean() > 0.02
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_depth_matches(scene, monkeypatch, backend):
    from scflow_tpu.refiners import system as jsystem
    from scflow_tpu_torch.refiners.system import RenderAssets, render_depth

    monkeypatch.setattr(jrz, "rasterize_shaded_pallas_v3",
                        functools.partial(jrz.rasterize_shaded_pallas_v3, interpret=True))
    args = (scene["R"], scene["t"], scene["K"], scene["labels"])
    want = np.asarray(jsystem.render_depth(jsystem.RenderAssets.from_bank(scene["bank"]),
                                           *map(jnp.asarray, args), (IMG, IMG), backend=backend,
                                           cull_backfaces=True))
    got = render_depth(RenderAssets.from_bank(scene["bank"], device="cpu"), *map(_t, args),
                       (IMG, IMG), backend=backend, cull_backfaces=True).numpy()
    assert got.shape == (2, IMG, IMG) and (want > 0).mean() > 0.02
    both = (got > 0) & (want > 0)
    assert ((got > 0) != (want > 0)).mean() < 2e-3
    np.testing.assert_allclose(got[both], want[both], rtol=2e-6 if backend == "pallas" else 0,
                               atol=0 if backend == "pallas" else 1e-3)


_TETRA = """ply
format ascii 1.0
comment a closed, outward-wound tetrahedron with vertex colours
element vertex 4
property float x
property float y
property float z
property uchar red
property uchar green
property uchar blue
element face 4
property list uchar int vertex_indices
end_header
-50 -50 -50 255 0 0
100 -50 -50 0 255 0
-50 100 -50 0 0 255
-50 -50 100 255 255 0
3 0 2 1
3 0 1 3
3 0 3 2
3 1 2 3
"""


def _write_meshes(tmp_path, closed_only: bool):
    d = tmp_path / ("closed" if closed_only else "mixed")
    d.mkdir()
    (d / "obj_000001.ply").write_text(_TETRA)
    if not closed_only:  # the tetrahedron without its last face, as a quad-free open mesh
        lines = _TETRA.replace("element face 4", "element face 3").splitlines()
        (d / "obj_000002.ply").write_text("\n".join(lines[:-1]) + "\n")
    return str(d)


def test_mesh_dir_bank_and_cull_check_match(tmp_path):
    """MeshBank.from_dir, the winding check and resolve_cull_backfaces's
    True / 'force' / raise against the JAX package's, on PLYs written here."""
    from scflow_tpu.render.meshbank import MeshBank as JBank
    from scflow_tpu.render.meshbank import resolve_cull_backfaces as j_resolve
    from scflow_tpu_torch.render.meshbank import MeshBank, resolve_cull_backfaces

    for closed_only in (True, False):
        path = _write_meshes(tmp_path, closed_only)
        got, want = MeshBank.from_dir(path), JBank.from_dir(path)
        for field in BANK_FIELDS + ("diameters",):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert list(got.class_names) == list(want.class_names)
        np.testing.assert_array_equal(got.closed_consistently_wound(),
                                      want.closed_consistently_wound())
        assert resolve_cull_backfaces(got, False) is j_resolve(want, False) is False
    assert got.closed_consistently_wound().tolist() == [True, False]
    with pytest.raises(ValueError, match="not closed"):
        resolve_cull_backfaces(got, True)
    with pytest.warns(UserWarning, match="not closed"):
        assert resolve_cull_backfaces(got, "force") is True
    closed = MeshBank.from_dir(str(tmp_path / "closed"))
    assert resolve_cull_backfaces(closed, True) is True
    # a synthetic bank of each kind is closed and outward-wound
    for kind in ("cube", "sphere", "uvsphere"):
        assert make_synthetic_bank(2, kind=kind).closed_consistently_wound().all()


@pytest.mark.parametrize("source", ["bank", "mesh_dir"])
def test_renderer_matches(scene, tmp_path, source):
    from scflow_tpu.render.renderer import Renderer as JRenderer
    from scflow_tpu_torch.render.renderer import Renderer

    if source == "bank":
        kw_j, kw_t = dict(bank=j_bank(3, kind="sphere", size=60.0, subdivisions=2)), dict(
            bank=scene["bank"])
        labels = scene["labels"]
    else:
        path = _write_meshes(tmp_path, closed_only=True)
        kw_j = kw_t = dict(mesh_dir=path)
        labels = np.zeros(2, np.int64)
    common = dict(image_size=(IMG, IMG), shader_type="Gouraud", cull_backfaces=True)
    want = JRenderer(**kw_j, **common)(scene["R"], scene["t"], scene["K"], labels)
    renderer = Renderer(**kw_t, **common, device="cpu")
    assert renderer.cull_backfaces is True
    got = renderer(scene["R"], scene["t"], scene["K"], labels)
    _assert_render_close(got, {k: np.asarray(v) for k, v in want.items()}, fused=False)
