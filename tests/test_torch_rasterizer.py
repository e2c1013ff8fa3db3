"""The port's face packing, the plain versions of raster kernels K3-K6 and
`rasterize` against the JAX package on the same numpy inputs.

Packing is held bit for bit.  Each plain kernel version is held against the
Pallas kernel itself in interpret mode, on the same packs, with
torch_port_helpers.check_maps's tolerances for the maps (XLA's CPU code
contracts a*b + c into an FMA and the port does not, so depths differ by a
few ulps).  K4's keys carry those depth bits, so they are held through what
they decode to: the same background, the same winner on all but 2e-3 of
the pixels, and depth bits above the id field that differ by at most one
(a few ulps can carry into that field).
`rasterize` is held on its Fragments: the same foreground, the same winner
face on all but 2e-3 of the pixels, depth and barycentrics to 1e-3 where
the winner agrees."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.ops.pallas import rasterize as jrz
from scflow_tpu.render import rasterizer as jrast
from scflow_tpu_torch.ops import raster_pack as tpk
from scflow_tpu_torch.ops.cuda import rasterize as trz
from scflow_tpu_torch.render import rasterizer as trast

from torch_port_helpers import check_maps, keep_torch_rng  # noqa: F401

INT32_MAX = 2**31 - 1


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _scene(img: int, kind: str = "sphere", sub: int = 2, size: float = 60.0):
    """Two posed meshes of a 3-class bank seen by a camera centred on an
    img x img crop, as numpy: verts_cam, faces, face_valid, K, and the
    JAX package's projected corners and corner attributes."""
    from scipy.spatial.transform import Rotation

    from scflow_tpu.render.meshbank import make_synthetic_bank

    n = 2
    bank = make_synthetic_bank(3, kind=kind, size=size, subdivisions=sub)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 3, n)
    c = img / 2.0
    K = np.tile(np.array([[[150.0, 0, c], [0, 150.0, c], [0, 0, 1]]], np.float32), (n, 1, 1))
    R = np.stack([Rotation.random(random_state=i).as_matrix() for i in range(n)]).astype(np.float32)
    t = np.concatenate([rng.uniform(-10, 10, (n, 2)), rng.uniform(300, 400, (n, 1))],
                       1).astype(np.float32)
    verts_cam = (np.einsum("nij,nvj->nvi", R, bank.verts[labels]) + t[:, None]).astype(np.float32)
    normals_cam = np.einsum("nij,nvj->nvi", R, bank.normals[labels])
    faces = jnp.asarray(bank.faces[labels])
    xy, z = jrast.project_to_screen(jnp.asarray(verts_cam), jnp.asarray(K))
    tri_xy, tri_z = jrast._gather_tri(xy, z, faces)
    corner = jrast.gather_corner_attrs(
        jnp.concatenate([jnp.asarray(normals_cam), jnp.asarray(bank.colors[labels])], -1), faces)
    return dict(img=img, K=K, verts_cam=verts_cam, faces=bank.faces[labels],
                face_valid=bank.face_valid[labels], tri_xy=np.asarray(tri_xy),
                tri_z=np.asarray(tri_z), corner=np.asarray(corner))


def _tiles(img: int):
    """rasterize()'s tile shape for an img x img crop."""
    return (8 if img % 8 == 0 else img), (128 if img % 128 == 0 else img)


def _assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("num_faces", [1, 12, 128, 129, 512, 1024, 1025, 4000])
def test_pick_face_chunk_matches(num_faces):
    assert tpk.pick_face_chunk(num_faces) == jrz.pick_face_chunk(num_faces)
    assert tpk.pick_face_chunk(num_faces, max_fc=256) == jrz.pick_face_chunk(num_faces, 256)


@pytest.mark.parametrize("img,fc,extra,cull", [
    (128, 512, False, True),   # rasterize()'s 8x128 tiles, fc for 1024 faces
    (128, 128, True, False),   # with extra columns riding the sort
    (100, 128, False, True),   # an untiled crop: one 100x100 tile
    (64, 256, True, True),     # 8x64 tiles
])
def test_pack_faces_and_bin_matches(img, fc, extra, cull):
    s = _scene(img)
    th, tw = _tiles(img)
    cols = None
    if extra:
        cols = np.random.default_rng(1).normal(size=(2, 5, s["faces"].shape[1])).astype(np.float32)
    want = jrz.pack_faces_and_bin(*map(jnp.asarray, (s["tri_xy"], s["tri_z"], s["face_valid"])),
                                  img, img, th, tw, fc,
                                  extra_cols=None if cols is None else jnp.asarray(cols),
                                  cull_backfaces=cull)
    got = tpk.pack_faces_and_bin(*map(_t, (s["tri_xy"], s["tri_z"], s["face_valid"])),
                                 img, img, th, tw, fc, extra_cols=None if cols is None else _t(cols),
                                 cull_backfaces=cull)
    assert len(got) == len(want) == (4 if extra else 3)
    _assert_same(got, want)


@pytest.mark.parametrize("dup,sort_mode", [(8, "fused"), (1, "fused"), (8, "two_op"),
                                           (1, "two_op")])
def test_pack_shaded_exact_matches(dup, sort_mode):
    """dup 1 sends nearly every face to the overflow segment."""
    s = _scene(128)
    args = (s["tri_xy"], s["tri_z"], s["face_valid"], s["corner"])
    want = jrz.pack_shaded_exact(*map(jnp.asarray, args), 128, 128, 8, 128, 128, dup=dup,
                                 sort_mode=sort_mode, cull_backfaces=True)
    got = tpk.pack_shaded_exact(*map(_t, args), 128, 128, 8, 128, 128, dup=dup,
                                sort_mode=sort_mode, cull_backfaces=True)
    _assert_same(got, want)
    if dup == 1:
        assert int(got[3].sum()) > 0  # the overflow lists are used


@pytest.mark.parametrize("img,fc", [(128, 128), (128, 512), (100, 128), (64, 128)])
def test_packed_plain_matches_pallas(img, fc):
    """K4's plain version against rasterize_packed_pallas (interpret)."""
    s = _scene(img)
    th, tw = _tiles(img)
    rows, active, _ = jrz.pack_faces_and_bin(
        *map(jnp.asarray, (s["tri_xy"], s["tri_z"], s["face_valid"])), img, img, th, tw, fc)
    bits = tpk.id_bits_for(rows.shape[-1])
    want = np.asarray(jrz.rasterize_packed_pallas(rows, active, img, img, th=th, tw=tw, fc=fc,
                                                  id_bits=bits, interpret=True))
    got = trz.rasterize_packed(_t(rows), _t(active), img, img, th=th, tw=tw, fc=fc,
                               id_bits=bits).numpy()
    assert got.shape == want.shape == (2, img, img) and got.dtype == np.int32
    bg = want == INT32_MAX
    assert 0.02 < 1 - bg.mean() < 1
    np.testing.assert_array_equal(got == INT32_MAX, bg)
    mask = (1 << bits) - 1
    assert ((got & mask) != (want & mask)).mean() < 2e-3
    zdiff = np.abs((got[~bg] >> bits).astype(np.int64) - (want[~bg] >> bits))
    assert zdiff.max() <= 1


@pytest.mark.parametrize("version,fc", [(1, 128), (2, 128), (1, 512), (2, 512)])
def test_shaded_plain_matches_pallas_v12(version, fc):
    """K5/K6's plain version against rasterize_shaded_pallas (interpret)."""
    s = _scene(128)
    rows, active, _ = jrz.pack_shaded_and_bin(
        *map(jnp.asarray, (s["tri_xy"], s["tri_z"], s["face_valid"], s["corner"])),
        128, 128, 8, 128, fc, cull_backfaces=True)
    bits = tpk.id_bits_for(rows.shape[-1])
    want = jrz.rasterize_shaded_pallas(rows, active, 128, 128, th=8, tw=128, fc=fc,
                                       id_bits=bits, interpret=True, version=version)
    got = trz.rasterize_shaded(_t(rows), _t(active), 128, 128, th=8, tw=128, fc=fc,
                               id_bits=bits, version=version)
    assert got.shape == (2, 16, 128, 128)
    check_maps(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dup", [8, 1])
def test_v4_plain_matches_pallas(dup):
    """K3's plain version against rasterize_shaded_pallas_v4 (interpret);
    channel 2 is the sorted entry id."""
    s = _scene(128)
    rows, seg_start, seg_count, ov_counts, ov_order, _ = jrz.pack_shaded_exact(
        *map(jnp.asarray, (s["tri_xy"], s["tri_z"], s["face_valid"], s["corner"])),
        128, 128, 8, 128, 128, dup=dup, cull_backfaces=True)
    bits = tpk.id_bits_for(rows.shape[-1])
    want = jrz.rasterize_shaded_pallas_v4(rows, seg_start, seg_count, ov_counts, ov_order,
                                          128, 128, th=8, tw=128, fc=128, id_bits=bits,
                                          interpret=True)
    got = trz.rasterize_shaded_v4(*map(_t, (rows, seg_start, seg_count, ov_counts, ov_order)),
                                  128, 128, th=8, tw=128, fc=128, id_bits=bits)
    check_maps(got.numpy(), np.asarray(want))


def test_v4_activity_covers_range_and_overflow():
    seg_start = torch.tensor([[[0, 2]]], dtype=torch.int32)
    seg_count = torch.tensor([[[2, 0]]], dtype=torch.int32)
    ov_counts = torch.tensor([[[1, 2]]], dtype=torch.int32)
    ov_order = torch.tensor([[[[3, 0], [4, 1]]]], dtype=torch.int32)
    act = trz.v4_activity(seg_start, seg_count, ov_counts, ov_order, 5)
    assert act.tolist() == [[[[True, True, False, True, False],
                               [False, True, False, False, True]]]]


def _fragments_close(got, want, exact_fg: bool = True):
    fid, wfid = got.face_id.numpy(), np.asarray(want.face_id)
    assert (wfid >= 0).mean() > 0.02
    if exact_fg:
        np.testing.assert_array_equal(fid >= 0, wfid >= 0)
    else:
        assert ((fid >= 0) != (wfid >= 0)).mean() < 2e-3
    same = fid == wfid
    assert 1 - same.mean() < 2e-3
    np.testing.assert_allclose(got.zbuf.numpy()[same], np.asarray(want.zbuf)[same], atol=1e-3)
    np.testing.assert_allclose(got.bary.numpy()[same], np.asarray(want.bary)[same], atol=1e-3)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("img", [128, 100])
def test_rasterize_matches_jax(backend, img, monkeypatch):
    """Fragments of both backends, on an 8x128-tiled crop and on one the
    tiles do not divide (one 100x100 tile on the 'pallas' path)."""
    monkeypatch.setattr(jrz, "rasterize_packed_pallas",
                        functools.partial(jrz.rasterize_packed_pallas, interpret=True))
    s = _scene(img)
    args = (s["verts_cam"], s["faces"], s["face_valid"], s["K"])
    want = jrast.rasterize(*map(jnp.asarray, args), img, img, backend=backend,
                           cull_backfaces=True)
    got = trast.rasterize(*map(_t, args), img, img, backend=backend, cull_backfaces=True)
    assert got.face_id.dtype == torch.int32 and got.bary.shape == (2, img, img, 3)
    _fragments_close(got, want)


def test_rasterize_backends_agree():
    """The port's two backends on one scene (tests/test_pallas_raster.py's
    bounds for the JAX package's): the same foreground, the same winner on
    all but 2e-3 of the pixels."""
    s = _scene(128)
    args = [_t(s[k]) for k in ("verts_cam", "faces", "face_valid", "K")]
    xla = trast.rasterize(*args, 128, 128, backend="xla")
    pal = trast.rasterize(*args, 128, 128, backend="pallas")
    np.testing.assert_array_equal(xla.face_id.numpy() >= 0, pal.face_id.numpy() >= 0)
    assert (xla.face_id != pal.face_id).float().mean() < 2e-3
    assert torch.equal(trast.rasterize(*args, 128, 128, backend="auto").face_id, xla.face_id)


def test_depth_pass_chunking_is_exact(monkeypatch):
    """The brute-force pass's face chunks do not change its keys."""
    s = _scene(64)
    args = [_t(s[k]) for k in ("verts_cam", "faces", "face_valid", "K")]
    whole = trast.rasterize(*args, 64, 64)
    monkeypatch.setattr(trast, "XLA_CHUNK_ELEMENTS", 2 * 64 * 64 * 7)  # 7 faces a chunk
    chunked = trast.rasterize(*args, 64, 64)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_bad_versions_and_backends_raise():
    s = _scene(128)
    rows, active, _ = tpk.pack_shaded_and_bin(
        *map(_t, (s["tri_xy"], s["tri_z"], s["face_valid"], s["corner"])), 128, 128, 8, 128, 128)
    for version in (0, 3, 4):
        with pytest.raises(ValueError, match="version must be 1 or 2"):
            trz.rasterize_shaded(rows, active, 128, 128, version=version)
    args = [_t(s[k]) for k in ("verts_cam", "faces", "face_valid", "K")]
    with pytest.raises(ValueError, match="unknown backend"):
        trast.rasterize(*args, 128, 128, backend="tpu")
    with pytest.raises(ValueError, match="sort_mode"):
        tpk.pack_shaded_exact(*map(_t, (s["tri_xy"], s["tri_z"], s["face_valid"], s["corner"])),
                              128, 128, 8, 128, 128, sort_mode="bitonic")
