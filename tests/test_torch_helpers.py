"""The port's public helpers against the JAX package's: ops/sampling.py,
ops/warp.py, ops/resize.py, ops/corr.py's correlation_pyramid,
corr_lookup_gather and local_correlation, the geometry helpers, the
losses, datasets/utils.py, the registries and utils/timer.py, on seeded
numpy inputs; and the inventory of scflow_tpu's exported names.

Bounds: the samplers and the warp within 1e-6 (nearest bit for bit), the
resize and pool within 1e-6, local_correlation and the losses within 1e-5
relative, corr_lookup_gather within 1e-5 of JAX's and of the port's
lookup, the numpy helpers exactly."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scflow_tpu.geometry as jgeom
import scflow_tpu.losses as jlosses
import scflow_tpu.models as jmodels
import scflow_tpu.ops as jops
import scflow_tpu_torch.geometry as geom
import scflow_tpu_torch.losses as losses
import scflow_tpu_torch.models as models
import scflow_tpu_torch.ops as ops
from scflow_tpu import registry as jregistry
from scflow_tpu.datasets import utils as jdutils
from scflow_tpu.ops import corr as jcorr
from scflow_tpu.ops import resize as jresize
from scflow_tpu_torch import registry
from scflow_tpu_torch.datasets import utils as dutils
from scflow_tpu_torch.ops import corr, resize
from scflow_tpu_torch.utils.timer import StageTimer, profiler_trace

from torch_port_helpers import keep_torch_rng  # noqa: F401

T = torch.from_numpy


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _rel(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _pixels(rng, n, p, h, w):
    """Pixel coordinates in and around an h x w map: random, the half-pixel
    edges (x = -0.5, w - 0.5 and a hair beyond), exact integers and
    half-integers (nearest's ties)."""
    xy = rng.uniform(-2.0, max(h, w) + 1.0, (n, p, 2))
    edges = np.array([[-0.5, -0.5], [w - 0.5, h - 0.5], [w - 0.5, 0.0], [0.0, h - 0.5],
                      [-0.5001, 0.0], [w - 0.4999, 1.0], [1.5, 2.5], [2.5, 0.5], [3.0, 1.0],
                      [w - 1.0, h - 1.0]])
    xy[:, :len(edges)] = edges
    return xy.astype(np.float32)


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_sample_at_pixels(mode, padding):
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    xy = _pixels(rng, 2, 64, 5, 7)
    want = np.asarray(jops.sample_at_pixels(jnp.asarray(feat), jnp.asarray(xy), mode, padding))
    got = ops.sample_at_pixels(T(feat), T(xy), mode, padding).numpy()
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
        if padding == "zeros":  # JAX's edge rule, where F.grid_sample reads 0
            np.testing.assert_array_equal(got[:, 1], feat[:, 4, 6])
    else:
        _close(got, want)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample(mode, align_corners):
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 9, 2)).astype(np.float32)
    # the normalized coordinates of the half-pixel edges
    grid[:, 0, :4] = [[-1.0, -1.0], [1.0, 1.0], [-1.0 - 1 / 8, 0.0], [1.0 + 1 / 8, 0.0]]
    want = np.asarray(jops.grid_sample(jnp.asarray(feat), jnp.asarray(grid), mode,
                                       align_corners=align_corners))
    got = ops.grid_sample(T(feat), T(grid), mode, align_corners=align_corners).numpy()
    assert got.shape == (2, 5, 9, 4)
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(use_mask=False), dict(return_mask=True),
                                dict(mode="nearest", align_corners=True, return_mask=True)])
def test_backward_warp(kw):
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(2, 6, 8, 3)).astype(np.float32)
    flow = (2.5 * rng.normal(size=(2, 6, 8, 2))).astype(np.float32)
    want = jops.backward_warp(jnp.asarray(feat), jnp.asarray(flow), **kw)
    got = ops.backward_warp(T(feat), T(flow), **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if kw.get("mode") == "nearest":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g.numpy(), w)


@pytest.mark.parametrize("align_corners", [True, False])
def test_interp_taps(align_corners):
    for n_in, n_out in ((8, 32), (32, 8), (7, 5), (5, 1)):
        for g, w in zip(resize.interp_taps(n_in, n_out, align_corners),
                        jresize.interp_taps(n_in, n_out, align_corners)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(resize._interp_matrix(n_in, n_out, align_corners),
                                      jresize._interp_matrix(n_in, n_out, align_corners))


def test_resize_and_pool():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 10, 3)).astype(np.float32)
    for h, w in ((12, 20), (3, 7), (6, 10)):
        _close(resize.resize_align_corners(T(x), h, w).numpy(),
               jops.resize_align_corners(jnp.asarray(x), h, w))
    _close(resize.avg_pool2(T(x)).numpy(), jops.avg_pool2(jnp.asarray(x)))
    with pytest.raises(ValueError):
        resize.avg_pool2(T(x[:, :1]))
    with pytest.raises(ValueError):
        resize.avg_pool2(T(x[:, :5]))


def test_correlation_pyramid():
    rng = np.random.default_rng(5)
    f1 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    want = jcorr.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = corr.correlation_pyramid(T(f1), T(f2), 4)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert g._is_view()  # of the flat level
        _close(g.numpy(), w, atol=1e-5)


@pytest.mark.parametrize("radius", [4, 3])
def test_corr_lookup_gather(radius):
    """Against JAX's gather lookup and against the port's lookup ('pallas':
    the kernels' plain versions on a CPU tensor, on the same 4-D levels)."""
    rng = np.random.default_rng(6)
    f1 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    flow = rng.uniform(-20, 20, (2, 16, 16, 2)).astype(np.float32)
    flow[0, :4] = np.round(flow[0, :4])  # integer centres
    jpyr = jcorr.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    pyr = corr.correlation_pyramid(T(f1), T(f2), 4)
    want = np.asarray(jcorr.corr_lookup_gather(jpyr, jnp.asarray(flow), radius))
    got = corr.corr_lookup_gather(pyr, T(flow), radius).numpy()
    assert got.shape == (2, 16, 16, 4 * (2 * radius + 1) ** 2)
    _close(got, want, atol=1e-5)
    _close(got, corr.corr_lookup(pyr, T(flow), radius, backend="pallas").numpy(), atol=1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_local_correlation(normalize):
    rng = np.random.default_rng(7)
    f1 = rng.normal(size=(2, 6, 7, 16)).astype(np.float32)
    f2 = rng.normal(size=(2, 6, 7, 16)).astype(np.float32)
    f1[0, 0, 0] = 0.0  # a zero feature: the 1e-9 floor
    want = jcorr.local_correlation(jnp.asarray(f1), jnp.asarray(f2), 2, normalize)
    got = corr.local_correlation(T(f1), T(f2), 2, normalize)
    assert tuple(got.shape) == (2, 6, 7, 25)
    _rel(got.numpy(), want)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.array(jgeom.rotmat_from_quat(jnp.asarray(q, jnp.float32)))


def test_geometry_helpers():
    rng = np.random.default_rng(8)
    flow = rng.normal(size=(2, 5, 6, 2)).astype(np.float32)
    np.testing.assert_array_equal(geom.flow_to_coords(T(flow)).numpy(),
                                  np.asarray(jgeom.flow_to_coords(jnp.asarray(flow))))
    pts = rng.normal(size=(3, 10, 3)).astype(np.float32)
    K = np.tile(np.array([[500.0, 0, 128], [0, 500.0, 96], [0, 0, 1]], np.float32), (3, 1, 1))
    R = _rotations(rng, 3)
    t = np.tile(np.array([0.1, -0.2, 4.0], np.float32), (3, 1))
    _close(geom.project_points(T(pts), T(K), T(R), T(t)).numpy(),
           jgeom.project_points(jnp.asarray(pts), jnp.asarray(K), jnp.asarray(R),
                                jnp.asarray(t)), atol=1e-4)
    cam = pts + np.array([0, 0, 5.0], np.float32)
    _close(geom.project_points(T(cam), T(K), eps=1e-3).numpy(),
           jgeom.project_points(jnp.asarray(cam), jnp.asarray(K), eps=1e-3), atol=1e-4)
    # quaternions of random rotations, and of the half turns where w = 0
    Rs = np.concatenate([_rotations(rng, 16), np.diag([1.0, -1, -1])[None],
                         np.diag([-1.0, 1, -1])[None], np.eye(3)[None]]).astype(np.float32)
    _close(geom.quat_from_rotmat(T(Rs)).numpy(), jgeom.quat_from_rotmat(jnp.asarray(Rs)))
    angles = rng.uniform(-3, 3, (4, 3)).astype(np.float32)
    for order, degrees in (("xyz", False), ("zyx", False), ("xzy", True)):
        a = angles * (57.0 if degrees else 1.0)
        _close(geom.rotmat_from_euler(T(a), order, degrees).numpy(),
               jgeom.rotmat_from_euler(jnp.asarray(a), order, degrees))


def test_filter_flow_by_face_index():
    rng = np.random.default_rng(9)
    flow = rng.integers(-2, 3, (2, 8, 8, 2)).astype(np.float32)
    flow[:, :, :3] += 0.5  # ties of nearest's rounding
    flow[0, 0, 0] = 400.0  # already invalid
    f1 = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    f2 = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    want = jgeom.flow.filter_flow_by_face_index(jnp.asarray(flow), jnp.asarray(f1),
                                                jnp.asarray(f2))
    got = geom.filter_flow_by_face_index(T(flow), T(f1), T(f2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 400.0).any() and (got.numpy() != 400.0).any()


@pytest.mark.parametrize("align_corners", [False, True])
def test_filter_flow_by_mask_align_corners(align_corners):
    rng = np.random.default_rng(10)
    flow = (3 * rng.normal(size=(2, 8, 8, 2))).astype(np.float32)
    mask = (rng.random((2, 8, 8)) > 0.3).astype(np.float32)
    want = jgeom.filter_flow_by_mask(jnp.asarray(flow), jnp.asarray(mask),
                                     align_corners=align_corners)
    got = geom.filter_flow_by_mask(T(flow), T(mask), align_corners=align_corners)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p,q,eps", [(2, None, None), (1, None, None), (2, 0.4, None),
                                     (2, 0.4, 0.01), (1, 0.5, 0.1)])
def test_endpoint_error(p, q, eps):
    rng = np.random.default_rng(11)
    a = rng.normal(size=(2, 5, 6, 2)).astype(np.float32)
    b = rng.normal(size=(2, 5, 6, 2)).astype(np.float32)
    _rel(losses.endpoint_error(T(a), T(b), p, q, eps).numpy(),
         jlosses.endpoint_error(jnp.asarray(a), jnp.asarray(b), p, q, eps))


def test_sequence_and_l1_loss():
    """sequence_loss over a stacked (T, ...) prediction with raft_loss and
    keyword arguments, and over a list of argument tuples; l1_loss."""
    rng = np.random.default_rng(12)
    preds = rng.normal(size=(4, 2, 5, 6, 2)).astype(np.float32)
    gt = rng.normal(size=(2, 5, 6, 2)).astype(np.float32)
    valid = (rng.random((2, 5, 6)) > 0.5).astype(np.float32)
    runs = [
        (losses.sequence_loss(losses.raft_loss, T(preds), 0.7, gt_flow=T(gt), valid=T(valid)),
         jlosses.sequence_loss(jlosses.raft_loss, jnp.asarray(preds), 0.7,
                               gt_flow=jnp.asarray(gt), valid=jnp.asarray(valid))),
        (losses.sequence_loss(lambda a, b: losses.endpoint_error(a, b).mean(),
                              [(T(p), T(gt)) for p in preds], 0.7),
         jlosses.sequence_loss(lambda a, b: jlosses.endpoint_error(a, b).mean(),
                               [(jnp.asarray(p), jnp.asarray(gt)) for p in preds], 0.7))]
    for (total, per), (jtotal, jper) in runs:
        assert len(per) == len(jper) == 4
        _rel(total.numpy(), jtotal)
        for g, w in zip(per, jper):
            _rel(g.numpy(), w)
    # l1_loss takes valid and ignores it, as JAX's does
    _rel(losses.l1_loss(T(preds[0]), T(gt), T(valid)).numpy(),
         jlosses.l1_loss(jnp.asarray(preds[0]), jnp.asarray(gt), jnp.asarray(valid)))
    assert torch.equal(losses.l1_loss(T(preds[0]), T(gt), T(valid)),
                       losses.l1_loss(T(preds[0]), T(gt)))


def _bank(rng, c=3, v=40):
    pts = rng.normal(scale=50.0, size=(c, v, 3)).astype(np.float32)
    valid = np.ones((c, v), bool)
    valid[1, 30:] = False
    pts[~valid] = 0.0
    return pts, valid, np.array([False, True, True]), np.array([100.0, 150.0, 80.0], np.float32)


@pytest.mark.parametrize("loss_type", [1, 2])
def test_point_matching_losses(loss_type):
    rng = np.random.default_rng(13)
    pts, valid, sym, diam = _bank(rng)
    labels = np.array([0, 1, 2, 1])
    pr, gr = _rotations(rng, 4), _rotations(rng, 4)
    pt = rng.normal(scale=[20, 20, 100], size=(4, 3)).astype(np.float32) + [0, 0, 800]
    gt = pt + rng.normal(scale=5.0, size=(4, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    bank = [T(pts), T(valid), T(sym), T(diam)]
    jbank = [jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(sym), jnp.asarray(diam)]
    for kw in (dict(), dict(scale_factors=scale, scale_xy=True, scale_depth=True,
                            scale_depth_factor=0.1, loss_weight=2.0)):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        tkw = {k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        got = losses.point_matching_loss(T(pr), T(pt.astype(np.float32)), T(gr),
                                         T(gt.astype(np.float32)), T(labels), *bank,
                                         loss_type=loss_type, **tkw)
        want = jlosses.point_matching_loss(jnp.asarray(pr), jnp.asarray(pt, jnp.float32),
                                           jnp.asarray(gr), jnp.asarray(gt, jnp.float32),
                                           jnp.asarray(labels), *jbank, loss_type=loss_type,
                                           **jkw)
        _rel(got.numpy(), want)
    _rel(losses.rot_point_matching_loss(T(pr), T(gr), T(labels), *bank,
                                        loss_type=loss_type, loss_weight=3.0).numpy(),
         jlosses.rot_point_matching_loss(jnp.asarray(pr), jnp.asarray(gr),
                                         jnp.asarray(labels), *jbank, loss_type=loss_type,
                                         loss_weight=3.0))


def test_dataset_utils():
    from scflow_tpu.datasets.mask import BitmapMasks as JBitmapMasks
    from scflow_tpu_torch.datasets.mask import BitmapMasks

    rng = np.random.default_rng(14)
    pts = rng.normal(size=(12, 3))
    K = np.array([[500.0, 0, 128], [0, 500.0, 96], [0, 0, 1]])
    R = np.asarray(_rotations(rng, 3), np.float64)
    t = rng.normal(size=(3, 3)) + [0, 0, 5]
    for args in ((pts, K, R[0], t[0]), (pts, K, R, t), (pts, np.stack([K] * 3), R, t)):
        for g, w in zip(dutils.project_3d_points_np(*args), jdutils.project_3d_points_np(*args)):
            np.testing.assert_array_equal(g, w)
    pred = rng.random((4, 9, 11)) > 0.5
    gt = (rng.random((3, 9, 11)) > 0.4).astype(np.uint8)
    for g_in, j_in in ((gt, gt), (BitmapMasks(gt, 9, 11), JBitmapMasks(gt, 9, 11))):
        got, want = dutils.intersect_and_union(pred, g_in), jdutils.intersect_and_union(pred,
                                                                                        j_in)
        assert [a.shape for a in got] == [(3, 4), (3, 4), (4,), (3,)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---- the registries ----

_SHAPES = {"num_class": 3, "image_size": (64, 64), "cxt_channels": 128, "feat_size": (8, 8),
           "in_channels": 32}


@pytest.mark.parametrize("reg", ["REFINERS", "ENCODERS", "DECODERS", "HEADS", "BACKBONES",
                                 "LOSSES", "HOOKS"])
def test_registries_build_jax_names(reg):
    """Every name the JAX package registers is registered in the port (the
    JAX registries filled by importing its models and refiners) and builds
    with the registry's shape arguments; without one a TypeError names
    it."""
    import scflow_tpu.models  # noqa: F401
    import scflow_tpu.refiners  # noqa: F401

    names = sorted(getattr(jregistry, reg)._modules)
    port = getattr(registry, reg)
    assert port.names() == tuple(names)
    build = {"REFINERS": registry.build_refiner, "ENCODERS": registry.build_encoder,
             "DECODERS": registry.build_decoder, "HEADS": registry.build_head,
             "LOSSES": registry.build_loss}.get(reg, port.build)
    for name in names:
        needs = port._requires[name]
        small = {"depth": 18} if name.startswith("ResNet") else {}
        with torch.random.fork_rng(devices=[]):
            module = build(dict(type=name, **small), **{k: _SHAPES[k] for k in needs})
        assert isinstance(module, port.get(name)), name
        for k in needs:
            with pytest.raises(TypeError, match=k):
                build(dict(type=name), **{o: _SHAPES[o] for o in needs if o != k})


def test_build_decoder_takes_jax_keys():
    """A JAX config dict's keys build the same module as the constructor."""
    cfg = dict(type="SCFlowDecoder", iters=3, radius=3, detach_flow=False,
               pose_head_cfg=dict(type="SingleClassPoseHead"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        built = registry.build_decoder(cfg, num_class=1, image_size=(64, 64), cxt_channels=128)
        torch.manual_seed(0)
        direct = models.SCFlowDecoder(1, (64, 64), iters=3, radius=3, detach_flow=False,
                                      pose_head_cfg=dict(type="SingleClassPoseHead"),
                                      cxt_channels=128)
    assert built.iters == 3 and built.radius == 3
    for (k, a), (k2, b) in zip(built.state_dict().items(), direct.state_dict().items()):
        assert k == k2 and torch.equal(a, b)


# ---- the timer ----

def test_stage_timer_and_profiler_trace(tmp_path):
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("a"):
            torch.ones(8).sum()
    with timer.stage("b"):
        pass
    assert timer.counts == {"a": 3, "b": 1} and timer.mean_ms("a") >= 0.0
    assert timer.summary().splitlines()[0].startswith("a: total ")
    assert timer.mean_ms("missing") == 0.0
    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    with profiler_trace(None):  # no log_dir: nothing written, nothing raised
        pass


# ---- the inventory ----

@pytest.mark.parametrize("pkg", ["ops", "geometry", "losses", "models"])
def test_exported_names_are_ported(pkg):
    """Every name scflow_tpu.<pkg> exports is found in the port's
    counterpart."""
    jpkg, port = {"ops": (jops, ops), "geometry": (jgeom, geom), "losses": (jlosses, losses),
                  "models": (jmodels, models)}[pkg]
    missing = [n for n in jpkg.__all__ if not hasattr(port, n)]
    assert not missing


def _jax_params(obj):
    """(name, default) of a JAX function's parameters or a flax module's
    fields (parent and name excluded)."""
    if inspect.isclass(obj):
        fields = [f for f in obj.__dataclass_fields__.values()
                  if f.init and f.name not in ("parent", "name")]
        return [(f.name, inspect.Parameter.empty if f.default is dataclasses.MISSING
                 else f.default) for f in fields]
    return [(p.name, p.default) for p in inspect.signature(obj).parameters.values()]


# ROADMAP section 1 item 2: each helper's JAX home and the port's
_ITEM_2 = [
    ("scflow_tpu.models.resnet", "scflow_tpu_torch.models.resnet", "ResNet"),
    ("scflow_tpu.models.resnet", "scflow_tpu_torch.models.resnet", "ResNetV1d"),
    ("scflow_tpu.models.densenet", "scflow_tpu_torch.models.densenet", "DenseLayer"),
    ("scflow_tpu.models.densenet", "scflow_tpu_torch.models.densenet", "BasicDenseBlock"),
    ("scflow_tpu.ops.corr", "scflow_tpu_torch.ops.corr", "correlation_pyramid"),
    ("scflow_tpu.ops.corr", "scflow_tpu_torch.ops.corr", "corr_lookup_gather"),
    ("scflow_tpu.ops.corr", "scflow_tpu_torch.ops.corr", "local_correlation"),
    ("scflow_tpu.ops.warp", "scflow_tpu_torch.ops.warp", "backward_warp"),
    ("scflow_tpu.ops.sampling", "scflow_tpu_torch.ops.sampling", "sample_at_pixels"),
    ("scflow_tpu.ops.sampling", "scflow_tpu_torch.ops.sampling", "grid_sample"),
    ("scflow_tpu.ops.resize", "scflow_tpu_torch.ops.resize", "resize_align_corners"),
    ("scflow_tpu.ops.resize", "scflow_tpu_torch.ops.resize", "avg_pool2"),
    ("scflow_tpu.ops.resize", "scflow_tpu_torch.ops.resize", "interp_taps"),
    ("scflow_tpu.geometry.flow", "scflow_tpu_torch.geometry", "flow_to_coords"),
    ("scflow_tpu.geometry.flow", "scflow_tpu_torch.geometry", "filter_flow_by_face_index"),
    ("scflow_tpu.geometry.flow", "scflow_tpu_torch.geometry", "filter_flow_by_mask"),
    ("scflow_tpu.geometry.camera", "scflow_tpu_torch.geometry", "project_points"),
    ("scflow_tpu.geometry.rotation", "scflow_tpu_torch.geometry", "quat_from_rotmat"),
    ("scflow_tpu.geometry.rotation", "scflow_tpu_torch.geometry", "rotmat_from_euler"),
    ("scflow_tpu.losses.basic", "scflow_tpu_torch.losses.basic", "endpoint_error"),
    ("scflow_tpu.losses.basic", "scflow_tpu_torch.losses.basic", "sequence_loss"),
    ("scflow_tpu.losses.basic", "scflow_tpu_torch.losses.basic", "l1_loss"),
    ("scflow_tpu.losses.point_matching", "scflow_tpu_torch.losses.point_matching",
     "point_matching_loss"),
    ("scflow_tpu.losses.point_matching", "scflow_tpu_torch.losses.point_matching",
     "rot_point_matching_loss"),
    ("scflow_tpu.datasets.utils", "scflow_tpu_torch.datasets.utils", "project_3d_points_np"),
    ("scflow_tpu.datasets.utils", "scflow_tpu_torch.datasets.utils", "intersect_and_union"),
    ("scflow_tpu.utils.timer", "scflow_tpu_torch.utils.timer", "profiler_trace"),
    ("scflow_tpu.registry", "scflow_tpu_torch.registry", "build_refiner"),
    ("scflow_tpu.registry", "scflow_tpu_torch.registry", "build_encoder"),
    ("scflow_tpu.registry", "scflow_tpu_torch.registry", "build_decoder"),
    ("scflow_tpu.registry", "scflow_tpu_torch.registry", "build_head"),
    ("scflow_tpu.registry", "scflow_tpu_torch.registry", "build_loss"),
]


@pytest.mark.parametrize("jax_mod,port_mod,name", _ITEM_2,
                         ids=[f"{m.rsplit('.', 1)[-1]}.{n}" for m, _, n in _ITEM_2])
def test_item_2_signatures(jax_mod, port_mod, name):
    """Each helper exists in the port with the JAX function's parameters
    (or the flax module's fields) and defaults, in JAX's order; the port
    may add its own after them (a backend, a module's shape arguments as
    keywords).  Sequence defaults compare as tuples; a dtype default is
    None on both sides."""
    import importlib

    want = _jax_params(getattr(importlib.import_module(jax_mod), name))
    obj = getattr(importlib.import_module(port_mod), name)
    got = [(p.name, p.default) for p in inspect.signature(obj).parameters.values()
           if p.kind in (p.POSITIONAL_OR_KEYWORD, p.VAR_KEYWORD)
           or p.default is not p.empty]
    norm = lambda d: tuple(d) if isinstance(d, (list, tuple)) else d  # noqa: E731
    got = [(n, norm(d)) for n, d in got[:len(want)]]
    assert got == [(n, norm(d)) for n, d in want]
