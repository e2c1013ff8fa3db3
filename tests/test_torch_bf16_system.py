"""The port's bf16 refiner (SCFlowRefiner(dtype=torch.bfloat16)) against the
JAX package at dtype=jnp.bfloat16: the decoder's per-tensor dtypes, the
refiner's poses and make_scflow_infer_fn (its full JAX signature, slim=False
outputs, norms, iters, unroll); flax weights carried over by convert.py.
The modules and the lookup are in test_torch_bf16.py, the train step in
test_torch_bf16_train.py.

Bounds on poses, losses and gradients follow from the JAX package's own
distance between its bf16 and fp32 runs on the same inputs, stated per
test."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.ops.corr import correlation_pyramid_flat as j_pyramid
from scflow_tpu.ops.pallas import corr_lookup as jcl
from scflow_tpu.ops.pallas.corr_lookup import corr_lookup_pallas
from scflow_tpu_torch.convert import state_dict_from_flax

from torch_port_helpers import keep_torch_rng, load_port, no_tf32  # noqa: F401

BF, TB = jnp.bfloat16, torch.bfloat16


N, IMG, NCLASS, ITERS = 2, 64, 3, 2


def _scene(img=IMG, seed=5):
    """Rendered-like inputs of tests/test_models.py: a depth plane at 400
    mm, identity-ish rotations, images of N(0, 0.2)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    R = np.stack([Rotation.random(random_state=10 + i).as_matrix()
                  for i in range(N)]).astype(np.float32)
    return dict(
        render=(0.2 * rng.normal(size=(N, img, img, 3))).astype(np.float32),
        real=(0.2 * rng.normal(size=(N, img, img, 3))).astype(np.float32),
        R=R, t=np.array([[5.0, -4.0, 400.0], [-6.0, 3.0, 420.0]], np.float32),
        depth=np.where(rng.random((N, img, img)) < 0.8, 400.0, 0.0).astype(np.float32),
        K=np.tile(np.array([[[100.0, 0, img / 2], [0, 100.0, img / 2], [0, 0, 1]]],
                           np.float32), (N, 1, 1)),
        label=np.array([0, 2], np.int32))


def _interpret_lookup(monkeypatch):
    """The JAX pallas lookup calls its kernel with interpret=False, which
    the CPU cannot run; a partial cannot override that keyword."""
    orig = jcl.corr_lookup_pallas_flat

    def interpret(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(jcl, "corr_lookup_pallas_flat", interpret)


def _args(sc, lib):
    keys = ("render", "real", "R", "t", "depth", "K", "label")
    if lib == "jax":
        return [jnp.asarray(sc[k]) for k in keys]
    return [torch.from_numpy(np.array(sc[k])) for k in keys]


@pytest.fixture(scope="module")
def pair16():
    """(flax bf16 refiner, variables, port fp32 refiner, port bf16 refiner)
    with the same weights (tests' scflow_pair: pose-head output kernels
    normal(0, 0.02))."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
    from torch_port_helpers import scflow_pair

    fmodel, variables, port32 = scflow_pair(NCLASS, IMG, ITERS)
    with torch.random.fork_rng(devices=[]):
        port16 = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=ITERS,
                               dtype=TB)
    port16 = load_port(port16, variables)
    return fmodel, fmodel.clone(dtype=BF), variables, port32, port16


def test_decoder_dtypes_follow_jax(pair16, monkeypatch):
    """Every carry and output of the bf16 decoder has the dtype JAX gives it:
    pyramid bf16, lookup output (corr) float32, motion features float32
    (concat with the float32 flow), h bf16, delta flow and mask bf16, pose
    deltas, R and t float32, flow carry float32, and the full-resolution
    outputs float32 (masks too: the resize's float32 matrices promote)."""
    from scflow_tpu_torch.models import scflow_decoder as dec

    _, f16, variables, _, port16 = pair16
    sc = _scene()
    _interpret_lookup(monkeypatch)
    # JAX: the update step's carry and outputs per iteration, the decoder's
    # outputs, and the pyramid / lookup dtypes of the same functions
    out_j, state = f16.apply(variables, *_args(sc, "jax"), lookup_backend="pallas",
                             capture_intermediates=True, mutable=["intermediates"])
    inter = state["intermediates"]["decoder"]
    carry, ys = inter["update"]["__call__"][0]
    jt = {"flow_carry": carry[0].dtype, "h": carry[2].dtype, "R": carry[3].dtype,
          "t": carry[4].dtype, "delta_flow": ys[1].dtype, "mask": ys[2].dtype,
          "d_rot": ys[5].dtype, "d_trans": ys[6].dtype,
          "motion": inter["update"]["encoder"]["__call__"][0].dtype,
          "gru": inter["update"]["gru"]["__call__"][0].dtype}
    jfeat = jnp.zeros((1, 8, 8, 256), BF)
    jpyr = j_pyramid(jfeat, jfeat, 4, out_dtype=BF)
    jt["pyramid"] = jpyr[0].dtype
    jt["corr"] = corr_lookup_pallas(list(jpyr), jnp.zeros((1, 8, 8, 2)), 4,
                                    interpret=True).dtype
    jt.update({f"out_{k}": v.dtype for k, v in out_j.items()})
    # the port, by hooks on the same modules
    seen = {}
    d = port16.decoder

    def hook(name, index=None):
        def fn(_, __, out):
            seen.setdefault(name, (out if index is None else out[index]).dtype)
        return fn

    d.encoder.register_forward_hook(hook("motion"))
    d.gru.register_forward_hook(hook("gru"))
    d.gru.register_forward_hook(hook("h"))
    d.flow_pred.register_forward_hook(hook("delta_flow"))
    d.mask_pred.register_forward_hook(hook("mask"))
    orig_pyr, orig_lookup, orig_delta = (dec.correlation_pyramid_flat, dec.corr_lookup,
                                         dec.apply_delta_pose)

    def pyr(*a, **kw):
        out = orig_pyr(*a, **kw)
        seen.setdefault("pyramid", out[0].dtype)
        return out

    def lookup(pyramid, flow, *a, **kw):
        seen.setdefault("flow_carry", flow.dtype)
        out = orig_lookup(pyramid, flow, *a, **kw)
        seen.setdefault("corr", out.dtype)
        return out

    def delta(d_rot, d_trans, R, t, **kw):
        seen.setdefault("d_rot", d_rot.dtype)
        seen.setdefault("d_trans", d_trans.dtype)
        out = orig_delta(d_rot, d_trans, R, t, **kw)
        seen.setdefault("R", out[0].dtype)
        seen.setdefault("t", out[1].dtype)
        return out

    monkeypatch.setattr(dec, "correlation_pyramid_flat", pyr)
    monkeypatch.setattr(dec, "corr_lookup", lookup)
    monkeypatch.setattr(dec, "apply_delta_pose", delta)
    with torch.no_grad():
        out_t = port16(*_args(sc, "torch"), lookup_backend="pallas")
    seen.update({f"out_{k}": v.dtype for k, v in out_t.items()})
    names = {jnp.float32: torch.float32, BF: TB}
    assert set(seen) == set(jt)
    assert {k: seen[k] for k in jt} == {k: names[jnp.dtype(v).type] for k, v in jt.items()}
    assert seen["mask"] == TB and seen["corr"] == torch.float32 and seen["h"] == TB


def test_refiner_bf16_matches_jax_bf16(pair16, no_tf32):
    """The port's bf16 refiner against JAX's on the same inputs (lookup
    'xla', every iteration's pose).  The bound follows from the fp32 runs:
    the port's bf16 pose is within twice JAX's own bf16-to-fp32 distance,
    plus the fp32 parity tolerance (rotations 2e-3, translations 2e-2 mm),
    of JAX's fp32 pose; and within tests/test_models.py::TestBF16's bounds
    of the port's fp32 pose (translations rtol 0.1, atol 2.0; rotations <
    0.05).  Poses come back float32."""
    f32, f16, variables, port32, port16 = pair16
    sc = _scene()
    j32 = f32.apply(variables, *_args(sc, "jax"), pose_only=True, lookup_backend="xla")
    j16 = f16.apply(variables, *_args(sc, "jax"), pose_only=True, lookup_backend="xla")
    with torch.no_grad():
        t16 = port16(*_args(sc, "torch"), pose_only=True, lookup_backend="xla")
        t32 = port32(*_args(sc, "torch"), pose_only=True, lookup_backend="xla")
    assert t16["rotations"].dtype == t16["translations"].dtype == torch.float32
    for key, tol in (("rotations", 2e-3), ("translations", 2e-2)):
        ref = np.asarray(j32[key])
        jax_dist = float(np.abs(np.asarray(j16[key]) - ref).max())
        port_dist = float(np.abs(t16[key].numpy() - ref).max())
        assert jax_dist > 0  # bf16 moved the poses: the bound is not vacuous
        assert port_dist <= 2 * jax_dist + tol, (key, port_dist, jax_dist)
    np.testing.assert_allclose(t16["translations"][-1].numpy(), t32["translations"][-1].numpy(),
                               rtol=0.1, atol=2.0)
    assert (t16["rotations"][-1] - t32["rotations"][-1]).abs().max() < 0.05


def test_one_state_dict_drives_both_dtypes(pair16):
    """convert.py is unchanged: flax params are float32 in either dtype, so
    one converted state dict loads strictly into the fp32 and the bf16
    refiner, whose parameters and BatchNorm statistics stay float32."""
    _, _, variables, port32, port16 = pair16
    sd = state_dict_from_flax(variables)
    for model in (port32, port16):
        model.load_state_dict(sd, strict=True)
        assert all(v.dtype in (torch.float32, torch.int64) for v in model.state_dict().values())
    sc = _scene()
    with torch.no_grad():
        outs = [m(*_args(sc, "torch"), pose_only=True, lookup_backend="pallas")
                for m in (port32, port16)]
    for out in outs:
        assert torch.isfinite(out["translations"]).all()
    assert not torch.equal(outs[0]["translations"], outs[1]["translations"])


def test_refiner_rejects_other_dtypes():
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    with pytest.raises(ValueError, match="dtype"):
        SCFlowRefiner(num_class=1, image_size=(64, 64), dtype=torch.float16)


def _infer_pair(fmodel, port, **kw):
    """JAX's make_scflow_infer_fn and the port's on the same sphere bank,
    lookup and render on their tensor paths ('xla'), culling on."""
    from scflow_tpu.refiners import system as jsystem
    from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
    from scflow_tpu_torch.refiners.system import RenderAssets, make_scflow_infer_fn
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank_kw = dict(kind="sphere", size=160.0, subdivisions=2)
    j_infer = jsystem.make_scflow_infer_fn(
        fmodel, jsystem.RenderAssets.from_bank(j_bank(NCLASS, **bank_kw)), image_size=(IMG, IMG),
        render_backend="xla", lookup_backend="xla", render_cull_backfaces=True, **kw)
    infer = make_scflow_infer_fn(
        port, RenderAssets.from_bank(make_synthetic_bank(NCLASS, **bank_kw), device="cpu"),
        image_size=(IMG, IMG), render_backend="xla", lookup_backend="xla",
        render_cull_backfaces=True, device="cpu", **kw)
    return j_infer, infer


def _infer_batch():
    sc = _scene()
    return dict(real_images=sc["real"], ref_rotations=sc["R"], ref_translations=sc["t"],
                k=sc["K"], labels=sc["label"])


def _assert_poses(got, want):
    np.testing.assert_allclose(got["rotations"].numpy(), np.asarray(want["rotations"]),
                               atol=2e-3)
    np.testing.assert_allclose(got["translations"].numpy(), np.asarray(want["translations"]),
                               rtol=2e-3, atol=2e-2)


def test_infer_fn_full_outputs_match_jax(pair16, no_tf32):
    """slim=False (the default, as in JAX) returns the final masks (N, H, W)
    and flow (N, H, W, 2) beside the pose, equal to JAX's slim=False call:
    poses at the slice tolerances, masks atol 1e-3, flow atol 2e-2 px."""
    f32, _, variables, port32, _ = pair16
    j_infer, infer = _infer_pair(f32, port32)
    batch = _infer_batch()
    want = j_infer(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    got = infer(batch)
    assert set(got) == set(want) == {"rotations", "translations", "masks", "flow"}
    assert got["masks"].shape == (N, IMG, IMG) and got["flow"].shape == (N, IMG, IMG, 2)
    _assert_poses(got, want)
    np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), atol=1e-3)
    np.testing.assert_allclose(got["flow"].numpy(), np.asarray(want["flow"]), atol=2e-2)
    assert np.abs(np.asarray(want["flow"])).max() > 0.1  # the flow is not all zero


def test_infer_fn_bf16_full_outputs(pair16):
    """A bf16 model's slim=False call: float32 poses, masks and flow, finite,
    of the JAX shapes."""
    _, f16, variables, _, port16 = pair16
    j_infer, infer = _infer_pair(f16, port16)
    batch = _infer_batch()
    want = j_infer(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    got = infer(batch)
    for k, v in got.items():
        assert v.dtype == torch.float32 and tuple(v.shape) == tuple(want[k].shape)
        assert torch.isfinite(v).all()
        assert np.asarray(want[k]).dtype == np.float32


def test_infer_fn_norms_and_iters_as_jax(pair16, no_tf32):
    """norm_mean / norm_std other than the defaults change the rendered
    images, and so the poses, as JAX's do; iters overrides the model's."""
    f32, _, variables, port32, _ = pair16
    batch = _infer_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    base = _infer_pair(f32, port32, slim=True)[1](batch)
    for kw in (dict(norm_mean=(123.7, 116.3, 103.5), norm_std=(58.4, 57.1, 57.4)),
               dict(iters=1)):
        j_infer, infer = _infer_pair(f32, port32, slim=True, **kw)
        got = infer(batch)
        _assert_poses(got, j_infer(variables, jb))
        assert (got["translations"] - base["translations"]).abs().max() > 1e-3


def test_infer_fn_signature_is_jaxs():
    """The JAX function's parameters, in its order and with its defaults,
    then lookup_variant and device."""
    from scflow_tpu.refiners import system as jsystem
    from scflow_tpu_torch.refiners import system

    want = inspect.signature(jsystem.make_scflow_infer_fn).parameters
    got = inspect.signature(system.make_scflow_infer_fn).parameters
    assert list(got) == list(want) + ["lookup_variant", "device"]
    for name, p in want.items():
        if p.default is not inspect.Parameter.empty:
            assert got[name].default == p.default, name
    assert got["slim"].default is False and got["unroll"].default is False


@pytest.mark.parametrize("unroll", [1, "yes", None])
def test_infer_fn_rejects_a_non_bool_unroll(unroll, pair16):
    from scflow_tpu_torch.refiners.system import RenderAssets, make_scflow_infer_fn
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    assets = RenderAssets.from_bank(make_synthetic_bank(NCLASS), device="cpu")
    with pytest.raises(TypeError, match="unroll"):
        make_scflow_infer_fn(pair16[3], assets, image_size=(IMG, IMG), unroll=unroll,
                             device="cpu")
    for flag in (True, False):  # a bool is accepted, and means nothing here
        make_scflow_infer_fn(pair16[3], assets, image_size=(IMG, IMG), unroll=flag,
                             device="cpu")


def test_entry_points_hold_bf16_gemms_in_fp32():
    """Inside a call cuBLAS may not reduce bf16 GEMMs in reduced precision
    (JAX's bf16 products accumulate in float32 and round once); the flag is
    restored afterwards, also when the call raises."""
    from scflow_tpu_torch.device import full_fp32

    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        with full_fp32():
            assert matmul.allow_bf16_reduced_precision_reduction is False
        assert matmul.allow_bf16_reduced_precision_reduction is True
        with pytest.raises(KeyError):
            with full_fp32():
                raise KeyError
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
