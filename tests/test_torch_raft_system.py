"""The port's RAFT entry points (refiners/system.py: make_raft_infer_fn
with pnp_backend 'host' and 'device', make_raft_val_step) against the JAX
package's, at N = 2, 64^2, 2 iterations, on a batch whose real images are
rendered at gt poses (test_torch_train.py's recipe), the renders on the
brute-force path in both ('auto' on the CPU).

Bounds: rendered masks on all but 2e-3 of the pixels and depth 1e-3 where
both cover (tests/test_torch_render.py's, for XLA's FMA contraction); the
flow within 2e-3 px + 2e-3 of its scale and the occlusion within 2e-4 (the
renders' rounding reaches the network); the device PnP on JAX's hypothesis
indices within 1e-3 (rotation) and 0.5 mm; the val metrics rtol 1e-3,
their pixel shares atol 2e-3 (a pixel at a threshold may flip).  bf16:
twice JAX's own bf16-to-fp32 distance plus the fp32 bound."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.refiners import system as jsystem
from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu_torch.refiners import system
from scflow_tpu_torch.render.meshbank import make_synthetic_bank

from torch_port_helpers import keep_torch_rng, no_tf32, raft_pair  # noqa: F401

N, IMG, NCLASS, ITERS = 2, 64, 3, 2
PNP = dict(num_points=256, num_hypotheses=16)


def make_setup(fmodel, variables, port):
    """The models, both packages' render assets and a batch: real images
    rendered at gt poses, jittered reference poses, gt masks from the
    render."""
    from scipy.spatial.transform import Rotation

    j_render = jsystem.RenderAssets.from_bank(j_bank(NCLASS))
    rng = np.random.default_rng(0)
    gt_R = Rotation.random(N, rng).as_matrix().astype(np.float32)
    gt_t = np.stack([rng.normal(size=N) * 10, rng.normal(size=N) * 10,
                     rng.uniform(380, 450, N)], -1).astype(np.float32)
    dR = Rotation.from_euler("xyz", rng.normal(size=(N, 3)) * 8,
                             degrees=True).as_matrix().astype(np.float32)
    K = np.tile(np.array([[[120.0, 0, IMG / 2], [0, 120.0, IMG / 2], [0, 0, 1]]], np.float32),
                (N, 1, 1))
    labels = np.array([1, 2], np.int32)
    real, _, gt_masks = jsystem.render_and_normalize(
        j_render, jnp.asarray(gt_R), jnp.asarray(gt_t), jnp.asarray(K), jnp.asarray(labels),
        (IMG, IMG), (0.0, 0.0, 0.0), (255.0,) * 3, chunk=16)
    batch = dict(real_images=np.array(real), ref_rotations=np.einsum("nij,njk->nik", dR, gt_R),
                 ref_translations=gt_t + rng.normal(size=(N, 3)).astype(np.float32)
                 * np.array([5, 5, 15], np.float32),
                 gt_rotations=gt_R, gt_translations=gt_t, labels=labels, k=K,
                 gt_masks=np.array(gt_masks))
    return dict(fmodel=fmodel, variables=variables, port=port, j_render=j_render, batch=batch,
                render=system.RenderAssets.from_bank(make_synthetic_bank(NCLASS), device="cpu"))


@pytest.fixture(scope="module")
def setup():
    return make_setup(*raft_pair(IMG, ITERS, seed=7))


def _jax_infer(s, fmodel=None, **kw):
    infer = jsystem.make_raft_infer_fn(fmodel or s["fmodel"], s["j_render"], image_size=(IMG, IMG),
                                       render_chunk=16, lookup_backend="xla", **kw)
    out = infer(s["variables"], {k: jnp.asarray(v) for k, v in s["batch"].items()
                                 if not k.startswith("gt_")})
    return {k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
            for k, v in out.items()}


def _jax_val(s, fmodel=None):
    step = jsystem.make_raft_val_step(fmodel or s["fmodel"], s["j_render"], image_size=(IMG, IMG),
                                      lookup_backend="xla")
    return {k: float(v) for k, v in step(s["variables"], {
        k: jnp.asarray(v) for k, v in s["batch"].items()}).items()}


@pytest.fixture(scope="module")
def jax_fp32(setup):
    """JAX's fp32 infer ('host') and val outputs, computed once."""
    return _jax_infer(setup), _jax_val(setup)


def _port_infer(s, model=None, **kw):
    infer = system.make_raft_infer_fn(model or s["port"], s["render"], image_size=(IMG, IMG),
                                      render_chunk=16, lookup_backend="pallas", device="cpu",
                                      **kw)
    return infer({k: v for k, v in s["batch"].items() if not k.startswith("gt_")})


def _check_render(got, want):
    m, gm = want["rendered_masks"], got["rendered_masks"].numpy()
    assert m.mean() > 0.05 and (gm != m).mean() < 2e-3
    both = (gm > 0) & (m > 0)
    np.testing.assert_allclose(got["rendered_depths"].numpy()[both],
                               want["rendered_depths"][both], atol=1e-3)


def _check_flow(got, want, slack=None):
    for k, tol in (("flow", 2e-3 + 2e-3 * np.abs(want["flow"]).max()), ("occlusion", 2e-4)):
        err = np.abs(got[k].float().numpy() - want[k]).max()
        assert err <= tol + (0 if slack is None else 2 * slack[k]), (k, err)


def test_infer_fn_host_matches_jax(setup, jax_fp32, no_tf32):
    """pnp_backend='host': the final flow and occlusion and the render the
    host PnP reads, of JAX's keys and shapes, no pose."""
    want = jax_fp32[0]
    got = _port_infer(setup)
    assert set(got) == set(want) == {"flow", "occlusion", "rendered_depths", "rendered_masks"}
    assert got["flow"].shape == (N, IMG, IMG, 2) and got["occlusion"].shape == (N, IMG, IMG)
    _check_render(got, want)
    _check_flow(got, want)


def test_infer_fn_device_pnp_matches_jax(setup, monkeypatch, no_tf32):
    """pnp_backend='device': the port's RANSAC given JAX's hypothesis
    indices for each sample (JAX's per-sample keys, split from PRNGKey(0)),
    so the poses are comparable; rotations, translations and pnp_ok."""
    from scflow_tpu_torch import pnp

    from test_torch_raft_pnp import _jax_indices

    keys = jax.random.split(jax.random.PRNGKey(0), N)

    def jax_draw(valid, num_hypotheses, sample_size, generator, uniforms=None):
        return torch.stack([torch.from_numpy(_jax_indices(v.numpy(), k, num_hypotheses,
                                                          sample_size)).long()
                            for v, k in zip(valid, keys)])

    monkeypatch.setattr(pnp, "sample_hypotheses", jax_draw)
    want = _jax_infer(setup, pnp_backend="device", pnp_cfg=PNP)
    got = _port_infer(setup, pnp_backend="device", pnp_cfg=PNP)
    assert set(got) == set(want)
    _check_flow(got, want)
    np.testing.assert_array_equal(got["pnp_ok"].numpy(), want["pnp_ok"])
    assert want["pnp_ok"].any()
    np.testing.assert_allclose(got["rotations"].numpy(), want["rotations"], atol=1e-3)
    np.testing.assert_allclose(got["translations"].numpy(), want["translations"], atol=0.5)


def test_infer_fn_host_pose_from_the_outputs(setup):
    """The 'host' outputs feed flow_pose.solve_poses_from_flow as JAX's do."""
    from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow

    got = _port_infer(setup)
    b = setup["batch"]
    R, t, ok = solve_poses_from_flow(got["flow"], got["rendered_depths"], b["ref_rotations"],
                                     b["ref_translations"], b["k"], occlusion=got["occlusion"],
                                     sample_points=dict(num=500, mode="topk"))
    assert R.shape == (N, 3, 3) and t.shape == (N, 3) and ok.dtype == bool
    assert np.isfinite(R).all() and np.isfinite(t).all()


def test_val_step_matches_jax(setup, jax_fp32, no_tf32):
    """EPE, its noc variant (the gt flow filtered by the gt mask) and the
    occlusion L1 against the flow-magnitude target."""
    want = jax_fp32[1]
    step = system.make_raft_val_step(setup["port"], setup["render"], image_size=(IMG, IMG),
                                     lookup_backend="pallas", device="cpu")
    got = step(setup["batch"])
    assert set(got) == set(want) and len(want) == 9
    assert all(v.ndim == 0 for v in got.values())
    for k, v in want.items():
        tol = dict(atol=2e-3) if k.endswith("px") else dict(rtol=1e-3)
        np.testing.assert_allclose(float(got[k]), v, err_msg=k, **tol)
    no_mask = {k: v for k, v in setup["batch"].items() if k != "gt_masks"}
    assert set(step(no_mask)) == {"epe_mean", "epe_1px", "epe_3px", "epe_5px", "occ"}


def test_infer_and_val_bf16_match_jax_bf16(setup, jax_fp32, no_tf32):
    """dtype=bfloat16 on the same weights through make_raft_infer_fn: flow
    and occlusion within twice JAX's own bf16-to-fp32 distance plus the
    fp32 bounds; the val step's EPE within twice that distance (rtol 1e-3
    beside it)."""
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask

    with torch.random.fork_rng(devices=[]):
        port16 = RAFTRefinerFlowMask(iters=ITERS, dtype=torch.bfloat16)
    port16.load_state_dict(setup["port"].state_dict(), strict=True)
    f16 = setup["fmodel"].clone(dtype=jnp.bfloat16)
    want32, want16 = jax_fp32[0], _jax_infer(setup, fmodel=f16)
    got = _port_infer(setup, model=port16)
    assert got["flow"].dtype == torch.float32 and got["occlusion"].dtype == torch.bfloat16
    slack = {k: np.abs(want16[k] - want32[k]).max() for k in ("flow", "occlusion")}
    assert slack["flow"] > 0
    _check_flow(got, want16, slack)

    jv = [jax_fp32[1]["epe_mean"], _jax_val(setup, f16)["epe_mean"]]
    pv = float(system.make_raft_val_step(port16, setup["render"], image_size=(IMG, IMG),
                                         lookup_backend="pallas", device="cpu")(
        setup["batch"])["epe_mean"])
    assert abs(pv - jv[1]) <= 2 * abs(jv[1] - jv[0]) + 1e-3 * abs(jv[1])


@pytest.mark.parametrize("name", ["make_raft_infer_fn", "make_raft_val_step",
                                  "make_raft_train_step"])
def test_signatures_are_jaxs(name):
    """JAX's parameters in its order and with its defaults, then
    lookup_variant and device (and the train step's process_group, the
    data-parallel step)."""
    want = inspect.signature(getattr(jsystem, name)).parameters
    got = inspect.signature(getattr(system, name)).parameters
    extra = ["process_group"] if name == "make_raft_train_step" else []
    assert list(got) == list(want) + ["lookup_variant", "device"] + extra
    for k, p in want.items():
        if p.default is not inspect.Parameter.empty:
            assert got[k].default == p.default, k


@pytest.mark.parametrize("kw,match", [
    (dict(pnp_backend="cv2"), "pnp_backend"), (dict(pnp_backend=None), "pnp_backend"),
    (dict(lookup_backend="cuda"), "unknown backend"), (dict(iters=0), "iters"),
    (dict(lookup_backend="xla", lookup_variant="shift"), "variant"),
])
def test_infer_fn_rejects_unknown_options(setup, kw, match):
    with pytest.raises(ValueError, match=match):
        system.make_raft_infer_fn(setup["port"], setup["render"], image_size=(IMG, IMG),
                                  device="cpu", **kw)


def test_entry_points_refuse_the_cpu_without_asking(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (system.make_raft_infer_fn, system.make_raft_val_step,
               system.make_raft_train_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(setup["port"], setup["render"], image_size=(IMG, IMG))
