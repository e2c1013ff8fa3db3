"""The port's render augmentations (models/augment.py) against the JAX
package's (scflow_tpu/models/augment.py), and in both train steps.

The two packages draw their parameters from different generators (the port
from torch generators keyed by (augment_seed, step, index), JAX from
jax.random keys folded the same way), so parity feeds the port JAX's draws:
`jax_params` recomputes them with jax.random in JAX's split order
(ColorJiggle splits its key 5 ways, noise and blur 2, grayscale uses the
key itself; the noise field is JAX's array).  Each apply then agrees with
JAX's function within 1e-5.  The hue's sector index floor(6 h) can land on
the other side of a sector border in the two packages, but the conversion
is continuous across borders, so such flips stay within the same bound.
The port's own draws are checked for their ranges, gate rates,
determinism in (augment_seed, step) and resume-exactness."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as nn
from scflow_tpu.models import augment as jaug
from scflow_tpu.models import layers as jlayers
from scflow_tpu.models import raft_encoder as jraft_encoder
from scflow_tpu.refiners import system as jsystem
from scflow_tpu_torch.models import augment
from scflow_tpu_torch.models.augment import (AUGMENTATIONS, RenderAugmentation,
                                             build_render_augmentation)
from scflow_tpu_torch.refiners.system import make_scflow_train_step
from scflow_tpu_torch.runtime.optim import build_optimizer
from scflow_tpu_torch.runtime.train_state import TrainState

from torch_port_helpers import keep_torch_rng, no_tf32  # noqa: F401

# the configuration the card's train_augment phase runs
SHIPPED = [dict(type="ColorJiggle", brightness=0.3, contrast=0.3, saturation=0.3, hue=0.05),
           dict(type="RandomGaussianNoise", std=0.05, p=0.5),
           dict(type="RandomGaussianBlur", kernel_size=5, sigma=(0.1, 2.0), p=0.5),
           dict(type="RandomGrayscale", p=0.1)]


def jax_params(cfgs, key, shape, noise_dtype=jnp.float32):
    """JAX's parameters of each configured augmentation under `key` (the
    step's key), as the port's param dicts of tensors.  JAX draws the noise
    field in the images' dtype at that point (noise_dtype: float64 after a
    ColorJiggle of float64 factors under jax.enable_x64)."""
    n = shape[0]
    out = []
    for i, cfg in enumerate(cfgs):
        cfg = dict(cfg)
        kind = cfg.pop("type")
        k = jax.random.fold_in(key, i)
        flat = {}
        if kind == "ColorJiggle":
            kb, kc, ks, kh, kp = jax.random.split(k, 5)
            for name, kk in (("brightness", kb), ("contrast", kc), ("saturation", ks)):
                a = cfg.get(name, 0.0)
                if a:
                    flat[name] = jax.random.uniform(kk, (n, 1, 1, 1), minval=max(0.0, 1 - a),
                                                    maxval=1 + a)
            if cfg.get("hue", 0.0):
                flat["hue"] = jax.random.uniform(kh, (n, 1, 1), minval=-cfg["hue"],
                                                 maxval=cfg["hue"])
            flat["gate"] = jax.random.uniform(kp, (n, 1, 1, 1)) < cfg.get("p", 1.0)
        elif kind == "RandomGaussianNoise":
            kn, kp = jax.random.split(k)
            flat["noise"] = jax.random.normal(kn, shape, noise_dtype)
            flat["gate"] = jax.random.uniform(kp, (n, 1, 1, 1)) < cfg.get("p", 0.5)
        elif kind == "RandomGaussianBlur":
            ks, kp = jax.random.split(k)
            lo, hi = cfg.get("sigma", (0.1, 2.0))
            flat["sigma"] = jax.random.uniform(ks, (n, 1), minval=lo, maxval=hi)
            flat["gate"] = jax.random.uniform(kp, (n, 1, 1, 1)) < cfg.get("p", 0.5)
        else:
            flat["gate"] = jax.random.uniform(k, (n, 1, 1, 1)) < cfg.get("p", 0.1)
        out.append({name: torch.from_numpy(np.array(v) if name == "noise"
                                           else np.array(v).reshape(n))
                    for name, v in flat.items()})
    return out


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    x = rng.random((6, 24, 20, 3)).astype(np.float32)
    x[0] = 0.25  # a flat sample; and a saturated one
    x[1, :, :, 0] = 1.0
    return x


def _one(cfg, images, seed=3):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.build_render_augmentation([cfg])(key, jnp.asarray(images)))
    params = jax_params([cfg], key, images.shape)
    aug = build_render_augmentation([cfg])
    got = aug.apply(torch.from_numpy(images), params).numpy()
    return got, want, params[0]


@pytest.mark.parametrize("cfg", [
    dict(type="ColorJiggle", brightness=0.4, p=1.0),
    dict(type="ColorJiggle", contrast=0.5, p=1.0),
    dict(type="ColorJiggle", saturation=1.0, p=1.0),
    dict(type="ColorJiggle", hue=0.5, p=1.0),
    dict(type="ColorJiggle", brightness=0.3, contrast=0.3, saturation=0.3, hue=0.05, p=0.5),
    dict(type="RandomGaussianNoise", mean=0.02, std=0.1, p=0.5),
    dict(type="RandomGaussianBlur", kernel_size=5, sigma=(0.1, 2.0), p=0.7),
    dict(type="RandomGaussianBlur", kernel_size=7, sigma=(0.5, 3.0), p=1.0),
    dict(type="RandomGrayscale", p=0.5),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_apply_matches_jax_on_its_draws(cfg, images):
    """Each augmentation's apply on JAX's parameters equals JAX's function
    on the same key (1e-5), with some samples gated off and some on."""
    got, want, params = _one(cfg, images)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    gate = params["gate"].numpy()
    if 0 < cfg["p"] < 1:  # both branches are exercised on this key
        assert gate.any() and not gate.all(), gate
    assert np.abs(want - images).max() > 1e-3


def test_hsv_helpers_match_jax(images):
    h, s, v = augment._rgb_to_hsv(torch.from_numpy(images))
    jh, js, jv = jaug._rgb_to_hsv(jnp.asarray(images))
    for a, b in ((h, jh), (s, js), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(augment._hsv_to_rgb(h, s, v).numpy(), images, atol=1e-5)
    np.testing.assert_allclose(augment._hsv_to_rgb(h, s, v).numpy(),
                               np.asarray(jaug._hsv_to_rgb(jh, js, jv)), rtol=0, atol=1e-6)


def test_composition_order_matches_jax(images, monkeypatch):
    """The composition applies the augmentations in config order, each on
    its own key: the shipped four on JAX's draws equal JAX's composition,
    and the reversed order gives other images."""
    key = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    want = np.asarray(jaug.build_render_augmentation(SHIPPED)(key, jnp.asarray(images)))
    monkeypatch.setattr(RenderAugmentation, "draw",
                        lambda self, k, imgs: jax_params(SHIPPED, key, tuple(imgs.shape)))
    got = build_render_augmentation(SHIPPED)((5, 2), torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    rev = build_render_augmentation(SHIPPED[::-1])
    params = jax_params(SHIPPED, key, images.shape)[::-1]
    assert np.abs(rev.apply(torch.from_numpy(images), params).numpy() - got).max() > 1e-3


def test_draws_land_in_range_and_gates_fire_at_rate_p():
    """The port's draws over 4000 samples: factors, hue shifts and sigmas
    in their ranges and spread over them; gates at rate p within 4.5
    standard deviations; the noise field standard normal."""
    n = 4000
    aug = build_render_augmentation([
        dict(type="ColorJiggle", brightness=0.3, contrast=1.2, saturation=0.3, hue=0.05, p=0.8),
        dict(type="RandomGaussianNoise", std=0.05, p=0.5),
        dict(type="RandomGaussianBlur", kernel_size=5, sigma=(0.1, 2.0), p=0.3),
        dict(type="RandomGrayscale", p=0.1)])
    cj, noise, blur, gray = aug.draw((0, 0), torch.zeros(n, 4, 4, 3))
    for x, lo, hi in ((cj["brightness"], 0.7, 1.3), (cj["contrast"], 0.0, 2.2),
                      (cj["saturation"], 0.7, 1.3), (cj["hue"], -0.05, 0.05),
                      (blur["sigma"], 0.1, 2.0)):
        assert x.shape == (n,) and x.min() >= lo and x.max() <= hi
        assert x.min() < lo + 0.01 * (hi - lo) and x.max() > hi - 0.01 * (hi - lo)
    for prm, p in ((cj, 0.8), (noise, 0.5), (blur, 0.3), (gray, 0.1)):
        assert prm["gate"].dtype == torch.bool
        assert abs(prm["gate"].float().mean().item() - p) < 4.5 * np.sqrt(p * (1 - p) / n)
    assert noise["noise"].shape == (n, 4, 4, 3)
    assert abs(noise["noise"].mean().item()) < 0.02 and abs(noise["noise"].std().item() - 1) < 0.02


def test_same_key_same_images_other_step_other_images(images):
    """Deterministic in (augment_seed, step): the same key twice gives the
    same bits, another step or seed other images; torch's global RNG is
    not drawn from."""
    aug = build_render_augmentation(SHIPPED)
    x = torch.from_numpy(images)
    before = torch.get_rng_state()
    a, b = aug((0, 7), x), aug((0, 7), x)
    assert torch.equal(torch.get_rng_state(), before)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (aug((0, 8), x) - a).abs().max() > 1e-3
    assert (aug((1, 7), x) - a).abs().max() > 1e-3
    assert augment._seeds(0, 7, 0) != augment._seeds(0, 7, 1)


@pytest.mark.parametrize("cfgs,error", [
    (dict(type="ColorJiggle"), "must be a list"),
    ([dict(brightness=0.2)], "must be a list"),
    ([dict(type="ColorJitter")], "unknown type 'ColorJitter'"),
    ([dict(type="ColorJiggle", hue=0.6)], "hue"),
    ([dict(type="RandomGaussianBlur", kernel_size=4)], "odd"),
])
def test_build_refuses_bad_configs(cfgs, error):
    assert set(AUGMENTATIONS._modules) == {"ColorJiggle", "RandomGaussianNoise",
                                           "RandomGaussianBlur", "RandomGrayscale"}
    assert build_render_augmentation(None) is None and build_render_augmentation([]) is None
    with pytest.raises(ValueError, match=error):
        build_render_augmentation(cfgs)


# ------------------------------------------------------------ train steps

ITERS = 1  # one iteration: the augmentations act on the render, before the recurrence


@pytest.fixture(scope="module")
def scflow_setup():
    """tests/test_torch_train.py's models, assets and batch (2 iterations)."""
    from scipy.spatial.transform import Rotation

    import test_torch_train as tt
    from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
    from scflow_tpu_torch.refiners.system import RenderAssets, loss_assets_from_bank
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from torch_port_helpers import scflow_pair_torch_init

    n, h = tt.N, tt.H
    fmodel, variables, port = scflow_pair_torch_init(tt.NCLASS, h, tt.ITERS, **tt.SHIPPED)
    jb = j_bank(tt.NCLASS)
    j_render = jsystem.RenderAssets.from_bank(jb)
    rng = np.random.default_rng(0)
    gt_R = Rotation.random(n, rng).as_matrix().astype(np.float32)
    gt_t = np.stack([rng.normal(size=n) * 10, rng.normal(size=n) * 10,
                     rng.uniform(380, 450, n)], -1).astype(np.float32)
    dR = Rotation.from_euler("xyz", rng.normal(size=(n, 3)) * 8,
                             degrees=True).as_matrix().astype(np.float32)
    K = np.tile(np.array([[[120.0, 0, h / 2], [0, 120.0, h / 2], [0, 0, 1]]], np.float32),
                (n, 1, 1))
    labels = np.array([1, 2], np.int32)
    real, _, gt_masks = jsystem.render_and_normalize(
        j_render, jnp.asarray(gt_R), jnp.asarray(gt_t), jnp.asarray(K), jnp.asarray(labels),
        (h, h), (0.0, 0.0, 0.0), (255.0,) * 3, chunk=16)
    batch = dict(real_images=np.asarray(real), ref_rotations=np.einsum("nij,njk->nik", dR, gt_R),
                 ref_translations=gt_t + rng.normal(size=(n, 3)).astype(np.float32)
                 * np.array([5, 5, 15], np.float32),
                 gt_rotations=gt_R, gt_translations=gt_t, labels=labels, k=K,
                 gt_masks=np.asarray(gt_masks))
    tb = make_synthetic_bank(tt.NCLASS)
    return dict(fmodel=fmodel, variables=variables, port=port, j_render=j_render,
                j_loss=jsystem.loss_assets_from_bank(jb, tt.SYM), batch=batch,
                render=RenderAssets.from_bank(tb, device="cpu"),
                loss=loss_assets_from_bank(tb, tt.SYM, device="cpu"))


class TwoPassInstanceNorm(jlayers.InstanceNorm):
    """JAX's InstanceNorm (affine=False) with two-pass statistics in the
    input's dtype: a float64 yardstick."""

    @nn.compact
    def __call__(self, x):
        mean = x.mean(axis=(1, 2), keepdims=True)
        var = ((x - mean) ** 2).mean(axis=(1, 2), keepdims=True)
        return (x - mean) * jax.lax.rsqrt(var + self.eps)


def _patch_draws(monkeypatch, cfgs, seen):
    """The port's draw returns JAX's for the step's key, fold_in(PRNGKey(
    augment_seed), step), as JAX's train step keys it.  A test-only patch."""
    def draw(self, key, imgs):
        seen.append(key)
        return jax_params(cfgs, jax.random.fold_in(jax.random.PRNGKey(key[0]), key[1]),
                          tuple(imgs.shape))

    monkeypatch.setattr(RenderAugmentation, "draw", draw)


def _jax_grads(new_state):
    import optax

    from scflow_tpu_torch.convert import state_dict_from_flax

    adam = [x for x in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)][0]
    return state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - 0.9), adam.mu)})


def test_scflow_train_step_with_augmentations_matches_jax(scflow_setup, monkeypatch, no_tf32):
    """tests/test_torch_train.py's bounds (loss and log_vars rtol 2e-4,
    gradients rel L2 2e-2, from PyTorch's initialisation) on one step with
    the four augmentations, augment_seed 4, the port fed JAX's draws for the
    step's key (4, 0); without them the loss differs.  The yardstick is
    JAX's step in float64, as tests/test_torch_raft_train.py takes it
    (JAX's float32 pair sits at 1.9e-2 of the bound without augmentations),
    with its InstanceNorm in float64 as well: JAX's computes its statistics
    in float32, single-pass (E[x^2] - E[x]^2), whatever the input's dtype,
    which on these augmented renders moves the feature encoder's weight
    gradients: the port's float64 gradients on the same inputs sit up to
    1.9e-2 from JAX's x64 ones on those leaves and within 1e-5 on every
    other leaf."""
    import test_torch_train as tt
    from scflow_tpu.runtime import TrainState as JTrainState
    from scflow_tpu.runtime import build_optimizer as j_build_optimizer

    s = scflow_setup
    for mod in (jlayers, jraft_encoder):  # the yardstick's norms in float64 too
        monkeypatch.setattr(mod, "InstanceNorm", TwoPassInstanceNorm)
    key = jax.random.fold_in(jax.random.PRNGKey(4), 0)
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), s["variables"])
    batch = dict(s["batch"], real_images=np.asarray(s["batch"]["real_images"], np.float64))
    with jax.enable_x64(True):
        tx, _ = j_build_optimizer(tt.OPT, None, grad_clip=10.0)
        state = JTrainState.create(variables["params"], tx, variables["batch_stats"])
        step = jsystem.make_scflow_train_step(s["fmodel"], s["j_render"], s["j_loss"],
                                              image_size=(tt.H, tt.H), render_chunk=16,
                                              donate=False, render_augmentations=SHIPPED,
                                              augment_seed=4)
        new, j_logs = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        want = jax_params(SHIPPED, key, s["batch"]["real_images"].shape, jnp.float64)
    j_logs, j_grads = {k: float(v) for k, v in j_logs.items()}, _jax_grads(new)
    seen = []
    monkeypatch.setattr(RenderAugmentation, "draw",
                        lambda self, k, imgs: seen.append(k) or want)

    def port_step(cfgs):
        model = copy.deepcopy(s["port"])
        ptx, _ = build_optimizer(model.parameters(), tt.OPT, None, grad_clip=10.0)
        pstep = make_scflow_train_step(model, s["render"], s["loss"], image_size=(tt.H, tt.H),
                                       render_chunk=16, device="cpu", augment_seed=4,
                                       render_augmentations=cfgs)
        return pstep(TrainState(model, ptx), s["batch"])

    pstate, logs = port_step(SHIPPED)
    assert seen == [(4, 0)] and pstate.step == 1 and set(logs) == set(j_logs)
    for k, v in j_logs.items():
        np.testing.assert_allclose(float(logs[k]), v, rtol=2e-4, err_msg=k)
    grads = {n: p.grad for n, p in pstate.model.named_parameters()}
    assert tt._worst_grad_rel(grads, j_grads) <= 2e-2
    _, plain = port_step(None)
    assert abs(float(plain["loss"]) - j_logs["loss"]) > 1e-3 * abs(j_logs["loss"])


def test_raft_train_step_with_augmentations_matches_jax(monkeypatch, no_tf32):
    """tests/test_torch_raft_train.py's protocol (against JAX's step with the
    network in float64: loss and log_vars rtol 2e-4, gradients rel L2
    2e-2) on one step with the four augmentations, the port fed JAX's
    draws; JAX draws them in float64 there, and the port applies them in
    the render's float32."""
    import test_torch_raft_train as rt
    from test_torch_raft_system import make_setup
    from torch_port_helpers import raft_pair_torch_init

    s = make_setup(*raft_pair_torch_init(rt.IMG, ITERS, seed=1))
    with jax.enable_x64(True):  # JAX's x64 step draws its uniforms in float64
        want = jax_params(SHIPPED, jax.random.fold_in(jax.random.PRNGKey(0), 0),
                          (2, rt.IMG, rt.IMG, 3), jnp.float64)
    seen = []
    monkeypatch.setattr(RenderAugmentation, "draw",
                        lambda self, key, imgs: seen.append(key) or want)
    _, j_logs, j_grads = rt._jax_step(s, "xla", x64=True, render_augmentations=SHIPPED)
    state, logs = rt._port_step(s, "pallas", render_augmentations=SHIPPED)
    assert seen == [(0, 0)] and set(logs) == set(j_logs)
    for k, v in j_logs.items():
        np.testing.assert_allclose(float(logs[k]), v, rtol=2e-4, err_msg=k)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert rt._worst_grad_rel(grads, j_grads) <= 2e-2


def test_resumed_runner_equals_an_unbroken_run(scflow_setup, tmp_path, no_tf32):
    """IterRunner with an augmented step: 3 steps, checkpoint, a fresh state
    resumed from it and 1 step more, equal to an unbroken 4-step run bit for
    bit (the augmentations key on the restored state.step)."""
    from scflow_tpu_torch.runtime.runner import CheckpointHook, IterRunner

    s = scflow_setup
    cfgs = SHIPPED[:1] + [dict(SHIPPED[1], p=1.0)]

    def run(max_iters, work, resume=False):
        model = copy.deepcopy(s["port"])
        tx, _ = build_optimizer(model.parameters(), dict(type="AdamW", lr=1e-3), None,
                                grad_clip=10.0)
        step = make_scflow_train_step(model, s["render"], s["loss"], image_size=(64, 64),
                                      render_chunk=16, device="cpu", augment_seed=2,
                                      render_augmentations=cfgs)
        batches = iter([dict(s["batch"]) for _ in range(max_iters)])
        runner = IterRunner(step, TrainState(model, tx), batches, max_iters,
                            work_dir=str(tmp_path / work), hooks=[CheckpointHook(interval=3)])
        if resume:
            assert runner.resume() == 3
        return runner.run().model

    straight = run(4, "a")
    run(3, "b")
    resumed = run(4, "b", resume=True)
    for (k, a), b in zip(straight.state_dict().items(), resumed.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
