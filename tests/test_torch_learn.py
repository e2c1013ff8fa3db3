"""The learning check and its data against the JAX package: the
thread-mode seed of each rank of a train job (cli.seed_pipeline_rngs), the
port's synthetic BOP set (datasets/synthetic.py) against
tests/synthetic_bop.py, and tools/overfit_check.py's batch, ADD and train
steps (scflow_tpu_torch/tools/overfit_check.py) against the same recipe
built from the JAX package's functions (the JAX tool trains 2000 steps
when imported, so its lines are rebuilt here).

The step comparison runs 3 steps of both packages from the same weights
(the port's initialisation, in flax and read back through
convert.state_dict_from_flax) at 64^2, batch 2, 2 iterations, on both
lookup backends (JAX's 'pallas' in interpret mode): the first loss, before
any update, within rtol 2e-4 (tests/test_torch_train.py's bound); the next
two within rtol 2e-3, as Adam's first steps turn each package's float32
gradient noise into up to +-lr per weight (they sat 7e-5 and 7e-4 apart
when this was written)."""

import random

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from scflow_tpu.losses.point_matching import sym_mask_from_types
from scflow_tpu.ops.pallas import corr_lookup as jcl
from scflow_tpu.refiners import system as jsystem
from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu.runtime import TrainState as JTrainState
from scflow_tpu.runtime import build_optimizer as j_build_optimizer
from scflow_tpu_torch import cli
from scflow_tpu_torch.convert import state_dict_from_flax
from scflow_tpu_torch.datasets import DataLoader
from scflow_tpu_torch.datasets.pipelines.imops import fill_circle, imread
from scflow_tpu_torch.datasets.pipelines.jitter import PoseJitter
from scflow_tpu_torch.datasets.synthetic import build_synthetic_bop
from scflow_tpu_torch.refiners.system import (RenderAssets, loss_assets_from_bank,
                                              make_scflow_train_step)
from scflow_tpu_torch.runtime.optim import build_optimizer
from scflow_tpu_torch.runtime.train_state import TrainState
from scflow_tpu_torch.tools import overfit_check as oc

from synthetic_bop import build_synthetic_bop as j_build_synthetic_bop
from torch_port_helpers import keep_torch_rng  # noqa: F401
from torch_train_helpers import keep_global_rngs  # noqa: F401

# --- (a) the thread-mode seed of each rank ---------------------------------


class _Jittered:
    """Sample idx: (idx, PoseJitter's draws for one object at the origin),
    the shipped jitter's ranges (no ADD cap, so no meshes)."""

    def __init__(self):
        self.jitter = PoseJitter(jitter_angle_dis=(0, 10), jitter_x_dis=(0, 8),
                                 jitter_y_dis=(0, 8), jitter_z_dis=(0, 20), angle_limit=45,
                                 translation_limit=200,
                                 jitter_pose_field=["gt_rotations", "gt_translations"],
                                 jittered_pose_field=["ref_rotations", "ref_translations"])

    def __len__(self):
        return 8

    def __getitem__(self, idx):
        res = self.jitter(dict(gt_rotations=np.eye(3, dtype=np.float32)[None],
                               gt_translations=np.zeros((1, 3), np.float32), labels=[0]))
        return int(idx), res["ref_rotations"][0], res["ref_translations"][0]


def _rank_draws(rank: int, seed) -> list:
    """The first 4 samples of rank `rank` of 2 (thread mode, 1 worker) after
    seed(): (index, jittered rotation, jittered translation) each."""
    seed()
    it = iter(DataLoader(_Jittered(), samples_per_step=2, num_workers=1, seed=0,
                         process_index=rank, process_count=2, worker_mode="thread",
                         collate_fn=list))
    try:
        return next(it) + next(it)
    finally:
        it.close()


def test_thread_mode_ranks_draw_their_own_stream():
    """train_main's seeding gives each rank its own PoseJitter draws; rank
    0's are those of the parent's seeding (random and numpy seeded with
    --seed on every rank), under which rank 1 drew rank 0's stream."""
    def parent():
        random.seed(0)
        np.random.seed(0)

    ranks = [_rank_draws(r, lambda r=r: cli.seed_pipeline_rngs(0, r)) for r in (0, 1)]
    before = [_rank_draws(r, parent) for r in (0, 1)]
    assert [s[0] for s in ranks[0]] != [s[0] for s in ranks[1]]  # the shards
    for (_, r0, t0), (_, r1, t1) in zip(ranks[0], ranks[1]):
        assert np.abs(t0 - t1).max() > 1e-3 and np.abs(r0 - r1).max() > 1e-4
    for got, want in zip(ranks[0], before[0]):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    for (_, _, t0), (_, _, t1) in zip(before[0], before[1]):  # the fault
        np.testing.assert_array_equal(t0, t1)


# --- (b) the synthetic BOP set ---------------------------------------------


@pytest.mark.parametrize("render", [False, True], ids=["noise", "rendered"])
@pytest.mark.parametrize("num_class", [2, 5], ids=["line", "grid"])
def test_synthetic_bop_matches_the_jax_helper(tmp_path, render, num_class):
    """Every JSON file, the image list and the .ply bytes equal; the noise
    frames and their disc masks bit-exact (fill_circle for cv2.circle).
    The rendered frames come from both packages' 'xla' raster formula; its
    documented bound (ROADMAP §3: the coverage formulas flip at most 1e-5 of
    the pixels) is held on the masks, and the frames within one level
    where both cover a pixel."""
    j_info = j_build_synthetic_bop(tmp_path / "jax", num_images=2, num_class=num_class,
                                   render_images=render, seed=3)
    p_info = build_synthetic_bop(tmp_path / "port", num_images=2, num_class=num_class,
                                 render_images=render, seed=3, device="cpu")
    assert p_info["diameters"] == j_info["diameters"]
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    pixels = flips = 0
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.suffix != ".png":
            assert a.read_bytes() == b.read_bytes(), rel
            continue
        x, y = imread(str(a), "unchanged"), imread(str(b), "unchanged")
        if not render:
            np.testing.assert_array_equal(x, y, err_msg=str(rel))
        elif "mask" in rel.parts[-2]:
            pixels += x.size
            flips += int((x != y).sum())
        else:
            assert np.abs(x.astype(int) - y.astype(int)).max() <= 1, rel
    assert flips <= 1e-5 * pixels


@pytest.mark.parametrize("radius", [0, 1, 18, 40])
def test_fill_circle_is_cv2_circle(radius):
    rng = np.random.default_rng(radius)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(5, 90, 2))
        c = (int(rng.integers(-45, w + 45)), int(rng.integers(-45, h + 45)))
        want = np.zeros((h, w), np.uint8)
        cv2.circle(want, c, radius, 255, -1)
        np.testing.assert_array_equal(fill_circle(np.zeros((h, w), np.uint8), c, radius, 255),
                                      want)


# --- (c) the learning check ------------------------------------------------

J_BANK = j_bank(oc.NCLASS, kind="cube", size=80.0, subdivisions=2)  # numpy


@pytest.fixture(scope="module")
def j_ra():
    return jsystem.RenderAssets.from_bank(J_BANK)


def j_make_batch(j_ra, seed, batch=oc.BATCH, image=oc.H):
    """tools/overfit_check.py's make_batch, its camera scaled to `image`."""
    r = np.random.default_rng(seed)
    gt_R = Rotation.random(batch, seed).as_matrix().astype(np.float32)
    gt_t = np.stack([r.normal(size=batch) * 15, r.normal(size=batch) * 15,
                     r.uniform(550, 700, batch)], -1).astype(np.float32)
    dR = Rotation.from_euler("xyz", r.normal(size=(batch, 3)) * 8,
                             degrees=True).as_matrix().astype(np.float32)
    ref_R = np.einsum("nij,njk->nik", dR, gt_R)
    ref_t = gt_t + r.normal(size=(batch, 3)).astype(np.float32) * np.array([6, 6, 18],
                                                                            np.float32)
    f, c = 280.0 * image / 128, image / 2
    K = np.tile(np.array([[[f, 0, c], [0, f, c], [0, 0, 1]]], np.float32), (batch, 1, 1))
    labels = r.integers(0, oc.NCLASS, batch).astype(np.int32)
    real, _, gtm = jsystem.render_and_normalize(
        j_ra, jnp.asarray(gt_R), jnp.asarray(gt_t), jnp.asarray(K), jnp.asarray(labels),
        (image, image), (0., 0., 0.), (255.,) * 3)
    return dict(real_images=np.array(real), ref_rotations=ref_R, ref_translations=ref_t,
                gt_rotations=gt_R, gt_translations=gt_t, labels=labels, k=K,
                gt_masks=np.array(gtm))


def j_add_err(R, t, gt_R, gt_t, labels):
    """tools/overfit_check.py's add_err."""
    pts = J_BANK.verts[labels]
    valid = J_BANK.vert_valid[labels]
    a = np.einsum("nij,nvj->nvi", np.asarray(R), pts) + np.asarray(t)[:, None]
    b = np.einsum("nij,nvj->nvi", gt_R, pts) + gt_t[:, None]
    d = np.linalg.norm(a - b, axis=-1)
    d = (d * valid).sum(1) / valid.sum(1)
    return d / J_BANK.diameters[labels]


def test_overfit_batch_and_add_match_the_jax_tool(j_ra):
    """make_batch(7) at the tool's size (8 x 128^2): the poses, labels and
    camera equal, the real images and masks from the same 'xla' formula
    (coverage flips on at most 1e-5 of the pixels, colours within 1e-5
    elsewhere); add_err equal on the batch's reference poses (the tool's
    'init ADD/d', 0.179 on the v5e) and on random poses."""
    want = j_make_batch(j_ra, 7)
    bank = oc.make_bank()
    for f in ("verts", "vert_valid", "diameters", "faces"):
        np.testing.assert_array_equal(getattr(bank, f), getattr(J_BANK, f))
    got = {k: v.numpy() for k, v in
           oc.make_batch(7, RenderAssets.from_bank(bank, device="cpu")).items()}
    for k in ("ref_rotations", "ref_translations", "gt_rotations", "gt_translations", "k"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    flips = got["gt_masks"] != want["gt_masks"]
    assert flips.mean() <= 1e-5
    both = ~flips[..., None].repeat(3, -1)
    np.testing.assert_allclose(got["real_images"][both], want["real_images"][both], atol=1e-5)
    args = [want[k] for k in ("ref_rotations", "ref_translations", "gt_rotations",
                              "gt_translations", "labels")]
    a0 = oc.add_err(bank, *args)
    np.testing.assert_allclose(a0, j_add_err(*args), rtol=1e-12)
    assert 0.1 < a0.mean() < 0.3  # the injected pose noise
    rng = np.random.default_rng(1)
    R = Rotation.random(8, 2).as_matrix().astype(np.float32)
    t = rng.normal(size=(8, 3)).astype(np.float32) * 50 + 600
    np.testing.assert_allclose(oc.add_err(bank, R, t, *args[2:]), j_add_err(R, t, *args[2:]),
                               rtol=1e-12)


N_SMALL, H_SMALL, ITERS_SMALL, STEPS = 2, 64, 2, 3


@pytest.fixture(scope="module")
def small(j_ra):
    """The flax refiner of the tool (detach_depth_for_xy, a 3-class head)
    at 64^2 and 2 iterations with the port's make_model weights (PyTorch's
    initialisation, carried to flax by the JAX package's converter into a
    template of init's shapes: nothing compiled), the port's weights read
    back through convert.state_dict_from_flax, and the tool's batch at that
    size."""
    import jax
    from flax.core import unfreeze

    from scflow_tpu.refiners import SCFlowRefiner as FlaxRefiner
    from scflow_tpu.runtime.convert_torch import convert_state_dict_to_variables

    fmodel = FlaxRefiner(iters=ITERS_SMALL, detach_depth_for_xy=True, pose_head_cfg=dict(
        type="MultiClassPoseHead", num_class=oc.NCLASS, in_channels=224))
    batch = j_make_batch(j_ra, 7, N_SMALL, H_SMALL)
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = unfreeze(jax.eval_shape(
        fmodel.init, jax.random.PRNGKey(0), j["real_images"], j["real_images"],
        j["ref_rotations"], j["ref_translations"], jnp.zeros((N_SMALL, H_SMALL, H_SMALL)),
        j["k"], j["labels"]))
    sd = {k: v.numpy() for k, v in oc.make_model(H_SMALL, ITERS_SMALL).state_dict().items()}
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), unfreeze(
        convert_state_dict_to_variables(sd, shapes)))
    return dict(fmodel=fmodel, variables=variables, batch=batch, j_ra=j_ra,
                sd=state_dict_from_flax(variables))


def _interpret_lookup(monkeypatch):
    """The JAX pallas lookup calls its kernel with interpret=False, which
    the CPU cannot run."""
    orig = jcl.corr_lookup_pallas_flat

    def interpret(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(jcl, "corr_lookup_pallas_flat", interpret)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_overfit_steps_match_jax(small, backend, monkeypatch):
    """3 steps of the tool's recipe (AdamW 4e-4, wd 1e-4, clip 10, the
    default train step) from the same weights on the same batch: the
    losses step by step (the module docstring's bounds)."""
    if backend == "pallas":
        _interpret_lookup(monkeypatch)
    la = jsystem.LossAssets(jnp.asarray(J_BANK.verts), jnp.asarray(J_BANK.vert_valid),
                            sym_mask_from_types({}, oc.NCLASS),
                            jnp.asarray(J_BANK.diameters))
    tx, _ = j_build_optimizer(dict(oc.OPTIMIZER), None, oc.GRAD_CLIP)
    jstate = JTrainState.create(small["variables"]["params"], tx,
                                small["variables"]["batch_stats"])
    jstep = jsystem.make_scflow_train_step(small["fmodel"], small["j_ra"], la,
                                           image_size=(H_SMALL, H_SMALL), lookup_backend=backend)
    want = []
    for _ in range(STEPS):
        jstate, logs = jstep(jstate, {k: jnp.asarray(v) for k, v in small["batch"].items()})
        want.append(float(logs["loss"]))

    bank = oc.make_bank()
    model = oc.make_model(H_SMALL, ITERS_SMALL)
    model.load_state_dict(small["sd"], strict=True)
    txp, _ = build_optimizer(model, dict(oc.OPTIMIZER), None, oc.GRAD_CLIP)
    state = TrainState(model, txp)
    step = make_scflow_train_step(model, RenderAssets.from_bank(bank, device="cpu"),
                                  loss_assets_from_bank(bank, {}, device="cpu"),
                                  image_size=(H_SMALL, H_SMALL), lookup_backend=backend,
                                  device="cpu")
    got = []
    for _ in range(STEPS):
        state, logs = step(state, small["batch"])
        got.append(float(logs["loss"]))
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_overfit_run_learns_on_the_cpu():
    """run() for 20 steps at 64^2, batch 2, 2 iterations: finite losses, the
    last 5 below the first 5 on average, two evaluations, and the batch's
    ADD/d after 20 steps below the initial one."""
    lines = []
    res = oc.run(steps=20, every=10, device="cpu", image=64, batch_size=2, iters=2,
                 log=lines.append)
    losses = np.asarray(res["losses"])
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    assert [p["step"] for p in res["curve"]] == [10, 20]
    assert res["curve"][-1]["add"] < res["init"]
    assert lines[0] == f"init ADD/d {res['init']:.4f}"
    assert lines[-1].startswith("step 20: pose ") and "| train-batch ADD " in lines[-1]
