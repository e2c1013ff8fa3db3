"""Cycled inference (the reference's forward_multiple_pass): the port's
make_scflow_cycled_infer_fn against the JAX package's at 64^2, 2 cycles, 3
iterations, slim and not slim, on flax weights carried across by
convert.state_dict_from_flax (the slice tests' pose tolerances: rotations
atol 2e-3; translations rtol 2e-3, atol 2e-2; the full outputs' flow
within 2e-2 px + 5e-3 of its value); make_infer_from_cfg taking
test_cfg.cycles=2 for SCFlow, and raising for a RAFT config, where JAX's
make_infer_from_cfg ignores cycles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu import apis as japis
from scflow_tpu.config import Config as JConfig
from scflow_tpu.refiners import system as jsystem
from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu_torch.apis import make_infer_from_cfg
from scflow_tpu_torch.config import Config
from scflow_tpu_torch.refiners.system import (RenderAssets, make_scflow_cycled_infer_fn,
                                              make_scflow_infer_fn)
from scflow_tpu_torch.render.meshbank import make_synthetic_bank

from torch_port_helpers import keep_torch_rng, no_tf32, scflow_pair  # noqa: F401
from torch_train_helpers import keep_global_rngs, seed_all  # noqa: F401

N, IMG, NCLASS, ITERS, CYCLES = 2, 64, 2, 3, 2
SIZE = 90.0  # mm: the spheres cover a good part of the 64^2 crop


@pytest.fixture(autouse=True)
def seeded():
    seed_all(0)


@pytest.fixture(scope="module")
def models():
    return scflow_pair(NCLASS, IMG, ITERS, perturb=0.05)


@pytest.fixture(scope="module")
def batch():
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(7)
    R = np.stack([Rotation.random(random_state=20 + i).as_matrix()
                  for i in range(N)]).astype(np.float32)
    return dict(
        real_images=(0.2 * rng.normal(size=(N, IMG, IMG, 3))).astype(np.float32),
        ref_rotations=R,
        ref_translations=np.array([[4.0, -3.0, 400.0], [-5.0, 2.0, 380.0]], np.float32),
        k=np.tile(np.array([[[80.0, 0, 32], [0, 80.0, 32], [0, 0, 1]]], np.float32), (N, 1, 1)),
        labels=np.array([0, 1], np.int32),
    )


def _assets():
    return RenderAssets.from_bank(make_synthetic_bank(NCLASS, kind="sphere", size=SIZE,
                                                      subdivisions=2), device="cpu")


def _assert_poses(got, want):
    np.testing.assert_allclose(got["rotations"].numpy(), np.asarray(want["rotations"]),
                               atol=2e-3)
    np.testing.assert_allclose(got["translations"].numpy(), np.asarray(want["translations"]),
                               rtol=2e-3, atol=2e-2)


@pytest.mark.parametrize("slim", [True, False], ids=["slim", "full"])
def test_cycled_infer_matches_jax(models, batch, slim, no_tf32):
    fmodel, variables, port = models
    j_infer = jsystem.make_scflow_cycled_infer_fn(
        fmodel, jsystem.RenderAssets.from_bank(j_bank(NCLASS, kind="sphere", size=SIZE,
                                                      subdivisions=2)),
        cycles=CYCLES, image_size=(IMG, IMG), render_backend="xla", lookup_backend="xla",
        slim=slim)
    want = j_infer(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    infer = make_scflow_cycled_infer_fn(port, _assets(), CYCLES, image_size=(IMG, IMG),
                                        render_backend="xla", lookup_backend="xla", slim=slim,
                                        device="cpu")
    got = infer(batch)
    assert set(got) == set(want)
    _assert_poses(got, want)
    once = make_scflow_infer_fn(port, _assets(), image_size=(IMG, IMG), slim=True,
                                device="cpu")(batch)
    # the second cycle moved the pose on from the first's
    assert np.abs(got["translations"].numpy() - once["translations"].numpy()).max() > 1e-2
    if not slim:
        assert got["masks"].shape == (N, IMG, IMG) and got["flow"].shape == (N, IMG, IMG, 2)
        np.testing.assert_allclose(got["masks"].numpy(), np.asarray(want["masks"]), atol=2e-3)
        # the one-pass test's flow bound, plus a relative part: the last cycle
        # renders at the pose the first gives, which the packages give within
        # the pose tolerances above
        np.testing.assert_allclose(got["flow"].numpy(), np.asarray(want["flow"]), atol=2e-2,
                                   rtol=5e-3)


def test_cycles_one_is_the_one_pass_call(models, batch):
    _, _, port = models
    a = make_scflow_cycled_infer_fn(port, _assets(), 1, image_size=(IMG, IMG), slim=True,
                                    device="cpu")(batch)
    b = make_scflow_infer_fn(port, _assets(), image_size=(IMG, IMG), slim=True,
                             device="cpu")(batch)
    assert all(torch.equal(a[k], b[k]) for k in b)
    with pytest.raises(ValueError, match="cycles"):
        make_scflow_cycled_infer_fn(port, _assets(), 0, device="cpu")


def _cfg(tmp_path, config, model_type: str, cycles: int):
    path = tmp_path / f"{model_type}_{cycles}.py"
    path.write_text(f"model = dict(type={model_type!r}, test_cfg=dict(cycles={cycles}, "
                    f"iters={ITERS}), renderer=dict(cull_backfaces=False))\n")
    return config.fromfile(str(path))


def test_make_infer_from_cfg_takes_cycles(models, batch, tmp_path):
    """SCFlow with cycles=2 is the cycled call on the one-cycle path's
    backends ('pallas' render and lookup on a square image)."""
    _, _, port = models
    infer, pose_fn = make_infer_from_cfg(_cfg(tmp_path, Config, "SCFlowRefiner", CYCLES), port,
                                         _assets(), (IMG, IMG), slim=True, device="cpu")
    assert pose_fn is None
    want = make_scflow_cycled_infer_fn(port, _assets(), CYCLES, image_size=(IMG, IMG),
                                       iters=ITERS, render_backend="pallas",
                                       lookup_backend="pallas", slim=True, device="cpu")(batch)
    got = infer(batch)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_raft_cycles_raise_where_jax_ignores_them(tmp_path):
    jinfer, _ = japis.make_infer_from_cfg(_cfg(tmp_path, JConfig, "RAFTRefinerFlowMask", 2),
                                          None, None, (IMG, IMG))
    assert callable(jinfer)  # JAX builds its one-pass RAFT call: cycles unread
    with pytest.raises(ValueError, match="cycles=2 on a RAFT config"):
        make_infer_from_cfg(_cfg(tmp_path, Config, "RAFTRefinerFlowMask", 2), None, None,
                            (IMG, IMG), device="cpu")
