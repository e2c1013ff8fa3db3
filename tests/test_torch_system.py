"""The port's render_and_normalize against the JAX package's, called with
the same positional arguments (the JAX order: image_size, norm_mean,
norm_std, chunk, backend, augment_fn, augment_key, cull_backfaces).

Both render on the brute-force path ('xla'), where XLA's CPU code contracts
a*b + c into an FMA and the port does not: masks agree on all but 2e-3 of
the pixels, and where both cover a pixel, depth to 1e-3 and images to 1e-3
(times 1/std) on all but 2e-3 of the pixels, the bounds of
tests/test_torch_render.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.refiners import system as jsystem
from scflow_tpu.render.meshbank import make_synthetic_bank as j_bank
from scflow_tpu_torch.refiners.system import RenderAssets, render_and_normalize
from scflow_tpu_torch.render.meshbank import make_synthetic_bank

from torch_port_helpers import keep_torch_rng  # noqa: F401

N, IMG, NCLASS = 2, 64, 3
MEAN, STD = (10.0, 20.0, 30.0), (50.0, 60.0, 70.0)


def _pose():
    from scipy.spatial.transform import Rotation

    R = np.stack([Rotation.random(random_state=20 + i).as_matrix()
                  for i in range(N)]).astype(np.float32)
    t = np.array([[3.0, -2.0, 400.0], [-4.0, 5.0, 430.0]], np.float32)
    K = np.tile(np.array([[[120.0, 0, IMG / 2], [0, 120.0, IMG / 2], [0, 0, 1]]], np.float32),
                (N, 1, 1))
    return R, t, K, np.array([0, 2], np.int32)


@pytest.mark.parametrize("cull", [False, True])
def test_render_and_normalize_takes_the_jax_positional_order(cull):
    R, t, K, labels = _pose()
    jb = j_bank(NCLASS)
    want = jsystem.render_and_normalize(
        jsystem.RenderAssets.from_bank(jb), jnp.asarray(R), jnp.asarray(t), jnp.asarray(K),
        jnp.asarray(labels), (IMG, IMG), MEAN, STD, 16, "xla", None, None, cull)
    got = render_and_normalize(
        RenderAssets.from_bank(make_synthetic_bank(NCLASS), device="cpu"), torch.from_numpy(R),
        torch.from_numpy(t), torch.from_numpy(K), torch.from_numpy(labels).long(), (IMG, IMG),
        MEAN, STD, 16, "xla", None, None, cull)
    images, depths, masks = (np.asarray(a) for a in want)
    g_images, g_depths, g_masks = (a.numpy() for a in got)
    assert masks.mean() > 0.05 and g_images.shape == images.shape
    assert (g_masks != masks).mean() < 2e-3
    both = (g_masks > 0) & (masks > 0)
    np.testing.assert_allclose(g_depths[both], depths[both], atol=1e-3)
    # normalised by std/255 = 0.2-0.27: image differences scale by up to 5.1
    assert (np.abs(g_images - images).max(-1) > 1e-3 * 255.0 / min(STD)).mean() < 2e-3
    # the positional norms took effect: (image - mean/255) / (std/255) of
    # the render with the default norms (mean 0, std 255)
    raw = render_and_normalize(
        RenderAssets.from_bank(make_synthetic_bank(NCLASS), device="cpu"), torch.from_numpy(R),
        torch.from_numpy(t), torch.from_numpy(K), torch.from_numpy(labels).long(), (IMG, IMG),
        chunk=16, backend="xla", cull_backfaces=cull)[0].numpy()
    mean, std = np.array(MEAN, np.float32) / 255, np.array(STD, np.float32) / 255
    np.testing.assert_allclose(g_images, (raw - mean) / std, rtol=1e-6, atol=1e-6)


def test_render_and_normalize_refuses_render_augmentations():
    R, t, K, labels = _pose()
    assets = RenderAssets.from_bank(make_synthetic_bank(NCLASS), device="cpu")
    args = (assets, torch.from_numpy(R), torch.from_numpy(t), torch.from_numpy(K),
            torch.from_numpy(labels).long(), (IMG, IMG))
    with pytest.raises(NotImplementedError, match="augmentations"):
        render_and_normalize(*args, augment_fn=lambda key, images: images)
    with pytest.raises(NotImplementedError, match="augmentations"):
        render_and_normalize(*args, MEAN, STD, 16, "xla", None, 0)
