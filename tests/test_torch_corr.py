"""The port's correlation pyramid and corr lookup against the JAX package.

The lookup's plain version (what a CPU tensor runs) is held against the TPU
kernel itself, `corr_lookup_pallas` in interpret mode (variant 'tent').  The
two sum the bilinear taps in another order, so atol is 1e-4, the bound
tests/test_ops.py::test_pallas_lookup_matches_xla uses between the Pallas
and XLA lookups.  The CUDA kernel is compared with the plain version in
tests/test_torch_kernels.py, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.ops.corr import correlation_pyramid_flat as j_pyramid
from scflow_tpu.ops.pallas.corr_lookup import corr_lookup_pallas
from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat

from torch_port_helpers import no_tf32  # noqa: F401

ATOL = 1e-4


def _levels(rng, rows, sizes):
    return [rng.normal(size=(rows, s * s)).astype(np.float32) for s in sizes]


def _jax_lookup(levels, flow):
    out = corr_lookup_pallas([jnp.asarray(m) for m in levels], jnp.asarray(flow),
                             radius=4, interpret=True, variant="tent")
    return np.asarray(out)


def _cases(rng):
    """name -> (levels, flow (N, h, w, 2))."""
    n, h = 3, 10  # 300 rows: not a multiple of the TPU kernel's 256-row block
    random = (_levels(rng, n * h * h, (10, 5, 3, 2)),
              (3.0 * rng.normal(size=(n, h, h, 2))).astype(np.float32))
    # windows that straddle the border, and some wholly outside the map
    border = (_levels(rng, 2 * 64, (8, 4, 2, 1)),
              rng.uniform(-14, 14, (2, 8, 8, 2)).astype(np.float32))
    # exactly integer centres: every fractional weight is 0
    integer = (_levels(rng, 2 * 64, (8, 4, 2, 1)),
               rng.integers(-6, 7, (2, 8, 8, 2)).astype(np.float32))
    return {"random": random, "border": border, "integer": integer}


def test_correlation_pyramid_flat(rng, no_tf32):
    f1 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    want = j_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = correlation_pyramid_flat(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    assert [tuple(g.shape) for g in got] == [(512, 256), (512, 64), (512, 16), (512, 4)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_plain_lookup_matches_pallas_kernel(case, rng, no_tf32):
    levels, flow = _cases(rng)[case]
    got = corr_lookup([torch.from_numpy(m) for m in levels], torch.from_numpy(flow))
    want = _jax_lookup(levels, flow)
    assert got.shape == want.shape == flow.shape[:3] + (len(levels) * 81,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_lookup_tap_order():
    """A one-hot level-0 map: the peak at (x + dx, y + dy) must land in
    channel (dx + 4) * 9 + (dy + 4), since j offsets x (the order the motion
    encoder's first conv was trained on)."""
    h = 8
    levels = [np.zeros((h * h, s * s), np.float32) for s in (8, 4, 2, 1)]
    y0, x0, dx, dy = 4, 3, 2, -3
    b = y0 * h + x0
    levels[0][b, (y0 + dy) * h + (x0 + dx)] = 1.0
    flow = np.zeros((1, h, h, 2), np.float32)
    got = corr_lookup([torch.from_numpy(m) for m in levels],
                      torch.from_numpy(flow)).numpy().reshape(h * h, -1)
    want = _jax_lookup(levels, flow).reshape(h * h, -1)
    channel = (dx + 4) * 9 + (dy + 4)
    for out in (got, want):
        assert out[b, channel] == 1.0
        assert np.count_nonzero(out) == 1
