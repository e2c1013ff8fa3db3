"""The port's correlation pyramid and corr lookup against the JAX package.

The lookup's plain version (what a CPU tensor runs) is held against the TPU
kernel itself, `corr_lookup_pallas` in interpret mode (variant 'tent').  The
two sum the bilinear taps in another order, so atol is 1e-4, the bound
tests/test_ops.py::test_pallas_lookup_matches_xla uses between the Pallas
and XLA lookups.  The CUDA kernel is compared with the plain version in
tests/test_torch_kernels.py, on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu.ops.corr import corr_lookup as j_corr_lookup
from scflow_tpu.ops.corr import correlation_pyramid_flat as j_pyramid
from scflow_tpu.ops.pallas.corr_lookup import corr_lookup_pallas, corr_lookup_pallas_diff
from scflow_tpu_torch.ops.corr import corr_lookup, correlation_pyramid_flat

from torch_port_helpers import keep_torch_rng, no_tf32  # noqa: F401

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


@pytest.mark.parametrize("variant", ["shift", "bdiag"])
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_variant_plain_versions_match_pallas_kernels(variant, case, rng):
    """The plain versions of K7 (shift) and K8 (bdiag) against the TPU
    kernels of the same variant in interpret mode.  atol 1e-4 as for tent:
    XLA's CPU code may contract the blends' a*b + c into FMAs."""
    levels, flow = _cases(rng)[case]
    got = corr_lookup([torch.from_numpy(m) for m in levels], torch.from_numpy(flow),
                      backend="pallas", variant=variant)
    want = np.asarray(corr_lookup_pallas([jnp.asarray(m) for m in levels], jnp.asarray(flow),
                                         radius=4, interpret=True, variant=variant))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("radius,n_levels", [(1, 1), (1, 2), (3, 1), (3, 2), (6, 4), (0, 3)])
@pytest.mark.parametrize("variant", ["shift", "bdiag"])
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_variant_plain_versions_match_pallas_kernels_at_other_windows(radius, n_levels,
                                                                      variant, case, rng):
    """As above at other radii and level counts: K7 and K8 take the radius
    as a compile-time window, and their plain versions are what the card
    holds them to at each of those windows."""
    levels, flow = _cases(rng)[case]
    levels = levels[:n_levels]
    got = corr_lookup([torch.from_numpy(m) for m in levels], torch.from_numpy(flow),
                      radius=radius, backend="pallas", variant=variant)
    want = np.asarray(corr_lookup_pallas([jnp.asarray(m) for m in levels], jnp.asarray(flow),
                                         radius=radius, interpret=True, variant=variant))
    assert got.shape == want.shape == flow.shape[:3] + (n_levels * (2 * radius + 1) ** 2,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("radius", [13, 14, 15])
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_tent_plain_version_matches_pallas_kernel_at_the_widest_windows(radius, case, rng):
    """K1 builds radius 0-15 (radius 13-15 only at one level fit the first
    K1's thread limit and still do); its plain version, what the card
    holds it to, against the TPU's tent kernel at those windows."""
    levels, flow = _cases(rng)[case]
    got = corr_lookup([torch.from_numpy(levels[0])], torch.from_numpy(flow), radius=radius,
                      backend="pallas")
    want = np.asarray(corr_lookup_pallas([jnp.asarray(levels[0])], jnp.asarray(flow),
                                         radius=radius, interpret=True, variant="tent"))
    assert got.shape == want.shape == flow.shape[:3] + ((2 * radius + 1) ** 2,)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _torch_vjp(levels, flow, g, backend, radius=4):
    lv = [torch.from_numpy(m).requires_grad_() for m in levels]
    fl = torch.from_numpy(flow).requires_grad_()
    out = corr_lookup(lv, fl, radius=radius, backend=backend)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [m.grad.numpy() for m in lv], fl.grad.numpy()


@pytest.mark.parametrize("radius,n_levels", [(4, 4), (1, 1), (1, 2), (3, 2), (6, 4), (0, 3),
                                             (13, 1), (14, 1), (15, 1)])
@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_pallas_backend_grads_match_lookup_bwd(case, radius, n_levels, rng):
    """'pallas' (K1b's plain version on the CPU) against jax.vjp of
    corr_lookup_pallas_diff, whose backward is `_lookup_bwd`: grads into
    every level and into the flow, 0 at integer centres, at the flagship's
    window (radius 4, 4 levels) and at others K1b builds (its radius is a
    compile-time window, and this plain version is what the card holds it
    to at each).  atol 1e-4 on O(1) gradients, the lookup's own bound; the
    sums run in another order."""
    levels, flow = _cases(rng)[case]
    levels = levels[:n_levels]
    n, h, w, _ = flow.shape
    g = rng.normal(size=(n, h, w, n_levels * (2 * radius + 1) ** 2)).astype(np.float32)
    gp_j, gf_j = jax.vjp(
        lambda p, f: corr_lookup_pallas_diff(p, f, radius, 256, True, "tent"),
        tuple(jnp.asarray(m) for m in levels), jnp.asarray(flow))[1](jnp.asarray(g))
    _, gp_t, gf_t = _torch_vjp(levels, flow, g, "pallas", radius)
    for a, b in zip(gp_t, gp_j):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(gf_t, np.asarray(gf_j), atol=1e-4)


@pytest.mark.parametrize("case", ["random", "border", "integer"])
def test_xla_backend_grads_match_jax_autodiff(case, rng):
    """'xla' against jax.vjp of scflow_tpu.ops.corr.corr_lookup (JAX's
    autodiff of the tent form): at integer centres its subgradient is not
    0, and the port's must follow it."""
    levels, flow = _cases(rng)[case]
    n, h, w, _ = flow.shape
    g = rng.normal(size=(n, h, w, 4 * 81)).astype(np.float32)
    sizes = [int(round(m.shape[1] ** 0.5)) for m in levels]
    j_levels = tuple(jnp.asarray(m).reshape(-1, s, s, 1) for m, s in zip(levels, sizes))
    out_j, vjp = jax.vjp(lambda p, f: j_corr_lookup(list(p), f, 4), j_levels, jnp.asarray(flow))
    gp_j, gf_j = vjp(jnp.asarray(g))
    out_t, gp_t, gf_t = _torch_vjp(levels, flow, g, "xla")
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=ATOL)
    for a, b in zip(gp_t, gp_j):
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape), atol=1e-4)
    np.testing.assert_allclose(gf_t, np.asarray(gf_j), atol=1e-4)


def test_flow_subgradients_at_integer_centres(rng):
    """One level, integer centres: every tent weight sits on a kink.
    `_lookup_bwd` (and so 'pallas') gives the flow 0 there; JAX's autodiff
    of the tent form (and so 'xla') does not."""
    levels = _levels(rng, 2 * 64, (8,))
    flow = rng.integers(-6, 7, (2, 8, 8, 2)).astype(np.float32)
    g = rng.normal(size=(2, 8, 8, 81)).astype(np.float32)
    _, _, gf_pallas = _torch_vjp(levels, flow, g, "pallas")
    _, _, gf_xla = _torch_vjp(levels, flow, g, "xla")
    _, gf_j = jax.vjp(lambda p, f: corr_lookup_pallas_diff(p, f, 4, 256, True, "tent"),
                      (jnp.asarray(levels[0]),), jnp.asarray(flow))[1](jnp.asarray(g))
    assert (np.asarray(gf_j) == 0).all() and (gf_pallas == 0).all()
    _, gf_j = jax.vjp(lambda m, f: j_corr_lookup([m], f, 4),
                      jnp.asarray(levels[0]).reshape(-1, 8, 8, 1), jnp.asarray(flow))[1](
                          jnp.asarray(g))
    assert np.abs(np.asarray(gf_j)).max() > 0.1
    np.testing.assert_allclose(gf_xla, np.asarray(gf_j), atol=1e-4)


def test_flow_grad_is_skipped_for_a_detached_flow(rng):
    levels, flow = _cases(rng)["random"]
    lv = [torch.from_numpy(m).requires_grad_() for m in levels]
    out = corr_lookup(lv, torch.from_numpy(flow), backend="pallas")
    out.sum().backward()
    assert all(m.grad is not None for m in lv)


@pytest.mark.parametrize("backend,variant", [("pallas", "tri"), ("xla", "shift"),
                                             ("xla", "bdiag"), ("auto", "Tent")])
def test_lookup_rejects_unknown_or_meaningless_variants(backend, variant):
    levels = [torch.zeros((4, s * s)) for s in (2, 1)]
    with pytest.raises(ValueError, match="variant"):
        corr_lookup(levels, torch.zeros((1, 2, 2, 2)), backend=backend, variant=variant)


def test_lookup_rejects_unknown_backend():
    levels = [torch.zeros((4, s * s)) for s in (2, 1)]
    with pytest.raises(ValueError, match="unknown backend"):
        corr_lookup(levels, torch.zeros((1, 2, 2, 2)), backend="triton")
