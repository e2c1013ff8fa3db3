"""The port's RAFT decoder and refiners (models/raft_decoder.py,
refiners/raft.py) and the weight bridge on RAFT variables, against the JAX
package on the same inputs, at 64^2, 2-3 iterations, batch 2, with flax's
initialisation carried across by convert.state_dict_from_flax.

fp32 bounds: the flow within 1e-4 px + 1e-4 of its scale, the occlusion
within 1e-5 (the two packages' float32 convolutions sum in different
orders; the flows of these weights reach a few px).  bf16: within twice
JAX's own bf16-to-fp32 distance on the same inputs plus the fp32 bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scflow_tpu_torch.convert import state_dict_from_flax

from torch_port_helpers import (keep_torch_rng, lecun_variables, load_port,  # noqa: F401
                                no_tf32, raft_pair)

IMG, N, ITERS = 64, 2, 2


def _images(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, IMG, IMG, 3)).astype(np.float32) for _ in range(2))


def _jax_apply(fmodel, variables, *images, **kw):
    f = jax.jit(fmodel.apply, static_argnames=("lookup_backend", "train", "iters"))
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in
            f(variables, *(jnp.asarray(a) for a in images), **kw).items()}


@pytest.fixture(scope="module")
def shared_run(mask_pair):
    """JAX's output of the shared-encoder mask model on one pair of batches
    (computed once for the tests that compare against it)."""
    render, real = _images(1)
    fmodel, variables, _ = mask_pair
    return render, real, _jax_apply(fmodel, variables, render, real, lookup_backend="xla")


def _close(got, want, what=""):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k].float().numpy()
        assert g.shape == w.shape, (what, k)
        atol = 1e-4 + 1e-4 * np.abs(w).max() if k == "flow" else 1e-5
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def mask_pair():
    return raft_pair(IMG, ITERS)


@pytest.mark.parametrize("mask,convex", [(True, True), (False, False)])
def test_decoder_matches_jax(mask, convex, no_tf32):
    """RAFTDecoderMask with convex upsampling, and RAFTDecoder without it
    (bilinear, align_corners=True, and no mask head, as flax creates none),
    alone on random features and a nonzero warm start; the flax variables
    load strictly into the port's decoder."""
    from scflow_tpu.models.raft_decoder import RAFTDecoder as FDecoder
    from scflow_tpu_torch.models.raft_decoder import RAFTDecoder, RAFTDecoderMask

    h = IMG // 8
    rng = np.random.default_rng(1)
    f1, f2 = (rng.normal(size=(N, h, h, 256)).astype(np.float32) for _ in range(2))
    flow = rng.normal(size=(N, h, h, 2)).astype(np.float32)
    hf = np.tanh(rng.normal(size=(N, h, h, 128))).astype(np.float32)
    cf = np.maximum(rng.normal(size=(N, h, h, 128)), 0).astype(np.float32)
    fdec = FDecoder(iters=3, predict_occlusion=mask, convex_upsample_flow=convex)
    args = tuple(map(jnp.asarray, (f1, f2, flow, hf, cf)))
    variables = lecun_variables(fdec, 2, *args)
    want = {k: np.asarray(v) for k, v in jax.jit(fdec.apply)(variables, *args).items()}
    cls = RAFTDecoderMask if mask else RAFTDecoder
    with torch.random.fork_rng(devices=[]):
        port = load_port(cls(iters=3, convex_upsample_flow=convex), variables)
    t = {k: torch.from_numpy(v) for k, v in dict(f1=f1, f2=f2, hf=hf, cf=cf).items()}
    with torch.no_grad():
        got = port(t["f1"].permute(0, 3, 1, 2), t["f2"].permute(0, 3, 1, 2),
                   torch.from_numpy(flow), t["hf"].permute(0, 3, 1, 2),
                   t["cf"].permute(0, 3, 1, 2), lookup_backend="xla")
        last = port(t["f1"].permute(0, 3, 1, 2), t["f2"].permute(0, 3, 1, 2),
                    torch.from_numpy(flow), t["hf"].permute(0, 3, 1, 2),
                    t["cf"].permute(0, 3, 1, 2), lookup_backend="xla", output_sequences=False)
    assert got["flow"].shape == (3, N, IMG, IMG, 2)
    _close(got, want)
    for k in got:  # only the last iteration, computed alone, is the same
        assert last[k].shape[0] == 1 and torch.equal(last[k][0], got[k][-1]), k


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_refiner_flow_mask_matches_jax(mask_pair, shared_run, backend, no_tf32):
    """RAFTRefinerFlowMask with the shared encoder, on the lookup's tensor
    form ('xla') and the kernels' plain versions ('pallas', the same
    function), against JAX's 'xla'.  The separate encoder:
    test_state_dict_from_flax_carries_a_separate_encoder."""
    render, real, want = shared_run
    with torch.no_grad():
        got = mask_pair[2](torch.from_numpy(render), torch.from_numpy(real),
                           lookup_backend=backend)
    assert set(got) == {"flow", "occlusion"} and got["flow"].shape == (ITERS, N, IMG, IMG, 2)
    assert np.abs(want["flow"]).max() > 0.1  # the flow moved
    _close(got, want, backend)


def test_refiner_flow_only_matches_jax(no_tf32):
    """RAFTRefinerFlow: flow only, no occlusion head or output."""
    fmodel, variables, port = raft_pair(IMG, ITERS, seed=4, mask=False)
    assert not any(k.startswith("decoder.occlusion_pred") for k in port.state_dict())
    render, real = _images(2)
    want = _jax_apply(fmodel, variables, render, real, lookup_backend="xla")
    with torch.no_grad():
        got = port(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="xla")
    _close(got, want, "flow only")


@pytest.mark.parametrize("side", ["render", "real"])
def test_refiner_broadcasts_an_unbatched_image(mask_pair, side, no_tf32):
    """An (H, W, 3) image on one side is encoded once and expanded over the
    other side's views, as in JAX (raft.py:80-105)."""
    fmodel, variables, port = mask_pair
    render, real = _images(3, n=3)
    if side == "render":
        render = render[0]
    else:
        real = real[0]
    want = _jax_apply(fmodel, variables, render, real, lookup_backend="xla")
    with torch.no_grad():
        got = port(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="xla")
    assert got["flow"].shape[1] == 3
    _close(got, want, side)


@pytest.mark.parametrize("norms", [dict(), dict(encoder_norm="BN", cxt_norm="IN")])
def test_state_dict_from_flax_carries_a_separate_encoder(norms, no_tf32):
    """seperate_encoder=True: real_encoder takes the feature encoders' norm
    (render_encoder's), not the context's, so the state dict loads strictly
    and the forward equals JAX's; also with the norms the other way round
    (BatchNorm feature encoders, whose running statistics carry across)."""
    fmodel, variables, port = raft_pair(IMG, ITERS, seed=5, seperate_encoder=True, **norms)
    sd = state_dict_from_flax(variables, **norms)
    assert set(sd) == set(port.state_dict())
    if norms:
        assert "real_encoder.bn1.running_mean" in sd
        assert not any(k.startswith("context.") and ".bn" in k for k in sd)
    render, real = _images(4)
    want = _jax_apply(fmodel, variables, render, real, lookup_backend="xla")
    with torch.no_grad():
        got = port(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="xla")
    _close(got, want, str(norms))


def test_refiner_bf16_matches_jax_bf16(mask_pair, shared_run, no_tf32):
    """dtype=bfloat16 on the same weights: flow float32 and occlusion bf16
    as in JAX; each within twice JAX's bf16-to-fp32 distance (plus the fp32
    bound) of JAX's bf16 output; float32 parameters."""
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask

    fmodel, variables, port = mask_pair
    with torch.random.fork_rng(devices=[]):
        port16 = RAFTRefinerFlowMask(iters=ITERS, dtype=torch.bfloat16)
    port16.load_state_dict(port.state_dict(), strict=True)
    port16.eval()
    assert all(p.dtype == torch.float32 for p in port16.parameters())
    render, real, want32 = shared_run
    f16 = jax.jit(fmodel.clone(dtype=jnp.bfloat16).apply, static_argnames=("lookup_backend",))
    w16 = f16(variables, jnp.asarray(render), jnp.asarray(real), lookup_backend="xla")
    with torch.no_grad():
        got = port16(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="xla")
    assert got["flow"].dtype == torch.float32 and str(w16["flow"].dtype) == "float32"
    assert got["occlusion"].dtype == torch.bfloat16 and str(w16["occlusion"].dtype) == "bfloat16"
    for k in ("flow", "occlusion"):
        w = np.asarray(w16[k].astype(jnp.float32))
        dist = np.abs(w - want32[k]).max()
        assert dist > 0  # bf16 moved JAX's output
        err = np.abs(got[k].float().numpy() - w).max()
        assert err <= 2 * dist + 1e-4 + 1e-4 * np.abs(w).max(), (k, err, dist)


@pytest.mark.parametrize("kw", [dict(net_type="Small"), dict(gru_type="conv"),
                                dict(net_type="Large"), dict(radius=3)])
def test_unported_options_raise(kw):
    """Every option is ported; what raises is each combination
    the JAX package cannot run, or reads as another: the 'Small' net with
    'Basic' h_channels (its GRU gates fail to broadcast), an unknown GRU
    type (JAX's is 'SeqConv' then), 'Large' (no decoder widths: a KeyError)
    and radius 3 with convex upsampling (the mask head's 9 x 64 channels
    do not reshape to 9 x 8^2)."""
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask

    with pytest.raises(ValueError):
        RAFTRefinerFlowMask(**kw)


def test_non_square_maps_raise(mask_pair, no_tf32):
    """Maps that are not square (a 64x128 crop) take the JAX package's own
    route (its 4-D pyramid and XLA lookup) on both backends and match
    JAX's; a lookup variant that names a kernel raises there, since the
    kernels need square maps."""
    fmodel, variables, port = mask_pair
    rng = np.random.default_rng(6)
    render, real = (rng.normal(size=(1, 64, 128, 3)).astype(np.float32) for _ in range(2))
    want = _jax_apply(fmodel, variables, render, real, lookup_backend="pallas")
    with torch.no_grad():
        got = port(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="pallas")
        _close(got, want, "64x128")
        with pytest.raises(ValueError, match="square"):
            port(torch.from_numpy(render), torch.from_numpy(real), lookup_backend="pallas",
                 lookup_variant="shift")
