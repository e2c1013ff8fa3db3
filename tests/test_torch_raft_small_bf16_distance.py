"""How far bf16 moves RAFT-S's flow, in the JAX package and in the port, on
chip_smoke.py's raft_small weights and inputs (its seeded RAFT_SMALL model,
the first samples of its batch-64 call: 256^2, 12 iterations), on the CPU.

    JAX_PLATFORMS=cpu python3 tests/test_torch_raft_small_bf16_distance.py [--samples 64]

The card's raft_small phase prints the port's own bf16-to-fp32 flow
distance over the 64 samples; run as a script, this file prints, as one
JSON line, the max and mean |flow bf16 - flow fp32| (px) of JAX's network
(its 'xla' lookup) and of the port's (its 'xla' lookup, and the 'pallas'
route of the card, K1's plain version here), and the distance between the
two packages' bf16 flows, on the same samples.  The test holds the port's
distance to twice JAX's on 2 samples."""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # run as a script: the package and chip_smoke.py
    sys.path.insert(0, str(ROOT))

from torch_port_helpers import flax_from_port, keep_torch_rng  # noqa: E402,F401


def measure(samples: int) -> dict:
    """The distances above on the first `samples` of the raft_small batch."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from scflow_tpu.refiners import raft as jraft
    from scflow_tpu_torch.refiners.system import RenderAssets, render_and_normalize
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    assets = RenderAssets.from_bank(
        make_synthetic_bank(cs.NCLASS, kind="uvsphere", size=80.0), device="cpu")
    b = {k: torch.as_tensor(v[:samples])
         for k, v in cs.train_batch(assets, cs.BATCH, cs.IMG, seed=2).items()}
    with torch.no_grad():
        render, _, _ = render_and_normalize(
            assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
            (cs.IMG, cs.IMG), backend="pallas", cull_backfaces=True)
    real = b["real_images"]
    port = {dt: cs.raft_model(dt, **cs.RAFT_SMALL).eval() for dt in (None, torch.bfloat16)}
    flows = {}
    with torch.no_grad():
        for dt, m in port.items():
            for lookup in ("xla", "pallas"):
                out = m(render, real, lookup_backend=lookup, output_sequences=False)
                flows[("port", lookup, dt)] = out["flow"][-1].float().numpy()
    fmodel = jraft.RAFTRefinerFlowMask(iters=cs.RAFT_ITERS, **cs.RAFT_SMALL)
    z = jnp.zeros((1, cs.IMG, cs.IMG, 3))
    template = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0), z, z)
    variables = flax_from_port(template, port[None].state_dict(), encoder_norm="IN",
                               cxt_norm=None)
    args = jnp.asarray(render.numpy()), jnp.asarray(real.numpy())
    for dt in (None, torch.bfloat16):
        m = fmodel if dt is None else fmodel.clone(dtype=jnp.bfloat16)
        out = jax.jit(lambda v, a, c, m=m: m.apply(v, a, c, lookup_backend="xla"))(
            variables, *args)
        flows[("jax", "xla", dt)] = np.asarray(out["flow"][-1], np.float32)

    def dist(a, c):
        d = np.abs(flows[a] - flows[c])
        return {"max_px": float(d.max()), "mean_px": float(d.mean())}

    bf, fp = torch.bfloat16, None
    return {
        "samples": samples, "image": cs.IMG, "iters": cs.RAFT_ITERS, "model": cs.RAFT_SMALL,
        "flow_max_abs_px": float(np.abs(flows[("jax", "xla", fp)]).max()),
        "jax_bf16_vs_fp32": dist(("jax", "xla", bf), ("jax", "xla", fp)),
        "port_bf16_vs_fp32_xla": dist(("port", "xla", bf), ("port", "xla", fp)),
        "port_bf16_vs_fp32_pallas": dist(("port", "pallas", bf), ("port", "pallas", fp)),
        "port_fp32_vs_jax_fp32": dist(("port", "xla", fp), ("jax", "xla", fp)),
        "port_bf16_vs_jax_bf16": dist(("port", "xla", bf), ("jax", "xla", bf))}


def test_raft_small_bf16_distance_is_jax_s():
    """On chip_smoke's raft_small inputs and weights (2 samples, 256^2, 12
    iterations) bf16 moves JAX's RAFT-S flow by px, and the port's by no
    more than twice as much, max and mean, on either lookup route: the
    distance the card shows is the network's, not the port's."""
    d = measure(2)
    jax_d = d["jax_bf16_vs_fp32"]
    assert jax_d["max_px"] > 0.1  # bf16 moves RAFT-S's flow by pixels
    for route in ("port_bf16_vs_fp32_xla", "port_bf16_vs_fp32_pallas"):
        for k in ("max_px", "mean_px"):
            assert d[route][k] <= 2 * jax_d[k], (route, k, d[route][k], jax_d[k])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=4)
    print(json.dumps(measure(ap.parse_args().samples)))


if __name__ == "__main__":
    main()
