"""Convert an mmflow RAFT checkpoint into the reference's duplicated-encoder
layout and into the port's own params file (the port's copy of the JAX
package's tools/mmflow_ckpt_converter.py, reference
tools/mmflow_ckpt_converter.py:19-41).

    python -m scflow_tpu_torch.cli mmflow-convert raft_8x2_100k_flyingthings3d.pth \
        --config configs/refine_models/scflow.py --out work_dirs/raft_init.pth \
        [--save-torch dup.pth] [--strict] [--device cpu]

--save-torch writes the checkpoint with 'encoder.*' copied to both
'real_encoder.*' and 'render_encoder.*' and 'cxt_encoder.*' renamed
'context.*' (checkpoint.duplicate_mmflow_encoder), the file the JAX
package's tool writes.  --strict first checks the file's keys and shapes
against the config's model, whose feature and context encoders under
mmflow's names are the mmflow RAFT encoders' manifest (mmflow's own
'decoder.*' keys ride along), and fails with the named key diff.
--out is the config's model, built with its seeded initialisation, with
every key the file holds loaded into it (checkpoint.load_pretrained),
written by checkpoint.save_params: a .pth that cli train's init_cfg, cli
test and cli visualize read.  The JAX package's tool writes flax orbax
params there; the port reads and writes no orbax."""

import argparse

# the port's encoder prefixes and mmflow's (duplicate_mmflow_encoder in reverse)
MMFLOW_NAMES = {"render_encoder.": "encoder.", "context.": "cxt_encoder."}


def mmflow_encoders(model) -> dict:
    """The model's feature and context encoders' tensors under mmflow's
    names ('encoder.*', 'cxt_encoder.*'): what --strict holds a file to.
    mmflow's one feature encoder fills the render and the real encoder
    alike, so the render encoder stands for both."""
    out = {}
    for k, v in model.state_dict().items():
        for ours, theirs in MMFLOW_NAMES.items():
            if k.startswith(ours):
                out[theirs + k[len(ours):]] = v
    return out


def check_mmflow(sd: dict, model, source: str) -> None:
    """--strict: the file's keys and shapes against mmflow_encoders(model);
    mmflow's own decoder ('decoder.*') rides along, matched by name only
    when loaded.  Raises ValueError naming every missing, unexpected or
    mis-shaped key (checkpoint.check_state_dict)."""
    from scflow_tpu_torch.runtime.checkpoint import check_state_dict

    check_state_dict({k: v for k, v in sd.items() if not k.startswith("decoder.")},
                     mmflow_encoders(model), source)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Convert an mmflow RAFT checkpoint")
    p.add_argument("checkpoint", help="mmflow RAFT .pth")
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True,
                   help="the port's params .pth (save_params: the config's model with the "
                        "checkpoint's weights); the JAX tool's orbax params are not written")
    p.add_argument("--save-torch", default=None,
                   help="also write the duplicated-encoder .pth")
    p.add_argument("--strict", action="store_true",
                   help="verify the checkpoint's encoder keys and shapes against the config's "
                        "model first; fail with a named key diff on any mismatch")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns load_pretrained's {'missing', 'unexpected'} keys."""
    args = parse_args(argv)
    import torch

    from scflow_tpu_torch.apis import init_model_variables
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.checkpoint import (duplicate_mmflow_encoder, load_pretrained,
                                                     read_checkpoint, save_params)

    cfg = Config.fromfile(args.config)
    with torch.random.fork_rng(devices=[]):  # init_model_variables sets every weight
        model = build_refiner_from_config(cfg.model)
    init_model_variables(cfg.model, model, device=args.device)

    sd = read_checkpoint(args.checkpoint)["state_dict"]
    if args.save_torch:
        torch.save({"state_dict": duplicate_mmflow_encoder(sd)}, args.save_torch)
        print(f"wrote duplicated torch checkpoint {args.save_torch}")
    if args.strict:
        check_mmflow(sd, model, args.checkpoint)
    keys = load_pretrained(args.checkpoint, model, sd)
    save_params(args.out, model, {"source": args.checkpoint, "tool": "mmflow-convert"})
    print(f"wrote params {args.out}")
    return keys
