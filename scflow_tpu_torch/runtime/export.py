"""Ahead-of-time export: the inference graph, weights baked in, as
`torch.export` programs in one file.

Port of scflow_tpu/runtime/export.py.  The JAX package lowers its jitted
infer fn with `jax.export` to StableHLO; here each platform's infer fn is
traced with `torch.export.export` (non-strict) into an ExportedProgram: the
render, the encoders, the recurrence and the pose update, with the model's
weights and the mesh bank held by the program.  Every hand-written kernel
appears in the graph as its custom op (`torch.ops.scflow.*`, registered by
ops/cuda/corr_lookup.py and ops/cuda/rasterize.py), whose body launches
the kernel on a CUDA tensor and runs its plain version on a CPU one.  A
loaded artifact runs without the model code, the config system or the
checkpoint format: loading imports the op registrations, this module and
device.py.

Artifact layout (one file, little-endian), JAX's:

    magic b"SCFLOWX1" | u64 meta_len | meta json (utf-8) | blob

The meta holds the batch spec (key -> shape and dtype), the output keys,
the platforms and the caller's provenance (config, checkpoint, image size),
and, as reserved keys with `format`, `platforms`, `inputs` and `outputs`:
`programs` (each platform's byte range in the blob, a `torch.export.save`
archive) and `torch` (the version that wrote it).  `format` is FORMAT,
where a JAX artifact has 1, so that `load_exported` tells the two apart.

Differences from JAX's export, each forced by torch.export:
- `export_infer` takes a function that builds the infer fn on a device,
  not `variables`: the port's infer fns hold their model.
- One program per platform, each traced from an infer fn built on that
  device ('cuda' on the card, 'cpu' on the CPU, where the ops run their
  plain versions); a platform the host lacks cannot be traced, where JAX
  lowers for a platform it does not have.
- An artifact loads in the torch version that wrote it (torch.export's
  serialization is not promised across versions).
"""

import io
import json
import struct
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from scflow_tpu_torch.device import full_fp32, resolve_device

_MAGIC = b"SCFLOWX1"
FORMAT = "scflow_tpu_torch/torch.export/1"
PLATFORMS = ("cuda", "cpu")


def batch_spec(batch_size: int, image_size: Tuple[int, int] = (256, 256),
               dtype=np.float32) -> Dict[str, Dict[str, Any]]:
    """The batch every refiner infer fn takes (JAX's keys, shapes and
    dtypes; labels int32): {key: {"shape": [...], "dtype": numpy name}}.
    The batch size is static in the exported graph."""
    h, w = image_size
    b = batch_size
    spec = {"real_images": ((b, h, w, 3), dtype), "ref_rotations": ((b, 3, 3), np.float32),
            "ref_translations": ((b, 3), np.float32), "k": ((b, 3, 3), np.float32),
            "labels": ((b,), np.int32)}
    return {k: {"shape": list(shape), "dtype": np.dtype(dt).name}
            for k, (shape, dt) in spec.items()}


class _Traced(torch.nn.Module):
    """The body of an infer fn as a module, so that torch.export traces it."""

    def __init__(self, body: Callable):
        super().__init__()
        self.body = body

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.body(batch)


def _example(spec: Dict[str, Dict[str, Any]], dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s["shape"], dtype=getattr(torch, s["dtype"]), device=dev)
            for k, s in spec.items()}


def _trace(infer, spec: Dict[str, Dict[str, Any]]) -> torch.export.ExportedProgram:
    """infer.trace_body at the spec's batch size, exported (non-strict, not
    decomposed: the loaded graph holds the live call's ATen ops)."""
    batch_size = spec["labels"]["shape"][0]
    body = infer.trace_body(batch_size)
    try:
        with torch.no_grad():
            return torch.export.export(_Traced(body), (_example(spec, infer.device),),
                                       strict=False)
    except Exception as e:
        raise RuntimeError(f"torch.export could not trace the infer fn on "
                           f"{infer.device}: {type(e).__name__}: {e}") from e


def export_infer(make_infer: Callable[[Optional[torch.device]], Callable],
                 spec: Dict[str, Dict[str, Any]], platforms: Optional[Sequence[str]] = None,
                 meta: Optional[Dict[str, Any]] = None) -> bytes:
    """Trace the infer fn that `make_infer(device)` builds (an entry point of
    refiners/system.py, holding its model) on each of `platforms` ('cuda',
    'cpu'), weights and meshes baked in, and return the artifact's bytes.

    JAX's export_infer takes (infer_fn, variables, ...); the port's infer fns
    hold their model, so it takes a function of the device instead, called
    once per platform.  No platforms (None or empty) means the device
    `make_infer(None)` builds for (JAX: the current backend).  Any other name,
    'tpu' included, raises ValueError; 'cuda' on a host without a card
    raises resolve_device's error (JAX can lower for an absent platform;
    torch.export traces on the device).  The caller's meta is kept, but the
    reserved keys (format, platforms, inputs, outputs, programs, torch) are
    the artifact's own."""
    platforms = list(platforms or [])
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown export platform {p!r}; expected some of {PLATFORMS}")
    infers = []
    if not platforms:
        infers.append(make_infer(None))
        platforms = [infers[0].device.type]
    else:
        infers = [make_infer(resolve_device(p)) for p in platforms]
    blobs = []
    for p, infer in zip(platforms, infers):
        if infer.device.type != p:
            raise ValueError(f"the infer fn for platform {p!r} was built on {infer.device}")
        ep = _trace(infer, spec)
        outputs = sorted(ep.call_spec.out_spec.context)
        ep.example_inputs = None  # zeros of the spec: 50 MB at batch 64, 256^2
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        blobs.append(buf.getvalue())
    ranges, off = {}, 0
    for p, blob in zip(platforms, blobs):
        ranges[p] = [off, len(blob)]
        off += len(blob)
    # caller meta first, so that the reserved self-description always wins:
    # a server validates requests against it
    header = dict(meta or {})
    header.update({"format": FORMAT, "platforms": platforms, "inputs": spec,
                   "outputs": outputs, "programs": ranges, "torch": torch.__version__})
    payload = json.dumps(header).encode()
    return _MAGIC + struct.pack("<Q", len(payload)) + payload + b"".join(blobs)


def read_meta(data: bytes) -> Dict[str, Any]:
    """Parse just the json header (no program is deserialized)."""
    if data[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not a scflow_tpu export artifact (bad magic)")
    if len(data) < len(_MAGIC) + 8:
        raise ValueError("truncated scflow_tpu export artifact: "
                         f"{len(data)} bytes, header needs {len(_MAGIC) + 8}")
    (n,) = struct.unpack_from("<Q", data, len(_MAGIC))
    off = len(_MAGIC) + 8
    if off + n > len(data):
        raise ValueError("truncated/corrupt scflow_tpu export artifact: meta length "
                         f"{n} exceeds file ({len(data)} bytes)")
    try:
        return json.loads(data[off: off + n].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt scflow_tpu export artifact meta: {e}") from e


def load_exported(path_or_bytes, device=None) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact's program for `device` (None: the card); returns
    (call, meta).  call(batch) takes the batch spec's keys as numpy arrays
    or tensors, moves them to the device in the spec's dtypes, and runs the
    program under torch.inference_mode() and device.full_fp32() (the live
    call's contexts, which a program does not keep); it returns the live
    infer fn's dict.  A device whose platform is not in meta['platforms']
    raises ValueError naming both; so does a JAX artifact.  Imports the op
    registrations, which the program's graph names, before loading.  Load
    with the torch version that wrote the artifact (meta['torch'])."""
    from scflow_tpu_torch.ops.cuda import corr_lookup, rasterize  # noqa: F401 (the ops)

    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    meta = read_meta(data)
    if meta.get("format") != FORMAT:
        if meta.get("format") == 1:
            raise ValueError("this is a JAX (jax.export StableHLO) artifact of scflow_tpu; "
                             "scflow_tpu_torch loads only its own torch.export artifacts: "
                             "re-export with python -m scflow_tpu_torch.cli export")
        raise ValueError(f"unknown export artifact format {meta.get('format')!r}; "
                         f"expected {FORMAT!r}")
    dev = resolve_device(device)
    platforms = meta.get("platforms") or []
    if dev.type not in platforms:
        raise ValueError(f"artifact was exported for platforms {platforms}; the device is "
                         f"{dev} ('{dev.type}'): re-export with --platforms {dev.type}")
    off, length = meta["programs"][dev.type]
    start = len(_MAGIC) + 8 + struct.unpack_from("<Q", data, len(_MAGIC))[0] + off
    program = torch.export.load(io.BytesIO(data[start: start + length])).module()
    dtypes = {k: getattr(torch, s["dtype"]) for k, s in meta["inputs"].items()}

    def call(batch: Dict) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), full_fp32():
            return program({k: torch.as_tensor(batch[k], dtype=dt, device=dev)
                            for k, dt in dtypes.items()})

    return call, meta
