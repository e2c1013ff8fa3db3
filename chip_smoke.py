#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (scflow_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before the
last line:
  1. device  - the card, its power limit (nvidia-smi), torch and CUDA versions;
  2. build   - nvcc builds every kernel from scflow_tpu_torch/csrc (sm_90a);
  3. K1      - the corr-lookup kernel against its plain version at the
               flagship shape (65,536 rows, levels 32^2..4^2), max |d| <= 1e-4,
               with its time, the plain time, F.grid_sample's time and the
               bound;
  4. K2      - the raster kernel against its plain version at the flagship
               shape (64 x 256^2, 21-class 1024-face uvsphere bank, culling
               on): every map bit-identical; times and bound;
  5. slice   - make_scflow_infer_fn(slim) at the bench configuration (batch
               64, 256^2, 8 iterations, 21 classes, fp32, TF32 off, seeded
               random weights): one call with every launch count reset, then
               checks (finite, orthonormal, poses moved, the first 4 samples
               equal the CPU run of the plain versions to the slice-test
               tolerances, 8 K1 and 1 K2 launches) and refinements/s;
  6. the kernels line, then the device line the chip harness reads.
Imports no JAX.  Needs one card; without one it exits non-zero at once.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BATCH, IMG, ITERS, NCLASS = 64, 256, 8, 21
HEAD_STD = 0.005  # pose-head output weights of the seeded model (seeded_model)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, reps: int, groups: int = 5) -> float:
    """Median over `groups` of the mean time of `reps` back-to-back calls,
    timed with CUDA events after one warm-up call."""
    fn()
    times = []
    for _ in range(groups):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return name, smi


def phase_build():
    from scflow_tpu_torch.ops.cuda.build import build_all

    t0 = time.perf_counter()
    logs = build_all()
    ptxas = [line.strip() for log in logs.values() for line in log.splitlines()
             if "registers" in line or "Compiling entry" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(logs),
          "ptxas": ptxas})


def _flagship_lookup_inputs(dev):
    """65,536 rows (64 images at 32x32), levels 32^2..4^2; a third of the
    rows get random flows, a third border-straddling ones, a third exactly
    integer centres."""
    g = torch.Generator().manual_seed(1)
    n, h = BATCH, IMG // 8
    rows = n * h * h
    levels = [torch.randn((rows, (h >> l) ** 2), generator=g).to(dev) for l in range(4)]
    flow = 4.0 * torch.randn((rows, 2), generator=g)
    third = rows // 3
    flow[third:2 * third] = 80.0 * torch.rand((third, 2), generator=g) - 40.0
    flow[2 * third:] = torch.randint(-12, 13, (rows - 2 * third, 2), generator=g).float()
    gy, gx = torch.meshgrid(torch.arange(h), torch.arange(h), indexing="ij")
    base = torch.stack([gx, gy], -1).reshape(1, h * h, 2).expand(n, -1, -1).reshape(rows, 2)
    return levels, (base + flow).contiguous().to(dev)


def _lookup_bound(levels, coords, radius: int = 4):
    """Bytes: coords once, the output once, and the map cells these windows
    touch with a non-zero weight (x from floor(x) - r to ceil(x) + r, inside
    the map).  Operations: 3 lerps of 3 flops (a weight, 2 mul, 1 add) per
    output element."""
    rows = coords.shape[0]
    cells = 0
    for lvl, m in enumerate(levels):
        s = math.isqrt(m.shape[1])
        c = coords / 2.0**lvl
        lo = torch.clamp(torch.floor(c) - radius, min=0)
        hi = torch.clamp(torch.ceil(c) + radius, max=s - 1)
        span = torch.clamp(hi - lo + 1, min=0)
        cells += int((span[:, 0] * span[:, 1]).sum().item())
    out_elems = rows * len(levels) * (2 * radius + 1) ** 2
    return bound(coords.numel() * 4 + out_elems * 4 + cells * 4, out_elems * 9)


def _grid_sample_lookup(levels, coords, radius: int = 4):
    """The same windows by F.grid_sample (bilinear, zeros, align_corners),
    one call per level: the library yardstick, never used by the port."""
    k = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, device=coords.device, dtype=coords.dtype)
    calls = []
    for lvl, m in enumerate(levels):
        s = math.isqrt(m.shape[1])
        c = coords / 2.0**lvl
        gx = (c[:, 0, None, None] + offs[:, None]).expand(-1, k, k)  # [b, j, i]: j offsets x
        gy = (c[:, 1, None, None] + offs[None, :]).expand(-1, k, k)
        grid = torch.stack([2 * gx / (s - 1) - 1, 2 * gy / (s - 1) - 1], -1).contiguous()
        maps = m.view(-1, 1, s, s)
        calls.append(lambda maps=maps, grid=grid: torch.nn.functional.grid_sample(
            maps, grid, mode="bilinear", padding_mode="zeros", align_corners=True))
    return calls


def phase_k1(dev):
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1

    levels, coords = _flagship_lookup_inputs(dev)
    got = k1.corr_lookup_flat(levels, coords)
    want = k1.corr_lookup_flat_plain(levels, coords)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(math.isfinite(err) and err <= 1e-4, f"K1 max |d| {err} <= 1e-4")
    calls = _grid_sample_lookup(levels, coords)
    lib = torch.cat([f().reshape(coords.shape[0], -1) for f in calls], dim=1)
    lib_err = (lib - want).abs().max().item()
    bound_ms, bound_by = _lookup_bound(levels, coords)
    res = {
        "max_abs_err": err,
        "ms": median_ms(lambda: k1.corr_lookup_flat(levels, coords), 20),
        "plain_ms": median_ms(lambda: k1.corr_lookup_flat_plain(levels, coords), 3),
        "library_ms": sum(median_ms(f, 10) for f in calls),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit({"phase": "K1", "rows": coords.shape[0], "grid_sample_max_abs_diff": lib_err, **res})
    return res


def _flagship_raster_inputs(dev):
    """Rows/active of the bench render: 64 images, 256^2, 21-class 1024-face
    uvsphere bank, culling on; the bench's pose (t = (0, 0, 700)) with
    random rotations and a spread of translations."""
    from scflow_tpu_torch.ops.cuda.rasterize import pack_shaded_and_bin
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from scflow_tpu_torch.render.rasterizer import (gather_corner_attrs, gather_tri,
                                                    project_to_screen)

    g = torch.Generator().manual_seed(2)
    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    labels = torch.randint(0, NCLASS, (BATCH,), generator=g)
    q = torch.nn.functional.normalize(torch.randn((BATCH, 4), generator=g), dim=-1)
    w, x, y, z = q.unbind(-1)
    R = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                     2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                     2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                    -1).reshape(BATCH, 3, 3)
    t = torch.tensor([0.0, 0.0, 700.0]) + torch.cat(
        [40.0 * torch.randn((BATCH, 2), generator=g), 100.0 * torch.rand((BATCH, 1), generator=g)], 1)
    K = torch.tensor([[572.4, 0, IMG / 2], [0, 573.5, IMG / 2], [0, 0, 1]]).expand(BATCH, 3, 3)
    verts = torch.from_numpy(bank.verts)[labels].to(dev)
    faces = torch.from_numpy(bank.faces)[labels].to(dev)
    R, t, K = R.to(dev), t.to(dev), K.to(dev)
    verts_cam = torch.einsum("nij,nvj->nvi", R, verts) + t[:, None]
    normals_cam = torch.einsum("nij,nvj->nvi", R, torch.from_numpy(bank.normals)[labels].to(dev))
    xy, zv = project_to_screen(verts_cam, K)
    tri_xy, tri_z = gather_tri(xy, zv, faces)
    corner = gather_corner_attrs(
        torch.cat([normals_cam, torch.from_numpy(bank.colors)[labels].to(dev)], -1), faces)
    rows, active, _ = pack_shaded_and_bin(tri_xy, tri_z, torch.from_numpy(bank.face_valid)[labels].to(dev),
                                          corner, IMG, IMG, cull_backfaces=True)
    return rows, active


def phase_k2(dev):
    from scflow_tpu_torch.ops.cuda import rasterize as k2

    rows, active = _flagship_raster_inputs(dev)
    bits = k2.id_bits_for(rows.shape[-1])
    got = k2.rasterize_shaded_v3(rows, active, IMG, IMG, bits)
    want = k2.rasterize_shaded_v3_plain(rows, active, IMG, IMG, bits)
    torch.cuda.synchronize()
    fg = want[:, 1].mean().item()
    require(fg > 0.05, f"K2 scene covers {fg} of the pixels")
    exact = {name: torch.equal(got[:, c], want[:, c])
             for name, c in (("depth", 0), ("fg", 1), ("id", 2))}
    require(all(exact.values()), f"K2 depth/fg/id bit-identical: {exact}")
    err = (got - want).abs().max().item()
    require(err == 0.0, f"K2 attrs max |d| {err} == 0")
    pairs = int(active.sum().item())
    out_bytes = got.numel() * 4
    bound_ms, bound_by = bound(rows.numel() * 4 + active.numel() * 4 + out_bytes,
                               pairs * k2.FC * k2.TH * k2.TW * 14)
    res = {
        "max_abs_err": err,
        "ms": median_ms(lambda: k2.rasterize_shaded_v3(rows, active, IMG, IMG, bits), 20),
        "plain_ms": median_ms(lambda: k2.rasterize_shaded_v3_plain(rows, active, IMG, IMG, bits),
                              1, groups=3),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit({"phase": "K2", "faces": rows.shape[-1], "active_pairs": pairs,
          "active_pairs_max": active.numel(), "fg_share": fg, "bit_identical": exact, **res})
    return res


def seeded_model():
    """The bench network with weights from a seeded generator: lecun-normal
    convs and linears, zero biases, default norms; the pose head's output
    weights get normal(0, HEAD_STD) so that the poses move.  Larger output
    weights (0.02, as the parity tests use at 3 iterations) make the
    random-weight recurrence chaotic over 8 iterations: rounding-sized input
    differences grow into visible pose differences, and no two devices
    could be compared."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    model = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=ITERS)
    g = torch.Generator().manual_seed(0)
    head = model.decoder.pose_pred
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)) and mod not in (
                    head.rotation_pred, head.translation_pred):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g) / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
        for lin in (head.rotation_pred, head.translation_pred):
            lin.weight.copy_(HEAD_STD * torch.randn(lin.weight.shape, generator=g))
    return model


def bench_batch():
    """The bench's inputs (bench.py:93-105): random real images, identity
    rotations, t = (0, 0, 700), the LINEMOD intrinsics, random labels."""
    rng = np.random.default_rng(0)
    real = (rng.normal(size=(BATCH, IMG, IMG, 3)) * 0.2).astype(np.float32)
    K = np.tile(np.array([[[572.4, 0, IMG / 2], [0, 573.5, IMG / 2], [0, 0, 1]]], np.float32),
                (BATCH, 1, 1))
    R = np.tile(np.eye(3, dtype=np.float32)[None], (BATCH, 1, 1))
    t = np.tile(np.array([[0, 0, 700.0]], np.float32), (BATCH, 1))
    labels = rng.integers(0, NCLASS, BATCH).astype(np.int64)
    return dict(real_images=real, ref_rotations=R, ref_translations=t, k=K, labels=labels)


def phase_slice(smi):
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1
    from scflow_tpu_torch.ops.cuda import rasterize as k2
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
    from scflow_tpu_torch.refiners.system import RenderAssets, make_scflow_infer_fn
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    model = seeded_model()
    cpu_model = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=ITERS)
    cpu_model.load_state_dict(model.state_dict())
    batch = bench_batch()
    assets = RenderAssets.from_bank(bank)
    infer = make_scflow_infer_fn(model, assets, image_size=(IMG, IMG),
                                 render_cull_backfaces=True)
    torch.cuda.reset_peak_memory_stats()
    infer(batch)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    k1.KERNEL.launches = k2.KERNEL.launches = 0
    out = infer(batch)
    torch.cuda.synchronize()
    launches = {"K1": k1.KERNEL.launches, "K2": k2.KERNEL.launches}
    require(launches == {"K1": ITERS, "K2": 1}, f"launches per call {launches}")

    R, t = out["rotations"].cpu().numpy(), out["translations"].cpu().numpy()
    require(np.isfinite(R).all() and np.isfinite(t).all(), "finite poses")
    ortho = float(np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max())
    require(ortho < 1e-4, f"|R^T R - I| {ortho} < 1e-4")
    moved = float(np.abs(t - batch["ref_translations"]).max())
    require(moved > 1.0 and np.abs(R - batch["ref_rotations"]).max() > 1e-3, "poses moved")

    ref_infer = make_scflow_infer_fn(cpu_model, RenderAssets.from_bank(bank, device="cpu"),
                                     image_size=(IMG, IMG), render_cull_backfaces=True,
                                     device="cpu")
    ref = ref_infer({k: v[:4] for k, v in batch.items()})
    d_rot = float(np.abs(R[:4] - ref["rotations"].numpy()).max())
    t_ref = ref["translations"].numpy()
    t_excess = float((np.abs(t[:4] - t_ref) - (2e-2 + 2e-3 * np.abs(t_ref))).max())
    require(d_rot <= 2e-3 and t_excess <= 0, f"card vs CPU: rot |d| {d_rot}, t excess {t_excess}")

    calls = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = infer(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    emit({"phase": "slice", "batch": BATCH, "image": IMG, "iters": ITERS, "classes": NCLASS,
          "launches_per_call": launches, "orthonormality_err": ortho, "max_translation_move": moved,
          "cpu_rot_max_abs_diff": d_rot, "cpu_trans_tolerance_excess": t_excess,
          "ms_per_call": 1e3 * dt / calls, "refinements_per_s": BATCH * calls / dt,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    phase_profile(infer, model, assets, batch, smi)
    return launches


def phase_profile(infer, model, assets, batch, smi):
    """Where one call's time goes: render, encoders and decoder timed with
    CUDA events (median of 3 after a warm-up), and, from torch.profiler over
    one call, each kernel's summed device time and count.  The sum over
    kernels can exceed the device timeline (cuDNN's kernels overlap), so it
    is no busy share."""
    from torch.profiler import ProfilerActivity, profile

    from scflow_tpu_torch.refiners.system import render_and_normalize

    b = {k: torch.as_tensor(v, device=assets.verts.device) for k, v in batch.items()}
    times = {"render": [], "encoders": [], "decoder": []}
    with torch.inference_mode():
        for _ in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            images, depths, _ = render_and_normalize(
                assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                (IMG, IMG), cull_backfaces=True)
            ev[1].record()
            feats = model.extract_feat(images.permute(0, 3, 1, 2).contiguous(),
                                       b["real_images"].permute(0, 3, 1, 2).contiguous())
            ev[2].record()
            model.decoder(*feats, b["ref_rotations"], b["ref_translations"], depths, b["k"],
                          b["labels"])
            ev[3].record()
            torch.cuda.synchronize()
            for name, a, z in zip(times, ev, ev[1:]):
                times[name].append(a.elapsed_time(z))
    stage_ms = {k: statistics.median(v[1:]) for k, v in times.items()}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    ours = {name.split("(")[0]: v for name, v in kernels.items()
            if "corr_lookup_kernel" in name or "raster_v3_kernel" in name}
    emit({"phase": "profile", "stage_ms": stage_ms, "profiled_call_ms": wall_ms,
          "kernel_time_sum_ms": sum(ms for ms, _ in kernels.values()),
          "kernel_names": len(kernels), "ours_ms_count": ours,
          "top_kernels_ms_count": [[name[:90], ms, n] for name, (ms, n) in top], "card": smi})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import scflow_tpu_torch  # noqa: F401  (fails at once outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    phase_build()
    k1_res = phase_k1(dev)
    k2_res = phase_k2(dev)
    launches = phase_slice(smi)
    emit({"kernels": [
        {"name": "K1 corr_lookup", "route": "cuda", "source": "scflow_tpu_torch/csrc/corr_lookup.cu",
         "replaces": "scflow_tpu/ops/pallas/corr_lookup.py:230 (_kernel)",
         "launches": launches["K1"], **k1_res,
         "max_abs_diff": k1_res["max_abs_err"], "kernel_ms": k1_res["ms"]},
        {"name": "K2 rasterize_shaded_v3", "route": "cuda",
         "source": "scflow_tpu_torch/csrc/rasterize_v3.cu",
         "replaces": "scflow_tpu/ops/pallas/rasterize.py:473 (_kernel_shaded_v3)",
         "launches": launches["K2"], **k2_res,
         "max_abs_diff": k2_res["max_abs_err"], "kernel_ms": k2_res["ms"]},
    ], "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
