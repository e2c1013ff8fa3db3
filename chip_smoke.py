#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (scflow_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --lookup-only [--root DIR]   # phases 1-3, 10 and 11
                                 # only, of the package in DIR (e.g. a parent commit)
    python3 chip_smoke.py --raster-only [--root DIR]   # phases 1, 2 and 4-7 only

Phases, each printing one JSON line; any failure exits non-zero before the
last line:
  1. device  - the card, its power limit (nvidia-smi), torch and CUDA versions;
  2. build   - nvcc builds every kernel from scflow_tpu_torch/csrc (sm_90a);
               ptxas's registers, shared memory and spills per kernel; no
               run-time integer division in a loop of any K1, K7, K8 or K1b
               instance (cuobjdump), and the SASS counts of their radius-4
               kernels;
  3. K1      - the corr-lookup kernel against its plain version at the
               flagship shape (65,536 rows, levels 32^2..4^2) and at the
               train step's 16,384 rows, max |d| <= 1e-4, with its time
               (back-to-back calls) and device time (calls queued behind a
               device sleep), the plain time, F.grid_sample's times, the
               bound, GB/s and share of the bound, registers and shared
               memory;
  4. K2      - the raster kernel against its plain version at the flagship
               shape (64 x 256^2, 21-class 1024-face uvsphere bank, culling
               on): every map bit-identical; times (back-to-back and device)
               and bound (K2-K6: the bytes, and 14 operations per (face,
               pixel) pair inside the face's bounding box; beside it the
               brute-force count of the pairs walked); its split (probe
               launches: the test loop with the per-warp rejection alone,
               and the emit alone from its keys, giving K2's maps) and the
               surviving (warp, face) pairs, counted on the card and equal
               to the plain mirror's count;
  5. K3      - the v4 (exact-binned) raster kernel against its plain version
               on the same scene's pack_shaded_exact entries: bit-identical;
               against K2's maps: the same mask, the same winner face and
               depth on all but 2e-3 of the pixels;
  6. K4      - the depth-only kernel against its plain version on the
               scene's depth packs at rasterize()'s 8x128 tiles and 512-face
               chunks: bit-identical keys; the mirror's surviving share;
  7. K5/K6   - the v1/v2 kernel against its plain version on K2's packs,
               bit-identical, and equal to K2's maps;
  8. slice   - make_scflow_infer_fn(slim) at the bench configuration (batch
               64, 256^2, 8 iterations, 21 classes, fp32, TF32 off, seeded
               random weights): one call with every launch count reset, then
               checks (finite, orthonormal, poses moved, the first 4 samples
               equal the CPU run of the plain versions to the slice-test
               tolerances, 8 K1 and 1 K2 launches) and refinements/s; then
               the profile of one call; then the model's forward with cuDNN
               TF32 off and on (PyTorch's default; the entry points now
               compute in full fp32 whatever the flags), its times and the
               pose difference;
  9. render  - the render surface at the flagship scene, each entry point
               called once with every launch count reset: render_batch v4
               (1 K3) against v3 (1 K2), rasterize 'pallas' (1 K4) against
               'xla', one rasterize_shaded call per version (1 K5, 1 K6),
               flat and gouraud shading, and render_batch at a 192^2 crop
               with backend 'auto' (the brute-force path, no kernel) against
               the CPU run; ms per call of each;
 10. K7/K8   - the shift and bdiag lookup kernels on K1's inputs (both
               shapes, run with K1 in phase 3): K7 bit-identical to its
               plain version, K8 within 1e-4 of the tent plain version;
               the same numbers as K1;
 11. K1b     - the lookup's backward at the training shape (16 x 32^2 rows,
               random, border and integer centres) against its plain
               version, level and flow grads within 1e-4, the same bits
               from two launches; times (without the flow grad, as the
               train step runs it) back-to-back and as device time, the
               autograd backward of the 4 F.grid_sample calls, the bound,
               GB/s and share of the bound, registers and shared memory;
 12. train   - make_scflow_train_step(lookup_backend='pallas') at the shipped
               recipe (batch 16, 256^2, 8 iterations, 21-class 1024-face
               uvsphere bank, culling on, fp32 with TF32 off, AdamW + clip
               10 + OneCycle, seeded weights) on a synthetic batch (real
               images rendered at gt poses, jittered reference poses, gt
               masks from the render): one step with every launch count
               reset (exactly 1 K2, 8 K1, 8 K1b; finite loss); one step each
               with lookup_variant 'shift' and 'bdiag' from the same state
               (8 K7 or 8 K8, the tent loss within rtol 1e-4); the loss
               falling over 6 steps at a constant lr 1e-3; a card step
               against a CPU step of the plain versions at batch 2, 128^2,
               3 iterations (loss rtol 1e-3, worst per-leaf gradient rel L2
               <= 2e-2); ms per step, samples/s, forward/backward/optimizer
               ms (CUDA events), peak memory and the profiler's top kernels;
 13. the kernels line, then the device line the chip harness reads.
Imports no JAX.  Needs one card; without one it exits non-zero at once.
"""

import argparse
import json
import math
import re
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
TRAIN_BATCH = 16  # configs/refine_datasets/ycbv_real.py:118, samples_per_gpu
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


def device_ms(fn, reps: int, groups: int = 5) -> float:
    """As median_ms, but each group waits behind a 5 ms device sleep, so the
    host has queued every launch before the first one starts: the device's
    time per call, even where a launch takes less time than its Python
    wrapper (the lookups at 16,384 rows)."""
    fn()
    times = []
    for _ in range(groups):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)  # cycles: about 5 ms at the H100's clock
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


def parse_ptxas(logs) -> dict:
    """{kernel entry (mangled): {"registers", "smem_bytes" (static),
    "spill_bytes"}} from nvcc's -Xptxas -v output."""
    table, entry = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
                table[entry] = {"registers": None, "smem_bytes": 0, "spill_bytes": 0}
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                table[entry]["spill_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                table[entry]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                table[entry]["smem_bytes"] = int(m.group(1)) if m else 0
    return table


def sass_counts(lib: Path) -> dict:
    """{kernel (mangled): counts} of a built library by cuobjdump -sass: its
    SASS instructions; those inside loops (a backward branch closes a loop
    from its target to itself); and, inside loops, the run-time integer
    divisions, which nvcc builds for sm_90 around a MUFU.RCP of the divisor
    converted to float (these kernels divide no floats), and subroutine
    calls (a 64-bit division is one)."""
    from scflow_tpu_torch.ops.cuda.build import _nvcc

    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fname, insts in funcs.items():
        in_loop = set()
        for addr, inst in insts:
            m = re.match(r"(?:@!?U?P\w+\s+)?BRA\b.*?0x([0-9a-f]+)", inst)
            if m and int(m.group(1), 16) <= addr:
                in_loop.update(a for a, _ in insts if int(m.group(1), 16) <= a <= addr)
        out[fname] = {
            "instructions": len(insts), "loop_instructions": len(in_loop),
            "int_div_sequences_in_loops": sum(a in in_loop for a, inst in insts
                                              if "MUFU.RCP" in inst or "I2F.U32.RP" in inst),
            "calls_in_loops": sum(a in in_loop for a, inst in insts if "CALL.REL" in inst)}
    return out


# the kernel each lookup runs at radius 4 (K1/K7/K8: that instance of the
# window pipeline, K1b: its instance without the flow gradient; or a parent's
# first kernel), by a fragment of its mangled name
LOOKUP_ENTRIES = {"K1": ("ILi4E9TentBlend", "corr_lookup_kernel"),
                  "K7": ("ILi4E10ShiftBlend", "corr_lookup_shift_kernel"),
                  "K8": ("ILi4E10BdiagBlend", "corr_lookup_bdiag_kernel"),
                  "K1b": ("lookup_bwd_kernelILi4ELb0E", "corr_lookup_bwd_kernel")}
# the sources of those kernels, and the mangled-name start of the template
# each instantiates per radius (a parent's corr_lookup_bwd_kernel is none)
LOOKUP_SOURCES = {"corr_lookup.cu": "22windowed_lookup_kernelI",
                  "corr_lookup_shift.cu": "22windowed_lookup_kernelI",
                  "corr_lookup_bdiag.cu": "22windowed_lookup_kernelI",
                  "corr_lookup_bwd.cu": "17lookup_bwd_kernelI"}


def phase_build(strict: bool = True):
    """Builds every kernel; returns ptxas's table.  Requires that no loop of
    a K1, K7, K8 or K1b instance divides integers at run time (and, with
    strict, that each of their sources has such instances: a parent's
    package may predate them), and emits the SASS counts of the radius-4
    ones."""
    from scflow_tpu_torch.ops.cuda.build import build_all, library_path

    t0 = time.perf_counter()
    logs = build_all()
    seconds = time.perf_counter() - t0
    ptxas = parse_ptxas(logs)
    sass, instances = {}, {}
    tags = [tag for key in LOOKUP_ENTRIES.values() for tag in key]
    for src, template in LOOKUP_SOURCES.items():
        instances[src] = 0
        for fname, c in sass_counts(library_path(src)).items():
            if template in fname:
                instances[src] += 1
                require(c["int_div_sequences_in_loops"] == 0 and c["calls_in_loops"] == 0,
                        f"{fname}: no run-time integer division in a loop ({c})")
            if any(tag in fname for tag in tags):
                sass[fname] = c
        require(instances[src] > 0 or not strict, f"{src}: no {template} instance")
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs), "ptxas": ptxas,
          "instances": instances, "sass": sass})
    return ptxas


def _lookup_resources(key: str, ptxas: dict, levels: int = 4, radius: int = 4) -> dict:
    """ptxas's registers, spills and static shared memory of the kernel that
    key runs at radius 4, and the dynamic shared memory its launch asks for
    at 4 levels, as the built library reports it (None for a package that
    does not report it, e.g. a parent's)."""
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1

    try:
        if key == "K1b":
            dyn = k1.bwd_layout(levels, radius, False)["smem_bytes"]
        else:
            variant = {"K1": "tent", "K7": "shift", "K8": "bdiag"}[key]
            dyn = k1.window_layout(variant, levels, radius)["smem_bytes"]
    except AttributeError:  # no such layout function in this package
        dyn = None
    for entry, res in ptxas.items():
        if any(tag in entry for tag in LOOKUP_ENTRIES[key]):
            return {"entry": entry, **res, "dynamic_smem_bytes": dyn}
    return {"entry": None, "dynamic_smem_bytes": dyn}


def _flagship_lookup_inputs(dev, n: int = None):
    """n images at 32x32 (65,536 rows at the bench's 64), levels 32^2..4^2;
    a third of the rows get random flows, a third border-straddling ones, a
    third exactly integer centres."""
    g = torch.Generator().manual_seed(1)
    n, h = n or BATCH, IMG // 8
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
    nbytes = coords.numel() * 4 + out_elems * 4 + cells * 4
    return (*bound(nbytes, out_elems * 9), nbytes)


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


def phase_lookup(dev, ptxas):
    """K1 (tent), K7 (shift) and K8 (bdiag) on the same inputs, at the
    flagship's 65,536 rows and at the train step's 16,384: each against its
    plain version, timed beside the same F.grid_sample calls and bound.  ms
    and library_ms time back-to-back calls (median_ms, as every kernel's ms);
    device_ms and library_device_ms the same calls queued behind a device
    sleep (device_ms).  Each line adds the achieved GB/s and share of the
    bound by both times, and ptxas's registers and shared memory.  Returns
    the flagship numbers for the kernels line."""
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1

    variants = (("K1", "tent", k1.corr_lookup_flat_plain, 1e-4),
                ("K7", "shift", k1.corr_lookup_flat_shift_plain, 0.0),
                ("K8", "bdiag", k1.corr_lookup_flat_plain, 1e-4))
    out = {}
    for n, shape in ((BATCH, "flagship"), (TRAIN_BATCH, "train_shape")):
        levels, coords = _flagship_lookup_inputs(dev, n)
        rows = coords.shape[0]
        calls = _grid_sample_lookup(levels, coords)
        tent = k1.corr_lookup_flat_plain(levels, coords)
        lib = torch.cat([f().reshape(rows, -1) for f in calls], dim=1)
        lib_err = (lib - tent).abs().max().item()
        library_ms = sum(median_ms(f, 10) for f in calls)
        library_device_ms = sum(device_ms(f, 20) for f in calls)
        bound_ms, bound_by, nbytes = _lookup_bound(levels, coords)
        for key, variant, plain, tol in variants:
            got = k1.corr_lookup_flat(levels, coords, variant=variant)
            want = plain(levels, coords)
            torch.cuda.synchronize()
            err = _max_abs(got, want)
            if tol == 0.0:
                require(torch.equal(got, want), f"{key} bit-identical at {rows} rows "
                                                f"(max |d| {err})")
            require(math.isfinite(err) and err <= tol, f"{key} max |d| {err} <= {tol}")

            def kernel():
                return k1.corr_lookup_flat(levels, coords, variant=variant)

            res = {"max_abs_err": err, "ms": median_ms(kernel, 20),
                   "device_ms": device_ms(kernel, 50),
                   "plain_ms": median_ms(lambda: plain(levels, coords), 3),
                   "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            if shape == "flagship":
                out[key] = res
            emit({"phase": key, "variant": variant, "shape": shape, "rows": rows,
                  "tolerance": tol, "grid_sample_max_abs_diff_vs_tent": lib_err, **res,
                  "library_device_ms": library_device_ms, "bytes": nbytes,
                  "gb_per_s": nbytes / res["ms"] / 1e6, "share_of_bound": bound_ms / res["ms"],
                  "device_gb_per_s": nbytes / res["device_ms"] / 1e6,
                  "device_share_of_bound": bound_ms / res["device_ms"],
                  "ptxas": _lookup_resources(key, ptxas)})
        del levels, coords, calls, tent, lib
    return out


def phase_k1b(dev, ptxas):
    """K1b at the training shape: 16 images at 32^2, so 16,384 rows."""
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1

    levels, coords = _flagship_lookup_inputs(dev, TRAIN_BATCH)
    rows = coords.shape[0]
    g = torch.randn((rows, 4 * 81), generator=torch.Generator().manual_seed(3)).to(dev)
    errs = {}
    for want_coords in (True, False):
        got, got_c = k1.corr_lookup_flat_bwd(levels, coords, g, want_coords=want_coords)
        again, again_c = k1.corr_lookup_flat_bwd(levels, coords, g, want_coords=want_coords)
        want, want_c = k1.corr_lookup_flat_bwd_plain(levels, coords, g, want_coords=want_coords)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)) and
                (not want_coords or torch.equal(got_c, again_c)),
                f"K1b: two launches give the same bits (want_coords={want_coords})")
        errs[want_coords] = max(_max_abs(a, b) for a, b in zip(got, want))
        if want_coords:
            errs["coords"] = _max_abs(got_c, want_c)
    err = max(errs.values())
    require(math.isfinite(err) and err <= 1e-4, f"K1b max |d| {errs} <= 1e-4")
    # the autograd backward of the 4 F.grid_sample calls into the maps
    maps = [m.detach().clone().requires_grad_() for m in levels]
    outs = [f() for f in _grid_sample_lookup(maps, coords)]
    gs = [gi.reshape(o.shape).contiguous() for gi, o in zip(g.split(81, dim=1), outs)]

    def library():
        torch.autograd.grad(outs, maps, gs, retain_graph=True)

    def kernel():
        return k1.corr_lookup_flat_bwd(levels, coords, g, want_coords=False)

    def with_flow_grad():
        return k1.corr_lookup_flat_bwd(levels, coords, g)

    # bytes: g and coords read once, the dense level grads written once
    nbytes = g.numel() * 4 + coords.numel() * 4 + sum(m.numel() * 4 for m in levels)
    cells = rows * sum((2 * 4 + 2) ** 2 for _ in levels)
    bound_ms, bound_by = bound(nbytes, cells * 4 * 5)  # up to 4 taps x (weight, mul, add)
    res = {
        "max_abs_err": err,
        "ms": median_ms(kernel, 20),
        "device_ms": device_ms(kernel, 50),
        "plain_ms": median_ms(lambda: k1.corr_lookup_flat_bwd_plain(levels, coords, g,
                                                                    want_coords=False), 3),
        "library_ms": median_ms(library, 5),
        "library_device_ms": device_ms(library, 5),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit({"phase": "K1b", "rows": rows, "max_abs_err_by_case": {str(k): v for k, v in errs.items()},
          "ms_with_flow_grad": median_ms(with_flow_grad, 20),
          "device_ms_with_flow_grad": device_ms(with_flow_grad, 50), **res, "bytes": nbytes,
          "gb_per_s": nbytes / res["ms"] / 1e6, "share_of_bound": bound_ms / res["ms"],
          "device_gb_per_s": nbytes / res["device_ms"] / 1e6,
          "device_share_of_bound": bound_ms / res["device_ms"],
          "ptxas": _lookup_resources("K1b", ptxas)})
    return res


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) unit quaternions (w, x, y, z) -> (N, 3, 3) rotations."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                       -1).reshape(-1, 3, 3)


def _flagship_scene(dev):
    """The bench render's scene: 64 images, 256^2, 21-class 1024-face
    uvsphere bank; the bench's pose (t = (0, 0, 700)) with random rotations
    and a spread of translations.  Returns the bank, the batch (R, t, K,
    labels) and the posed faces' projected corners, corner depths, validity
    and corner [normal, colour] attributes, all on dev."""
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from scflow_tpu_torch.render.rasterizer import (gather_corner_attrs, gather_tri,
                                                    project_to_screen)

    g = torch.Generator().manual_seed(2)
    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    labels = torch.randint(0, NCLASS, (BATCH,), generator=g)
    R = quat_to_matrix(torch.nn.functional.normalize(torch.randn((BATCH, 4), generator=g), dim=-1))
    t = torch.tensor([0.0, 0.0, 700.0]) + torch.cat(
        [40.0 * torch.randn((BATCH, 2), generator=g), 100.0 * torch.rand((BATCH, 1), generator=g)], 1)
    K = torch.tensor([[572.4, 0, IMG / 2], [0, 573.5, IMG / 2], [0, 0, 1]]).expand(BATCH, 3, 3)
    verts = torch.from_numpy(bank.verts)[labels].to(dev)
    faces = torch.from_numpy(bank.faces)[labels].to(dev)
    R, t, K = R.to(dev), t.to(dev), K.contiguous().to(dev)
    verts_cam = torch.einsum("nij,nvj->nvi", R, verts) + t[:, None]
    normals_cam = torch.einsum("nij,nvj->nvi", R, torch.from_numpy(bank.normals)[labels].to(dev))
    xy, zv = project_to_screen(verts_cam, K)
    tri_xy, tri_z = gather_tri(xy, zv, faces)
    corner = gather_corner_attrs(
        torch.cat([normals_cam, torch.from_numpy(bank.colors)[labels].to(dev)], -1), faces)
    face_valid = torch.from_numpy(bank.face_valid)[labels].to(dev)
    return dict(bank=bank, R=R, t=t, K=K, labels=labels.to(dev), verts_cam=verts_cam,
                faces=faces, face_valid=face_valid, tri_xy=tri_xy, tri_z=tri_z, corner=corner)


def _bbox_pairs(scene) -> int:
    """The (face, pixel) pairs these inputs need tested: over the faces that
    are valid and not culled, the pixels of the crop inside each face's
    screen bounding box (pixel centres at integer coordinates)."""
    from scflow_tpu_torch.ops.raster_pack import _face_plane_coeffs

    live = _face_plane_coeffs(scene["tri_xy"], scene["tri_z"], scene["face_valid"],
                              cull_backfaces=True)[9] > 0.5
    span = []
    for axis in (0, 1):
        v = scene["tri_xy"][..., axis]
        lo = torch.clamp(torch.ceil(v.amin(-1)), min=0)
        hi = torch.clamp(torch.floor(v.amax(-1)), max=IMG - 1)
        span.append(torch.clamp(hi - lo + 1, min=0))
    return int((span[0] * span[1] * live).sum().item())


def _raster_bound(inputs, out, scene, walked_pairs: int, faces_per_pair: int):
    """Bytes: each input and the output once.  Operations: 14 fp32 operations
    (3 affine planes of 4, w2's 2) per (face, pixel) pair with the pixel
    inside the face's bounding box (_bbox_pairs): what these inputs need.
    Also the brute-force design's count, 14 per face-pixel of every (tile,
    chunk) pair walked, as walked_face_pixel_pairs and walked_bound_ms, so
    that shares stay comparable with the records made by it."""
    nbytes = sum(a.numel() * a.element_size() for a in inputs) + out.numel() * out.element_size()
    pairs = scene.setdefault("bbox_pairs", _bbox_pairs(scene))
    bound_ms, bound_by = bound(nbytes, pairs * 14)
    return bound_ms, bound_by, {"bytes": nbytes, "bbox_face_pixel_pairs": pairs,
                                "walked_face_pixel_pairs": walked_pairs * faces_per_pair * 1024,
                                "walked_bound_ms": bound(nbytes, walked_pairs * faces_per_pair
                                                         * 1024 * 14)[0]}


def _time_kernel(kernel, plain):
    return {"ms": median_ms(kernel, 20), "device_ms": device_ms(kernel, 20),
            "plain_ms": median_ms(plain, 1, groups=3)}


def phase_k2(dev, scene):
    from scflow_tpu_torch.ops import raster_pack as pk
    from scflow_tpu_torch.ops.cuda import rasterize as k2

    rows, active, _ = pk.pack_shaded_and_bin(scene["tri_xy"], scene["tri_z"], scene["face_valid"],
                                             scene["corner"], IMG, IMG, k2.TH, k2.TW, k2.FC,
                                             cull_backfaces=True)
    bits = pk.id_bits_for(rows.shape[-1])
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
    bound_ms, bound_by, work = _raster_bound((rows, active), got, scene, pairs, k2.FC)
    res = {
        "max_abs_err": err,
        **_time_kernel(lambda: k2.rasterize_shaded_v3(rows, active, IMG, IMG, bits),
                       lambda: k2.rasterize_shaded_v3_plain(rows, active, IMG, IMG, bits)),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit({"phase": "K2", "faces": rows.shape[-1], "active_pairs": pairs,
          "active_pairs_max": active.numel(), "fg_share": fg, "bit_identical": exact, **work,
          **res, "split": _k2_split(rows, active, bits, got) if hasattr(k2, "V3_PROBE")
          else None})
    return res, (rows, active, got)


def _k2_split(rows, active, bits, maps):
    """K2's time in parts (its probe launches, each timed as device_ms): the
    test loop alone, the emit alone from its keys, and from background keys
    (its stores without the winners' gathers).  The emit from the test
    loop's keys must give K2's maps, and the surviving (warp, face) pairs
    the card counts must equal the plain mirror's count
    (ops/cuda/rasterize.py)."""
    from scflow_tpu_torch.ops.cuda import rasterize as k2

    def probe(mode, keys=None):
        return k2.rasterize_shaded_v3_probe(rows, active, IMG, IMG, bits, mode, keys)

    keys, kept = probe("test")
    emitted = probe("emit", keys)
    torch.cuda.synchronize()
    require(torch.equal(emitted, maps), "K2's emit from the keys gives K2's maps")
    kept_mirror, tested = k2.count_survivors(rows, active, IMG, IMG, k2.TH, k2.TW, k2.FC, False)
    require(int(kept.item()) == kept_mirror,
            f"surviving (warp, face) pairs: card {int(kept.item())}, mirror {kept_mirror}")
    background = torch.full_like(keys, k2.INT32_MAX)  # no winner: the emit's stores alone
    return {"test_device_ms": device_ms(lambda: probe("test"), 20),
            "emit_device_ms": device_ms(lambda: probe("emit", keys), 20),
            "emit_background_device_ms": device_ms(lambda: probe("emit", background), 20),
            "warp_face_pairs_tested": tested, "warp_face_pairs_kept": kept_mirror,
            "kept_share": kept_mirror / tested}


def _max_abs(got, want):
    return (got.double() - want.double()).abs().max().item()


def phase_k3(dev, scene, k2_out):
    """K3 against its plain version, and its maps against K2's: mask equal,
    and depth, normal, colour and barycentric channels and the original
    winner face inside tests/test_pallas_raster.py's tie bounds (> 1e-3 on
    < 2e-3 of the pixels)."""
    from scflow_tpu_torch.ops import raster_pack as pk
    from scflow_tpu_torch.ops.cuda import rasterize as k2

    rows, seg_start, seg_count, ov_counts, ov_order, perm = pk.pack_shaded_exact(
        scene["tri_xy"], scene["tri_z"], scene["face_valid"], scene["corner"], IMG, IMG,
        8, 128, 128, cull_backfaces=True)
    bits = pk.id_bits_for(rows.shape[-1])
    packs = (rows, seg_start, seg_count, ov_counts, ov_order)
    kw = dict(h=IMG, w=IMG, th=8, tw=128, fc=128, id_bits=bits)
    got = k2.rasterize_shaded_v4(*packs, **kw)
    want = k2.rasterize_shaded_v4_plain(*packs, **kw)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"K3 bit-identical (max |d| {_max_abs(got, want)})")

    rows3, _, v3 = k2_out
    _, _, perm3 = pk.pack_shaded_and_bin(scene["tri_xy"], scene["tri_z"], scene["face_valid"],
                                         scene["corner"], IMG, IMG, 8, 128, 128,
                                         cull_backfaces=True)
    require(torch.equal(got[:, 1], v3[:, 1]), "K3 and K2 masks equal")
    fg = v3[:, 1] > 0.5
    tie_share = {ch: ((got[:, ch] - v3[:, ch]).abs() > 1e-3).float().mean().item()
                 for ch in [0] + list(range(3, 12))}
    fid3 = torch.gather(perm3, 1, v3[:, 2].long().reshape(BATCH, -1)).reshape(fg.shape)
    fid4 = torch.gather(perm, 1, got[:, 2].long().reshape(BATCH, -1)).reshape(fg.shape)
    face_share = (fid3[fg] != fid4[fg]).float().mean().item()
    require(max(tie_share.values()) < 2e-3 and face_share < 2e-3,
            f"K3 vs K2: channel tie shares {tie_share}, winner faces {face_share}")

    walks = int((seg_count + torch.clamp(ov_counts, max=ov_order.shape[-1])).sum().item())
    bound_ms, bound_by, work = _raster_bound(packs, got, scene, walks, 128)
    res = {"max_abs_err": _max_abs(got, want),
           **_time_kernel(lambda: k2.rasterize_shaded_v4(*packs, **kw),
                          lambda: k2.rasterize_shaded_v4_plain(*packs, **kw)),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "K3", "entries": rows.shape[-1], "id_bits": bits, "chunk_walks": walks,
          "overflow_lists": int(ov_counts.sum().item()), "nov": ov_order.shape[-1],
          "k2_active_pairs": int(k2_out[1].sum().item()), "tie_share_vs_k2": tie_share,
          "winner_face_share_vs_k2": face_share, "bit_identical": True, **work, **res})
    return res


def phase_k4(dev, scene):
    from scflow_tpu_torch.ops import raster_pack as pk
    from scflow_tpu_torch.ops.cuda import rasterize as k2

    fc = pk.pick_face_chunk(scene["faces"].shape[1])
    rows, active, _ = pk.pack_faces_and_bin(scene["tri_xy"], scene["tri_z"], scene["face_valid"],
                                            IMG, IMG, 8, 128, fc, cull_backfaces=True)
    kw = dict(h=IMG, w=IMG, th=8, tw=128, fc=fc, id_bits=pk.id_bits_for(rows.shape[-1]))
    got = k2.rasterize_packed(rows, active, **kw)
    want = k2.rasterize_packed_plain(rows, active, **kw)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "K4 keys bit-identical")
    fg = (want != k2.INT32_MAX).float().mean().item()
    require(fg > 0.05, f"K4 scene covers {fg} of the pixels")
    pairs = int(active.sum().item())
    bound_ms, bound_by, work = _raster_bound((rows, active), got, scene, pairs, fc)
    res = {"max_abs_err": _max_abs(got, want),
           **_time_kernel(lambda: k2.rasterize_packed(rows, active, **kw),
                          lambda: k2.rasterize_packed_plain(rows, active, **kw)),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    survivors = {}
    if hasattr(k2, "count_survivors"):  # a parent's package may predate the rejection
        kept, tested = k2.count_survivors(rows, active, IMG, IMG, 8, 128, fc, True)
        survivors = {"warp_face_pairs_tested": tested, "warp_face_pairs_kept": kept,
                     "kept_share": kept / tested}
    emit({"phase": "K4", "fc": fc, "active_pairs": pairs, "active_pairs_max": active.numel(),
          "fg_share": fg, "bit_identical": True, **survivors, **work, **res})
    return res


def phase_k56(dev, scene, k2_out):
    """The v1/v2 kernel on K2's packs (fc 128): bit-identical to its plain
    version, and its maps equal K2's."""
    from scflow_tpu_torch.ops import raster_pack as pk
    from scflow_tpu_torch.ops.cuda import rasterize as k2

    rows, active, v3 = k2_out
    kw = dict(th=8, tw=128, fc=128, id_bits=pk.id_bits_for(rows.shape[-1]))
    want = k2.rasterize_shaded_plain(rows, active, IMG, IMG, **kw)
    out = {}
    for version in (1, 2):
        got = k2.rasterize_shaded(rows, active, IMG, IMG, **kw, version=version)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"K{4 + version} bit-identical")
        require(torch.equal(got, v3), f"K{4 + version} maps equal K2's")
        bound_ms, bound_by, work = _raster_bound((rows, active), got, scene,
                                                 int(active.sum().item()), 128)

        def kernel(version=version):
            return k2.rasterize_shaded(rows, active, IMG, IMG, **kw, version=version)

        out[version] = {
            "max_abs_err": _max_abs(got, want), "ms": median_ms(kernel, 20),
            "device_ms": device_ms(kernel, 20), "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by}
    plain_ms = median_ms(lambda: k2.rasterize_shaded_plain(rows, active, IMG, IMG, **kw), 1,
                         groups=3)
    for version in (1, 2):
        out[version]["plain_ms"] = plain_ms
        emit({"phase": f"K{4 + version}", "version": version, "bit_identical": True,
              "equal_to_k2": True, **work, **out[version]})
    return out


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


def kernel_counters():
    """{name: the CudaKernel whose `launches` counts that kernel}."""
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1
    from scflow_tpu_torch.ops.cuda import rasterize as k2

    return {"K1": k1.KERNEL, "K2": k2.V3_KERNEL, "K3": k2.V4_KERNEL, "K4": k2.PACKED_KERNEL,
            "K5": k2.V12_KERNELS[1], "K6": k2.V12_KERNELS[2], "K7": k1.SHIFT_KERNEL,
            "K8": k1.BDIAG_KERNEL, "K1b": k1.BWD_KERNEL}


def counted(fn):
    """fn() with every launch count set to 0 just before and read just
    after (synchronised): (its result, {kernel: launches})."""
    kernels = kernel_counters()
    for k in kernels.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: k.launches for name, k in kernels.items()}


def only(counts, **want):
    return counts == {name: want.get(name, 0) for name in counts}


def phase_slice(smi):
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

    out, launches = counted(lambda: infer(batch))
    require(only(launches, K1=ITERS, K2=1), f"launches per call {launches}")

    R, t = out["rotations"].cpu().numpy(), out["translations"].cpu().numpy()
    require(np.isfinite(R).all() and np.isfinite(t).all(), "finite poses")
    ortho = float(np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max())
    require(ortho < 1e-4, f"|R^T R - I| {ortho} < 1e-4")
    moved = float(np.abs(t - batch["ref_translations"]).max())
    require(moved > 1.0 and np.abs(R - batch["ref_rotations"]).max() > 1e-3, "poses moved")

    ref_infer = make_scflow_infer_fn(cpu_model, RenderAssets.from_bank(bank, device="cpu"),
                                     image_size=(IMG, IMG), render_backend="pallas",
                                     render_cull_backfaces=True, device="cpu")
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
    phase_tf32(model, assets, batch, smi)
    return launches


def phase_tf32(model, assets, batch, smi):
    """The model's forward (encoders and decoder, on one render) with cuDNN
    TF32 off and on (PyTorch's default), timed by CUDA events in turns
    (off, on, on, off), and the difference of the final poses: what a user
    would get from the global default, which make_scflow_infer_fn no longer
    follows.  The phase sets the flag around its own calls only."""
    from scflow_tpu_torch.refiners.system import render_and_normalize

    b = {k: torch.as_tensor(v, device=assets.verts.device) for k, v in batch.items()}
    saved = torch.backends.cudnn.allow_tf32
    ms, poses = {False: [], True: []}, {}
    try:
        with torch.inference_mode():
            images, depths, _ = render_and_normalize(
                assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                (IMG, IMG), backend="auto", cull_backfaces=True)

            def forward():
                return model(images, b["real_images"], b["ref_rotations"], b["ref_translations"],
                             depths, b["k"], b["labels"], output_sequences=False,
                             pose_only=True, lookup_backend="auto")

            for tf32 in (False, True, True, False):
                torch.backends.cudnn.allow_tf32 = tf32
                out = forward()  # warm-up: cuDNN plans for this setting
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                for _ in range(3):
                    out = forward()
                ev[1].record()
                torch.cuda.synchronize()
                ms[tf32].append(ev[0].elapsed_time(ev[1]) / 3)
                poses[tf32] = (out["rotations"][-1], out["translations"][-1])
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    d_rot = (poses[True][0] - poses[False][0]).abs().max().item()
    d_t = (poses[True][1] - poses[False][1]).abs().max().item()
    require(math.isfinite(d_rot) and math.isfinite(d_t), "TF32 poses finite")
    emit({"phase": "tf32", "forward_ms_tf32_off": ms[False], "forward_ms_tf32_on": ms[True],
          "rot_max_abs_diff": d_rot, "trans_max_abs_diff": d_t, "card": smi})


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
                (IMG, IMG), backend="auto", cull_backfaces=True)
            ev[1].record()
            feats = model.extract_feat(images.permute(0, 3, 1, 2).contiguous(),
                                       b["real_images"].permute(0, 3, 1, 2).contiguous())
            ev[2].record()
            model.decoder(*feats, b["ref_rotations"], b["ref_translations"], depths, b["k"],
                          b["labels"], output_sequences=False, pose_only=True)
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
            if "lookup_kernel" in name or "raster_v3_kernel" in name}
    emit({"phase": "profile", "stage_ms": stage_ms, "profiled_call_ms": wall_ms,
          "kernel_time_sum_ms": sum(ms for ms, _ in kernels.values()),
          "kernel_names": len(kernels), "ours_ms_count": ours,
          "top_kernels_ms_count": [[name[:90], ms, n] for name, (ms, n) in top], "card": smi})


# the shipped recipe (configs/refine_models/scflow.py)
SYMMETRY_TYPES = {"cls_13": {"z": 0}, "cls_16": {"x": 180, "y": 180, "z": 90},
                  "cls_19": {"y": 180}, "cls_20": {"x": 180}, "cls_21": {"x": 180, "y": 90, "z": 180}}
OPTIMIZER = dict(type="AdamW", lr=4e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
LR_CONFIG = dict(policy="OneCycle", max_lr=4e-4, total_steps=100100, pct_start=0.05,
                 anneal_strategy="linear")


def train_model(image: int, iters: int):
    """The shipped network (detach_depth_for_xy=True) with PyTorch's default
    initialisation from a seed; the pose head's output weights get
    normal(0, 0.005) so that the poses move.  PyTorch's initialisation,
    smaller than the lecun-normal one of seeded_model, keeps the float32
    gradients of two devices within the 2e-2 the card-CPU check allows."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    torch.manual_seed(0)
    model = SCFlowRefiner(num_class=NCLASS, image_size=(image, image), iters=iters,
                          detach_depth_for_xy=True)
    g = torch.Generator().manual_seed(1)
    head = model.decoder.pose_pred
    with torch.no_grad():
        for lin in (head.rotation_pred, head.translation_pred):
            lin.weight.copy_(HEAD_STD * torch.randn(lin.weight.shape, generator=g))
    return model


def train_batch(assets, n: int, image: int, seed: int = 0):
    """tests/test_train_system.py's recipe: real images rendered at gt poses
    (random rotations, t = (10 N(0,1), 10 N(0,1), U(650, 750)) mm), the
    reference pose jittered by 8 degrees N(0,1) per axis and (5, 5, 15) mm
    N(0,1), gt masks from the render; LINEMOD intrinsics."""
    from scflow_tpu_torch.refiners.system import render_and_normalize

    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    gt_R = quat_to_matrix(torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True))).float()
    gt_t = np.stack([10 * rng.normal(size=n), 10 * rng.normal(size=n),
                     rng.uniform(650, 750, n)], -1).astype(np.float32)
    a = np.deg2rad(8 * rng.normal(size=(n, 3)))  # axis-angle
    angle = np.linalg.norm(a, axis=1, keepdims=True)
    dR = quat_to_matrix(torch.from_numpy(
        np.concatenate([np.cos(angle / 2), np.sin(angle / 2) * a / angle], 1))).float()
    gt_R, dR = gt_R.numpy(), dR.numpy()
    K = np.tile(np.array([[[572.4, 0, image / 2], [0, 573.5, image / 2], [0, 0, 1]]],
                         np.float32), (n, 1, 1))
    labels = rng.integers(0, NCLASS, n).astype(np.int64)
    dev = assets.verts.device
    real, _, masks = render_and_normalize(
        assets, torch.from_numpy(gt_R).to(dev), torch.from_numpy(gt_t).to(dev),
        torch.from_numpy(K).to(dev), torch.from_numpy(labels).to(dev), (image, image),
        backend="pallas" if image % 128 == 0 else "xla", cull_backfaces=True)
    return dict(real_images=real.cpu().numpy(), ref_rotations=np.einsum("nij,njk->nik", dR, gt_R),
                ref_translations=gt_t + rng.normal(size=(n, 3)).astype(np.float32)
                * np.array([5, 5, 15], np.float32), gt_rotations=gt_R, gt_translations=gt_t,
                labels=labels, k=K, gt_masks=masks.cpu().numpy())


def _train_setup(model, bank, image: int, device=None, lr_cfg=LR_CONFIG, optimizer=OPTIMIZER,
                 **step_kw):
    """(TrainState, step, render assets, loss assets) of the shipped recipe
    on `device` (None: the card), with the kernels' lookup ('pallas')."""
    from scflow_tpu_torch.refiners.system import (RenderAssets, loss_assets_from_bank,
                                                  make_scflow_train_step)
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    assets = RenderAssets.from_bank(bank, device=device)
    loss_assets = loss_assets_from_bank(bank, SYMMETRY_TYPES, device=device)
    tx, _ = build_optimizer(model.parameters(), optimizer, lr_cfg, grad_clip=10.0)
    step = make_scflow_train_step(model, assets, loss_assets, image_size=(image, image),
                                  render_cull_backfaces=True, lookup_backend="pallas",
                                  device=device, **step_kw)
    return TrainState(model, tx), step, assets, loss_assets


def _worst_grad_rel(got, want):
    """Worst per-leaf relative L2 error, skipping leaves whose reference
    gradient is below 1e-5 of the global norm (biases before a norm: 0 up
    to rounding), which must then be small on both sides."""
    gn = math.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    worst, name = 0.0, None
    for k, w in want.items():
        w, g = w.double(), got[k].double()
        if float(w.norm()) < 1e-5 * gn:
            require(float(g.norm()) < 1e-3 * gn, f"{k}: gradient ~0 on one side only")
            continue
        rel = float((g - w).norm() / w.norm())
        if rel > worst:
            worst, name = rel, k
    return worst, name


def phase_train(smi):
    """The train step at the shipped recipe through the kernels."""
    import copy

    from torch.profiler import ProfilerActivity, profile

    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    state0, step, assets, loss_assets = _train_setup(train_model(IMG, ITERS), bank, IMG)
    batch = train_batch(assets, TRAIN_BATCH, IMG)
    torch.cuda.reset_peak_memory_stats()
    state0, _ = step(state0, batch)  # warm-up: cuDNN plans, allocator, Adam moments
    torch.cuda.synchronize()

    res, launches = {}, {}
    (state, logs), c = counted(lambda: step(copy.deepcopy(state0), batch))
    require(only(c, K1=ITERS, K1b=ITERS, K2=1), f"train step launches {c}")
    loss = float(logs["loss"])
    require(math.isfinite(loss) and math.isfinite(float(logs["grad_norm"])), f"loss {loss}")
    launches.update(K1b=c["K1b"])
    res["loss"], res["grad_norm"] = loss, float(logs["grad_norm"])
    res["log_keys"] = len(logs)
    for key, variant in (("K7", "shift"), ("K8", "bdiag")):
        vstep = _train_setup(state0.model, bank, IMG, lookup_variant=variant)[1]
        (_, vlogs), c = counted(lambda: vstep(copy.deepcopy(state0), batch))
        require(only(c, K1b=ITERS, K2=1, **{key: ITERS}), f"{variant} train step launches {c}")
        launches[key] = c[key]
        rel = abs(float(vlogs["loss"]) / loss - 1)
        require(rel <= 1e-4, f"{variant} loss {float(vlogs['loss'])} vs tent {loss}")
        res[f"{variant}_loss_rel_diff"] = rel

    # ms per step on the host clock; forward / backward / optimizer by events
    state = copy.deepcopy(state0)
    steps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, logs = step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    res["ms_per_step"] = 1e3 * dt
    res["samples_per_s"] = TRAIN_BATCH / dt
    res["stage_ms"] = _train_stages(state, assets, loss_assets, batch)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kernels = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    res["kernel_time_sum_ms"] = sum(ms for ms, _ in kernels.values())
    res["ours_ms_count"] = {name.split("(")[0]: v for name, v in kernels.items()
                            if "lookup_" in name or "raster_v3" in name}
    res["top_kernels_ms_count"] = [[name[:90], ms, n] for name, (ms, n) in top]

    # the loss falls over 6 steps at a constant lr 1e-3 (tests/test_train_system.py)
    fall_state, fall_step, _, _ = _train_setup(copy.deepcopy(state0.model), bank, IMG,
                                               lr_cfg=None, optimizer=dict(
                                                   type="AdamW", lr=1e-3, weight_decay=1e-4))
    losses = []
    for _ in range(6):
        fall_state, flogs = fall_step(fall_state, batch)
        losses.append(float(flogs["loss"]))
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0], f"losses {losses}")
    res["losses_lr_1e-3"] = losses
    del fall_state, state
    res["card_vs_cpu"] = _train_card_vs_cpu(bank)
    emit({"phase": "train", "batch": TRAIN_BATCH, "image": IMG, "iters": ITERS,
          "classes": NCLASS, "launches_per_step": {"K1": ITERS, "K1b": ITERS, "K2": 1},
          **res, "card": smi})
    return launches


def _train_stages(state, assets, loss_assets, batch):
    """Median of 3 (after a warm-up) of the step's parts, by CUDA events:
    render + gt flow, forward + losses, backward, optimizer update."""
    from scflow_tpu_torch.geometry import filter_flow_by_mask, flow_from_pose_and_depth
    from scflow_tpu_torch.refiners.system import render_and_normalize, scflow_sequence_losses

    dev = assets.verts.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    names = ("render", "forward", "backward", "optimizer")
    times = {k: [] for k in names}
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        with torch.no_grad():
            img, depths, masks = render_and_normalize(
                assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                (IMG, IMG), backend="auto", cull_backfaces=True)
            gt_flow = filter_flow_by_mask(flow_from_pose_and_depth(
                b["ref_rotations"], b["ref_translations"], b["gt_rotations"],
                b["gt_translations"], depths, b["k"]), b["gt_masks"])
        ev[1].record()
        out = state.model(img, b["real_images"], b["ref_rotations"], b["ref_translations"],
                          depths, b["k"], b["labels"], train=True, lookup_backend="pallas")
        loss, _ = scflow_sequence_losses(out, b["gt_rotations"], b["gt_translations"], gt_flow,
                                         masks, b["labels"], loss_assets)
        ev[2].record()
        state.tx.zero_grad()
        loss.backward()
        ev[3].record()
        state.apply_gradients()
        ev[4].record()
        torch.cuda.synchronize()
        for name, a, z in zip(names, ev, ev[1:]):
            times[name].append(a.elapsed_time(z))
    return {k: statistics.median(v[1:]) for k, v in times.items()}


def _train_card_vs_cpu(bank):
    """One step on the card and one on the CPU (the plain versions: render
    'pallas' runs the plain v3 raster there, the lookup plain K1 and K1b)
    from the same weights and batch, at batch 2, 128^2, 3 iterations."""
    import copy

    n, image, iters = 2, 128, 3
    model = train_model(image, iters)
    cpu_model = copy.deepcopy(model)
    card_state, card_step, card_assets, _ = _train_setup(model, bank, image,
                                                         render_backend="pallas")
    batch = train_batch(card_assets, n, image, seed=1)
    _, card_logs = card_step(card_state, batch)
    cpu_state, cpu_step, _, _ = _train_setup(cpu_model, bank, image, "cpu",
                                             render_backend="pallas")
    _, cpu_logs = cpu_step(cpu_state, batch)
    torch.cuda.synchronize()
    got = {k: p.grad.cpu() for k, p in card_state.model.named_parameters()}
    want = {k: p.grad for k, p in cpu_state.model.named_parameters()}
    worst, leaf = _worst_grad_rel(got, want)
    loss_rel = abs(float(card_logs["loss"]) / float(cpu_logs["loss"]) - 1)
    require(loss_rel <= 1e-3 and worst <= 2e-2,
            f"card vs CPU step: loss rel {loss_rel}, worst gradient rel {worst} ({leaf})")
    return {"loss_card": float(card_logs["loss"]), "loss_cpu": float(cpu_logs["loss"]),
            "loss_rel_diff": loss_rel, "worst_grad_rel_l2": worst, "worst_leaf": leaf,
            "leaves": len(want)}


def _render_close(got, want, what: str):
    """The CPU parity bounds of tests/test_torch_render.py's brute-force
    renders: masks on all but 2e-3 of the pixels, depth to 1e-3 where both
    cover, images to 1e-3 on all but 2e-3 of the pixels."""
    both = (got["masks"] > 0) & (want["masks"] > 0)
    shares = {"mask": (got["masks"] != want["masks"]).float().mean().item(),
              "image": ((got["images"] - want["images"]).abs().amax(-1) > 1e-3)
              .float().mean().item()}
    depth = (got["depths"][both] - want["depths"][both]).abs().max().item()
    require(shares["mask"] < 2e-3 and shares["image"] < 2e-3 and depth <= 1e-3,
            f"{what}: {shares}, depth max |d| {depth}")
    return {**shares, "depth_max_abs_diff": depth}


def phase_render(dev, scene, smi):
    """Each entry point of the render surface once, its launches counted."""
    from scflow_tpu_torch.ops import raster_pack as pk
    from scflow_tpu_torch.ops.cuda import rasterize as k2
    from scflow_tpu_torch.render.rasterizer import rasterize
    from scflow_tpu_torch.render.renderer import BANK_FIELDS, render_batch

    bank = tuple(torch.from_numpy(getattr(scene["bank"], f)).to(dev) for f in BANK_FIELDS)
    pose = (scene["R"], scene["t"], scene["K"], scene["labels"])

    def render(h=IMG, w=IMG, pose=pose, bank=bank, **kw):
        return render_batch(*bank, *pose, h, w, cull_backfaces=True, **kw)

    res, launches = {}, {}
    v4, c = counted(lambda: render(backend="pallas", raster_version=4))
    require(only(c, K3=1), f"render_batch v4 launches {c}")
    launches["K3"] = c["K3"]
    v3, c = counted(lambda: render(backend="pallas", raster_version=3))
    require(only(c, K2=1), f"render_batch v3 launches {c}")
    require(torch.equal(v4["masks"], v3["masks"]), "v4 and v3 masks equal")
    res["v4_vs_v3_tie_share"] = {
        "depth": ((v4["depths"] - v3["depths"]).abs() > 1e-3).float().mean().item(),
        "image": ((v4["images"] - v3["images"]).abs().amax(-1) > 1e-3).float().mean().item()}
    require(max(res["v4_vs_v3_tie_share"].values()) < 2e-3,
            f"v4 vs v3 tie shares {res['v4_vs_v3_tie_share']}")

    args = (scene["verts_cam"], scene["faces"], scene["face_valid"], scene["K"])
    fp, c = counted(lambda: rasterize(*args, IMG, IMG, backend="pallas", cull_backfaces=True))
    require(only(c, K4=1), f"rasterize('pallas') launches {c}")
    launches["K4"] = c["K4"]
    fx, c = counted(lambda: rasterize(*args, IMG, IMG, backend="xla", cull_backfaces=True))
    require(only(c), f"rasterize('xla') launches {c}")
    # the two backends test coverage with different formulas for the same
    # barycentrics (plane coefficients, a division), so a pixel whose
    # barycentric is within rounding of 0 can flip: every flip must lie on
    # the edge of the face that covers it (exact barycentric below 1e-4)
    flip = (fp.face_id >= 0) != (fx.face_id >= 0)
    edge_w = torch.where((fp.face_id >= 0)[..., None], fp.bary, fx.bary).abs().amin(-1)[flip]
    res["rasterize_fg_flips"] = int(flip.sum().item())
    res["rasterize_fg_flip_max_edge_w"] = edge_w.max().item() if edge_w.numel() else 0.0
    require(res["rasterize_fg_flips"] <= 1e-5 * flip.numel()
            and res["rasterize_fg_flip_max_edge_w"] < 1e-4,
            f"rasterize backends' foreground: {res['rasterize_fg_flips']} flips, largest "
            f"edge barycentric {res['rasterize_fg_flip_max_edge_w']}")
    res["rasterize_face_id_diff_share"] = (fp.face_id != fx.face_id).float().mean().item()
    require(res["rasterize_face_id_diff_share"] < 2e-3,
            f"rasterize backends' face ids differ on {res['rasterize_face_id_diff_share']}")

    rows, active, _ = pk.pack_shaded_and_bin(scene["tri_xy"], scene["tri_z"], scene["face_valid"],
                                             scene["corner"], IMG, IMG, 8, 128, 128,
                                             cull_backfaces=True)
    bits = pk.id_bits_for(rows.shape[-1])
    for version in (1, 2):
        _, c = counted(lambda: k2.rasterize_shaded(rows, active, IMG, IMG, 8, 128, 128, bits,
                                                   version=version))
        name = f"K{4 + version}"
        require(only(c, **{name: 1}), f"rasterize_shaded(version={version}) launches {c}")
        launches[name] = c[name]

    for mode in ("flat", "gouraud"):
        out, c = counted(lambda: render(backend="pallas", shading=mode))
        img = out["images"]
        require(only(c) and bool(torch.isfinite(img).all()) and img.min() >= 0 and img.max() <= 1
                and out["masks"].mean() > 0.05, f"{mode} shading: finite, in [0, 1], launches {c}")

    # a crop the 8x128 tiles do not divide: 'auto' is 'pallas' on the card,
    # and render_batch sends the crop to the brute-force path
    k192 = scene["K"].clone()
    k192[:, :2, 2] = 96.0
    pose192 = (scene["R"], scene["t"], k192, scene["labels"])
    out192, c = counted(lambda: render(192, 192, pose=pose192, backend="auto"))
    require(only(c) and out192["masks"].mean() > 0.05, f"192^2 'auto' render launches {c}")
    cpu_bank = tuple(a.cpu() for a in bank)
    ref = render(192, 192, pose=tuple(a[:2].cpu() for a in pose192), bank=cpu_bank,
                 backend="auto")
    res["crop192_vs_cpu"] = _render_close({k: v[:2].cpu() for k, v in out192.items()}, ref,
                                          "192^2 card vs CPU")

    res["ms_per_call"] = {
        "render_batch_v3": median_ms(lambda: render(backend="pallas", raster_version=3), 5),
        "render_batch_v4": median_ms(lambda: render(backend="pallas", raster_version=4), 5),
        "render_batch_xla": median_ms(lambda: render(backend="xla"), 1, groups=3),
        "render_batch_192_auto": median_ms(lambda: render(192, 192, pose=pose192,
                                                          backend="auto"), 1, groups=3),
        "rasterize_pallas": median_ms(lambda: rasterize(*args, IMG, IMG, backend="pallas",
                                                        cull_backfaces=True), 5),
        "rasterize_xla": median_ms(lambda: rasterize(*args, IMG, IMG, backend="xla",
                                                     cull_backfaces=True), 1, groups=3),
    }
    emit({"phase": "render", "batch": BATCH, "image": IMG, "launches_per_call": launches,
          **res, "card": smi})
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--lookup-only", action="store_true",
                        help="run only the device, build and lookup phases (K1, K7, K8, "
                             "K1b)")
    parser.add_argument("--raster-only", action="store_true",
                        help="run only the device, build and raster kernel phases (K2-K6)")
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parent,
                        help="the checkout whose scflow_tpu_torch to build and run "
                             "(default: this script's), e.g. an unpacked parent commit")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import scflow_tpu_torch  # noqa: F401  (fails at once outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    emit({"phase": "package", "path": str(Path(scflow_tpu_torch.__file__).parent)})
    ptxas = phase_build(strict=args.root.resolve() == Path(__file__).resolve().parent)
    if args.lookup_only:
        phase_lookup(dev, ptxas)
        phase_k1b(dev, ptxas)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    scene = _flagship_scene(dev)
    if args.raster_only:
        _, k2_out = phase_k2(dev, scene)
        phase_k3(dev, scene, k2_out)
        phase_k4(dev, scene)
        phase_k56(dev, scene, k2_out)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    res = phase_lookup(dev, ptxas)
    res["K1b"] = phase_k1b(dev, ptxas)
    res["K2"], k2_out = phase_k2(dev, scene)
    res["K3"] = phase_k3(dev, scene, k2_out)
    res["K4"] = phase_k4(dev, scene)
    k56 = phase_k56(dev, scene, k2_out)
    res["K5"], res["K6"] = k56[1], k56[2]
    del k2_out
    launches = phase_slice(smi)
    launches.update(phase_render(dev, scene, smi))
    del scene
    launches.update(phase_train(smi))
    src = "scflow_tpu_torch/csrc/"
    tpu = "scflow_tpu/ops/pallas/"
    table = [
        ("K1", "corr_lookup", "corr_lookup.cu", "corr_lookup.py:230 (_kernel)"),
        ("K2", "rasterize_shaded_v3", "rasterize_v3.cu", "rasterize.py:473 (_kernel_shaded_v3)"),
        ("K3", "rasterize_shaded_v4", "rasterize_v4.cu", "rasterize.py:610 (_kernel_shaded_v4)"),
        ("K4", "rasterize_packed", "rasterize_packed.cu", "rasterize.py:57 (_kernel)"),
        ("K5", "rasterize_shaded(version=1)", "rasterize_v12.cu",
         "rasterize.py:142 (_kernel_shaded)"),
        ("K6", "rasterize_shaded(version=2)", "rasterize_v12.cu",
         "rasterize.py:284 (_kernel_shaded_v2)"),
        ("K7", "corr_lookup(variant='shift')", "corr_lookup_shift.cu",
         "corr_lookup.py:147 (_kernel_shift)"),
        ("K8", "corr_lookup(variant='bdiag')", "corr_lookup_bdiag.cu",
         "corr_lookup.py:41 (_kernel_bdiag)"),
        ("K1b", "corr_lookup backward", "corr_lookup_bwd.cu",
         "corr_lookup.py:346 (_lookup_bwd, the XLA backward of corr_lookup_pallas_diff)"),
    ]
    emit({"kernels": [
        {"name": f"{key} {fn}", "route": "cuda", "source": src + file, "replaces": tpu + where,
         "launches": launches[key], **res[key]}
        for key, fn, file, where in table], "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
