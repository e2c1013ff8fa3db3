#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (scflow_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases GROUP[,GROUP...] [--root DIR]

--phases runs phases 1 and 2 and then only the named groups, in the order
given, of the package in DIR (default: this checkout; e.g. an unpacked
parent commit), without the kernels line: lookup (phases 3, 10 and 11),
raster (4-7), slice (8), raft (14), options (16 and 17; with slice
before it, 17 prints its pose difference from the slice's call), workflow
(18) and train_workflow (19).

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
               memory; then the same on the maps rounded to bfloat16 (phase
               "K1_bf16": K1's bf16 instance against the plain version on
               the same bf16 maps, F.grid_sample on them, the bound with
               2-byte cells);
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
  8. slice   - make_scflow_infer_fn(slim=True) at the bench configuration (batch
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
               shapes and both map dtypes, run with K1 in phase 3): K7 bit-
               identical to its plain version, K8 within 1e-4 of the tent
               plain version; the same numbers as K1 ("K7_bf16",
               "K8_bf16" on bf16 maps); at the flagship shape also at radius 3
               (RAFT-S's and the option set's window: "K1_r3", "K7_r3",
               "K8_r3" and their "_bf16_r3" instances), bound and
               F.grid_sample at radius 3;
 11. K1b     - the lookup's backward at the training shape (16 x 32^2 rows,
               random, border and integer centres) against its plain
               version, level and flow grads within 1e-4, the same bits
               from two launches; times (without the flow grad, as the
               train step runs it) back-to-back and as device time, the
               autograd backward of the 4 F.grid_sample calls, the bound,
               GB/s and share of the bound, registers and shared memory;
               then "K1b_bf16" on the bf16 maps: level grads bf16, within
               one bf16 ulp of the plain version's (the share that differs
               printed), the flow grad within 1e-4, the bound with 2-byte
               level grads; then both again at radius 3 ("K1b_r3",
               "K1b_bf16_r3");
  9a. slice_bf16 - phase 8 with the same seeded weights in bf16
               (SCFlowRefiner(dtype=torch.bfloat16), bench.py's dtype): 8
               launches of K1's bf16 instance and 1 K2 per call, nothing
               else; finite, orthonormal poses; the first 4 samples against
               the CPU run of the plain versions at bf16 (|card - CPU| <=
               2 |card bf16 - card fp32| + the slice tolerances);
               refinements/s, ms per call, the stages (its profile line:
               render, encoders, decoder and the GRU's part) and the pose
               difference against the fp32 call beside TF32's;
  9b. infer_full - make_scflow_infer_fn(slim=False), its default, at batch
               4: final masks (N, H, W) and flow (N, H, W, 2), finite and
               equal to the CPU run (masks atol 1e-3, flow 2e-2 px);
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
 12c. train_bf16 - phase 12 with a bf16 model of the same weights: 1 K2, 8
               of K1's and 8 of K1b's bf16 instances per step ('shift' and
               'bdiag' steps: 8 of K7's / K8's), float32 parameters,
               gradients and statistics, the falling loss, ms per step,
               samples/s, peak memory, and a bf16 card step against a bf16
               CPU step at batch 2, 128^2, 3 iterations (loss and all
               gradients within the CPU's own bf16-to-fp32 distance);
 14. the RAFT baseline (configs/refine_models/raft.py: RAFTRefinerFlowMask,
     256-channel encoders, h/context 128, 12 iterations, seeded weights):
     raft - make_raft_infer_fn(lookup 'pallas', pnp_backend 'device', the
               shipped test_cfg's PnP: occ_thresh 0.5, 1000 points,
               reprojection error 3 px, 64 hypotheses) at batch 64, 256^2,
               21 classes, culling on, fp32, on train_batch's scene: 12 K1
               and 1 K2 per call, nothing else; finite flow, occlusion in
               [0, 1], orthonormal poses; the first 4 samples' flow and
               occlusion against the CPU run of the plain versions (atol
               2e-2 px, 1e-3); the device PnP recovering the gt pose from
               the gt flow (|dR| <= 2e-3, 1 mm); the card's RANSAC equal to
               the CPU's on shared hypothesis indices with 30% outliers
               (|dR| <= 1e-3, 0.5 mm, the same ok, inliers differing on <=
               1%); ms per call, refinements/s, the stages (render,
               encoders, decoder, PnP), the profile;
     raft_bf16 - one call with the weights in bf16 (12 K1 bf16 instances, 1
               K2), its flow and occlusion against the fp32 call's, ms;
     raft_val - make_raft_val_step on the same model and batch (12 K1, 1
               K2), finite metrics;
     raft_train - make_raft_train_step at the shipped recipe (batch 16,
               256^2, 12 iterations, AdamW 4e-4 + OneCycle + clip 1.0,
               lookup 'pallas'): exactly 12 K1, 12 K1b (no flow gradient)
               and 1 K2 per step; ms per step, samples/s, the stages, the
               profile, the loss falling over the recipe's first 6 steps,
               a card step against a CPU step at batch 2, 128^2, 3
               iterations (loss rtol 1e-3, worst per-leaf gradient rel L2
               <= 2e-2);
 16. raft_small - RAFT-S (RAFT_SMALL: the RAFT paper's small model,
               Bottleneck encoders, h 96 / context 64, radius 3, the Conv GRU,
               bilinear upsampling) through the raft phases' entry points and
               shapes: 12 K1 (radius 3) and 1 K2 per call, the first 4
               samples' flow and occlusion against the CPU (2e-2 px, 1e-3),
               ms, stages; one bf16 call (12 K1 bf16; 4 samples within twice
               the CPU's bf16-to-fp32 distance of its bf16 run); the train step at the
               RAFT recipe (12 K1, 12 K1b at radius 3, 1 K2), ms, stages, the
               loss falling over 6 steps, a card step against a CPU step;
 17. scflow_options - the SCFlow option set (SCFLOW_OPTIONS: separate
               encoders, radius 3, mask_flow and mask_corr with the mask not
               detached, fused GRU gates, the 'linear' depth transform, the
               quaternion head) at the slice's configuration: 8 K1 (radius 3)
               and 1 K2 per call, the first 4 samples against the CPU (the
               slice's bounds), ms, stages, the pose difference from the
               slice's call on the same inputs; the train step at batch 16 (8
               K1, 8 K1b at radius 3, 1 K2), ms, stages, a card step against
               a CPU step;
 18. workflow - the reference's test workflow, `cli.test_main --eval
               --format-only --save-dir --out` (tools/test.py's arguments),
               on the card from a config that _base_s the shipped
               configs/refine_models/scflow.py and overrides only the data
               paths (so 256^2, 8 iterations, 21 classes, max_bucket 64,
               culling on), over a synthetic test set in YCB-V's BOP layout
               written under build/workflow/ (removed afterwards): 48
               640x480 PNGs (the port's imwrite) of 3-9 of the slice's
               21 uvsphere classes each, rendered at the gt pose with YCB-V's
               camera over grey, initial poses the gt jittered by up to 15
               degrees and 15/15/50 mm (the shipped PoseJitter's ranges).
               The slice's seeded weights, saved with save_params.  Runs,
               each after a 2-image warm-up: fp32 and bf16 (--cfg-options
               model.dtype=bfloat16) on the 48 images, and the shipped
               configs/refine_models/raft.py with test_cfg.pnp_backend=device
               on 8 (raft_model's weights).  Per run: ms/img and
               refinements/s (host clock over test_main's loop, which
               loads, calls, fetches and remaps each image in turn), the
               load ms/img and the call's ms/img (launch + fetch), the
               metric table, imread's median ms on 8 of the PNGs (alone,
               before the runs), the entry point alone on one image's batch
               padded to 8 (ms back to back and device ms; lines
               "workflow_*_alone"), and exactly 8 K1 (or K1_bf16) and
               1 K2 per image for SCFlow, 12 K1 and 1 K2 for RAFT, nothing
               else.  Gates: (a) the first 4 images with --device cpu give
               poses within the slice's card-vs-CPU bounds (rotations 2e-3,
               translations 2e-2 + 2e-3 |t|): fp32; bf16 against the
               CPU's bf16 run with twice the CPU's own bf16-to-fp32
               distance (largest |dR|, largest |dt|) added to each bound;
               and RAFT with the device PnP with the flow head's output
               zeroed (flow 0: exact correspondences, where random flow
               makes RANSAC turn 1e-6 differences into other poses), whose
               poses are also the initial ones (|dR| 2e-3, |dt| 1 mm, the
               raft phase's gt-flow bounds); (b) with the pose head's
               output weights zeroed (biases the identity) the workflow
               returns the initial poses (rotations within 1e-5,
               translations within 1e-5 |t| + 1e-3 mm), and evaluate's
               ADD(-S)/REP/AUC equal this script's own numpy computation
               of those poses' errors within 1e-6; (c) each BOP export
               parses back with one entry per object equal to --out; (d)
               a checkpoint saved from the card loads on the CPU, equal;
 19. train_workflow - the reference's train workflow, `cli.train_main`
               (tools/train.py's arguments), on the card from a config that
               _base_s the shipped configs/refine_models/scflow.py and
               overrides only the data paths, the meshes, the work_dir and
               the intervals (log 5, checkpoints 10, evaluation 20): so
               256^2, 8 iterations, batch 16, workers_per_gpu 8, AdamW
               4e-4 + OneCycle + clip 10, the shipped train
               pipeline (PoseJitter, ComputeBbox, Crop, RandomHSV,
               RandomNoise, RandomSmooth, Resize, Pad, RemapPose), PyTorch's
               seeded initialisation (the config's pretrained file is not
               in the repo: train_main warns), over a synthetic train_real
               split of 48 frames (phase 18's scene with visible masks)
               with the val set phase 18's test set cut to 8 images.  The
               checking runs load with data.worker_mode='process' (TW_FAST:
               the config's thread workers took 10.9 s a step).  Runs,
               each counting every kernel's launches per step (reset before
               each step, read after it): fp32, 30 steps with
               --profile-steps 3: exactly 1 K2, 8 K1, 8 K1b per step,
               finite losses, the mean of the last 5 below that of the
               first 5, checkpoints iter_10/20/30, eval_history.json,
               best.json and best_ckpt.pth, a profiler trace, TensorBoard
               event files or the hook's warning, the logged it/s; --resume
               --max-iters 40: the log's "Resumed from iter 30" and "Start
               training: iter 30 -> 40", the weights equal iter_30.pth bit
               for bit, the first step's lr the schedule's at count 30; the
               card step against the CPU step (the plain versions) on the
               loader's first 2 samples with 3 iterations (loss rtol 1e-3,
               worst per-leaf gradient rel L2 2e-2); bf16
               (model.dtype=bfloat16), 10 steps: 8 K1_bf16, 8 K1b_bf16, 1 K2
               per step, finite, falling (first 3 against last 3); the
               shipped raft.py, 5 steps: 12 K1, 12 K1b, 1 K2 per step,
               finite; then data.worker_mode 'thread' and 'process', each 3
               warm-up steps, then 20 timed (ms per step on the host clock
               over the runner loop, samples/s, load ms per step blocked in
               next(data_iter), device ms per step by CUDA events around
               the step), the last 5 of them traced (the device's idle
               share: 1 - the union of the kernels' intervals over the host
               window),
               with os.cpu_count();
 15. the kernels line (float32 and bf16 instances; "raft_launches": each
     kernel's launches per RAFT call or step; "radius_3": the radius-3
     instance's numbers from phases 3/10/11 and its launches per call or
     step on phases 16 and 17; "workflow_launches_per_image": per image of
     each workflow run; "train_workflow_launches_per_step": per step of
     the fp32, bf16 and RAFT train_workflow runs), then the device line the
     chip harness reads.
Imports no JAX.  Needs one card; without one it exits non-zero at once.
"""

import argparse
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# not in the train workflow's spawned loader workers, which import this
# script again (with torch imported there, eight workers took about a minute
# to deliver the first batch on the card's host)
if __name__ != "__mp_main__":
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
# window pipeline, K1b: its instance without the flow gradient; "_bf16": the
# instance for bfloat16 maps; or a parent's kernel of before the cell type
# was a template argument, or its first kernel), by a fragment of its
# mangled name
LOOKUP_ENTRIES = {"K1": ("ILi4E9TentBlendfE", "ILi4E9TentBlendEv", "corr_lookup_kernel"),
                  "K7": ("ILi4E10ShiftBlendfE", "ILi4E10ShiftBlendEv",
                         "corr_lookup_shift_kernel"),
                  "K8": ("ILi4E10BdiagBlendfE", "ILi4E10BdiagBlendEv",
                         "corr_lookup_bdiag_kernel"),
                  "K1b": ("lookup_bwd_kernelILi4ELb0EfE", "lookup_bwd_kernelILi4ELb0EEv",
                          "corr_lookup_bwd_kernel"),
                  "K1_bf16": ("ILi4E9TentBlend13__nv_bfloat16E",),
                  "K7_bf16": ("ILi4E10ShiftBlend13__nv_bfloat16E",),
                  "K8_bf16": ("ILi4E10BdiagBlend13__nv_bfloat16E",),
                  "K1b_bf16": ("lookup_bwd_kernelILi4ELb0E13__nv_bfloat16E",)}
VARIANT_OF = {"K1": "tent", "K7": "shift", "K8": "bdiag"}
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
    key (without its radius suffix) runs at `radius`, and the dynamic shared
    memory its launch asks for at 4 levels, as the built library reports it
    (None for a package that does not report it, e.g. a parent's)."""
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1

    key = key.split("_r")[0]
    base, bf16 = key.split("_")[0], key.endswith("_bf16")
    kw = {"dtype": torch.bfloat16} if bf16 else {}
    try:
        if base == "K1b":
            dyn = k1.bwd_layout(levels, radius, False, **kw)["smem_bytes"]
        else:
            dyn = k1.window_layout(VARIANT_OF[base], levels, radius, **kw)["smem_bytes"]
    except (AttributeError, TypeError):  # no such layout function in this package
        dyn = None
    tags = [tag.replace("ILi4E", f"ILi{radius}E") for tag in LOOKUP_ENTRIES[key]]
    for entry, res in ptxas.items():
        if any(tag in entry for tag in tags):
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
    """Bytes: coords once, the output once (float32), and the map cells
    these windows touch with a non-zero weight (x from floor(x) - r to
    ceil(x) + r, inside the map), at the maps' cell size (4 bytes, or 2 for
    bfloat16 maps).  Operations: 3 lerps of 3 flops (a weight, 2 mul, 1 add)
    per output element."""
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
    nbytes = coords.numel() * 4 + out_elems * 4 + cells * levels[0].element_size()
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
        grid = torch.stack([2 * gx / (s - 1) - 1, 2 * gy / (s - 1) - 1], -1)
        grid = grid.to(m.dtype).contiguous()  # grid_sample takes the maps' dtype
        maps = m.view(-1, 1, s, s)
        calls.append(lambda maps=maps, grid=grid: torch.nn.functional.grid_sample(
            maps, grid, mode="bilinear", padding_mode="zeros", align_corners=True))
    return calls


def _map_dtypes(k1):
    """The map dtypes the package's lookups take: float32, and bfloat16
    where it builds the bf16 instances (a parent's package may not)."""
    return (torch.float32, torch.bfloat16) if hasattr(k1, "KERNEL_BF16") else (torch.float32,)


def phase_lookup(dev, ptxas):
    """K1 (tent), K7 (shift) and K8 (bdiag) on the same inputs, at the
    flagship's 65,536 rows and at the train step's 16,384, on float32 maps
    and on the same maps rounded to bfloat16 (the bf16 instances, keys
    "K1_bf16", ...): each against its plain version on the same maps (K7 bit
    for bit, K1 and K8 within 1e-4), timed beside the same F.grid_sample
    calls (on the maps' dtype) and bound.  ms and library_ms time
    back-to-back calls (median_ms, as every kernel's ms); device_ms and
    library_device_ms the same calls queued behind a device sleep
    (device_ms).  Each line adds the achieved GB/s and share of the bound by
    both times, and ptxas's registers and shared memory.  Returns the
    flagship numbers for the kernels line."""
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1

    variants = (("K1", "tent", k1.corr_lookup_flat_plain, 1e-4),
                ("K7", "shift", k1.corr_lookup_flat_shift_plain, 0.0),
                ("K8", "bdiag", k1.corr_lookup_flat_plain, 1e-4))
    out = {}
    for n, shape, radius in ((BATCH, "flagship", 4), (TRAIN_BATCH, "train_shape", 4),
                             (BATCH, "flagship", 3)):
        levels32, coords = _flagship_lookup_inputs(dev, n)
        rows = coords.shape[0]
        for dtype in _map_dtypes(k1):
            suffix = ("_bf16" if dtype == torch.bfloat16 else "") + (
                "" if radius == 4 else f"_r{radius}")
            levels = [m.to(dtype) for m in levels32]
            calls = _grid_sample_lookup(levels, coords, radius)
            tent = k1.corr_lookup_flat_plain(levels, coords, radius)
            lib = torch.cat([f().reshape(rows, -1).float() for f in calls], dim=1)
            lib_err = (lib - tent).abs().max().item()
            library_ms = sum(median_ms(f, 10) for f in calls)
            library_device_ms = sum(device_ms(f, 20) for f in calls)
            bound_ms, bound_by, nbytes = _lookup_bound(levels, coords, radius)
            for key, variant, plain, tol in variants:
                key += suffix
                got = k1.corr_lookup_flat(levels, coords, radius, variant=variant)
                want = plain(levels, coords, radius)
                torch.cuda.synchronize()
                err = _max_abs(got, want)
                if tol == 0.0:
                    require(torch.equal(got, want), f"{key} bit-identical at {rows} rows "
                                                    f"(max |d| {err})")
                require(math.isfinite(err) and err <= tol, f"{key} max |d| {err} <= {tol}")

                def kernel():
                    return k1.corr_lookup_flat(levels, coords, radius, variant=variant)

                res = {"max_abs_err": err, "ms": median_ms(kernel, 20),
                       "device_ms": device_ms(kernel, 50),
                       "plain_ms": median_ms(lambda: plain(levels, coords, radius), 3),
                       "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
                if shape == "flagship":
                    out[key] = res
                emit({"phase": key, "variant": variant, "maps": str(dtype), "shape": shape,
                      "rows": rows, "radius": radius, "tolerance": tol,
                      "grid_sample_max_abs_diff_vs_tent": lib_err, **res,
                      "library_device_ms": library_device_ms, "bytes": nbytes,
                      "gb_per_s": nbytes / res["ms"] / 1e6,
                      "share_of_bound": bound_ms / res["ms"],
                      "device_gb_per_s": nbytes / res["device_ms"] / 1e6,
                      "device_share_of_bound": bound_ms / res["device_ms"],
                      "ptxas": _lookup_resources(key, ptxas, radius=radius)})
            del levels, calls, tent, lib
        del levels32, coords
    return out


def _bf16_ulp_excess(got, want):
    """Level grads on bf16 maps: the largest |got - want| in units of one
    bf16 ulp of the larger magnitude (1e-6 of slack where the terms cancel
    to about 0), and the share of elements that differ at all."""
    a, b = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(a), torch.frexp(torch.maximum(a.abs(), b.abs()))[1] - 8)
    d = (a - b).abs()
    return ((d - 1e-6) / ulp).max().item(), (d > 0).float().mean().item()


def phase_k1b(dev, ptxas):
    """K1b at the training shape: 16 images at 32^2, so 16,384 rows, on
    float32 maps ("K1b": level and flow grads within 1e-4 of the plain
    version) and on the same maps rounded to bfloat16 ("K1b_bf16": bf16
    level grads within one bf16 ulp of the plain version's, each rounded
    once from its float32 sum; the share that differs; the flow grad within
    1e-4); the same bits from two launches.  Returns {key: numbers}."""
    from scflow_tpu_torch.ops.cuda import corr_lookup as k1

    levels32, coords = _flagship_lookup_inputs(dev, TRAIN_BATCH)
    rows = coords.shape[0]
    out = {}
    for radius, dtype in itertools.product((4, 3), _map_dtypes(k1)):
        k = 2 * radius + 1
        g = torch.randn((rows, 4 * k * k), generator=torch.Generator().manual_seed(3)).to(dev)
        key = ("K1b_bf16" if dtype == torch.bfloat16 else "K1b") + (
            "" if radius == 4 else f"_r{radius}")
        levels = [m.to(dtype) for m in levels32]
        errs, ulps = {}, {}
        for want_coords in (True, False):
            got, got_c = k1.corr_lookup_flat_bwd(levels, coords, g, radius, want_coords)
            again, again_c = k1.corr_lookup_flat_bwd(levels, coords, g, radius, want_coords)
            want, want_c = k1.corr_lookup_flat_bwd_plain(levels, coords, g, radius, want_coords)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, again)) and
                    (not want_coords or torch.equal(got_c, again_c)),
                    f"{key}: two launches give the same bits (want_coords={want_coords})")
            require(all(a.dtype == dtype for a in got), f"{key}: level grads in {dtype}")
            errs[want_coords] = max(_max_abs(a, b) for a, b in zip(got, want))
            if dtype == torch.bfloat16:
                ex = [_bf16_ulp_excess(a, b) for a, b in zip(got, want)]
                ulps[want_coords] = {"max_ulps": max(e[0] for e in ex),
                                     "share_differing": [e[1] for e in ex]}
                require(ulps[want_coords]["max_ulps"] <= 1.0,
                        f"{key} level grads within one bf16 ulp: {ulps[want_coords]}")
            if want_coords:
                errs["coords"] = _max_abs(got_c, want_c)
                require(math.isfinite(errs["coords"]) and errs["coords"] <= 1e-4,
                        f"{key} flow grad max |d| {errs['coords']} <= 1e-4")
        err = max(errs.values())
        require(math.isfinite(err) and (dtype == torch.bfloat16 or err <= 1e-4),
                f"{key} max |d| {errs} <= 1e-4")
        # the autograd backward of the 4 F.grid_sample calls into the maps
        maps = [m.detach().clone().requires_grad_() for m in levels]
        outs = [f() for f in _grid_sample_lookup(maps, coords, radius)]
        gs = [gi.reshape(o.shape).to(o.dtype).contiguous()
              for gi, o in zip(g.split(k * k, dim=1), outs)]

        def library():
            torch.autograd.grad(outs, maps, gs, retain_graph=True)

        def kernel():
            return k1.corr_lookup_flat_bwd(levels, coords, g, radius, want_coords=False)

        def with_flow_grad():
            return k1.corr_lookup_flat_bwd(levels, coords, g, radius)

        # bytes: g and coords read once, the dense level grads (the maps'
        # dtype) written once
        nbytes = g.numel() * 4 + coords.numel() * 4 + sum(m.numel() * m.element_size()
                                                          for m in levels)
        cells = rows * sum((2 * radius + 2) ** 2 for _ in levels)
        bound_ms, bound_by = bound(nbytes, cells * 4 * 5)  # up to 4 taps x (weight, mul, add)
        res = {
            "max_abs_err": err,
            "ms": median_ms(kernel, 20),
            "device_ms": device_ms(kernel, 50),
            "plain_ms": median_ms(lambda: k1.corr_lookup_flat_bwd_plain(
                levels, coords, g, radius, want_coords=False), 3),
            "library_ms": median_ms(library, 5),
            "library_device_ms": device_ms(library, 5),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit({"phase": key, "maps": str(dtype), "rows": rows, "radius": radius,
              "max_abs_err_by_case": {str(c): v for c, v in errs.items()},
              "bf16_ulps_by_case": {str(c): v for c, v in ulps.items()},
              "ms_with_flow_grad": median_ms(with_flow_grad, 20),
              "device_ms_with_flow_grad": device_ms(with_flow_grad, 50), **res,
              "bytes": nbytes, "gb_per_s": nbytes / res["ms"] / 1e6,
              "share_of_bound": bound_ms / res["ms"],
              "device_gb_per_s": nbytes / res["device_ms"] / 1e6,
              "device_share_of_bound": bound_ms / res["device_ms"],
              "ptxas": _lookup_resources(key, ptxas, radius=radius)})
        out[key] = res
        del levels, maps, outs
    return out


def quat_to_matrix(q: "torch.Tensor") -> "torch.Tensor":
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


def seeded_model(dtype=None, **options):
    """The bench network (in `dtype`: None float32, or torch.bfloat16; with
    the refiner's `options`, e.g. SCFLOW_OPTIONS) with weights from a
    seeded generator, the same for either dtype: lecun-normal convs and
    linears, zero biases (the pose head's identity rotation bias kept),
    default norms; the pose head's output weights get normal(0, HEAD_STD)
    so that the poses move.  Larger output weights (0.02, as the parity
    tests use at 3 iterations) make the random-weight recurrence chaotic
    over 8 iterations: rounding-sized input differences grow into visible
    pose differences, and no two devices could be compared."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    model = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=ITERS, dtype=dtype,
                          **options)
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

    counters = {"K1": k1.KERNEL, "K2": k2.V3_KERNEL, "K3": k2.V4_KERNEL,
                "K4": k2.PACKED_KERNEL, "K5": k2.V12_KERNELS[1], "K6": k2.V12_KERNELS[2],
                "K7": k1.SHIFT_KERNEL, "K8": k1.BDIAG_KERNEL, "K1b": k1.BWD_KERNEL}
    if hasattr(k1, "KERNEL_BF16"):  # the bf16 instances, counted apart
        counters.update(K1_bf16=k1.KERNEL_BF16, K7_bf16=k1.SHIFT_KERNEL_BF16,
                        K8_bf16=k1.BDIAG_KERNEL_BF16, K1b_bf16=k1.BWD_KERNEL_BF16)
    return counters


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
                                 render_cull_backfaces=True, slim=True)
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
                                     render_cull_backfaces=True, slim=True, device="cpu")
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
    stage_ms = phase_profile(infer, model, assets, batch, smi)
    tf32 = phase_tf32(model, assets, batch, smi)
    return launches, dict(R=R, t=t, ms_per_call=1e3 * dt / calls, stage_ms=stage_ms,
                          tf32=tf32)


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
    return {"forward_ms_tf32_on": ms[True], "rot_max_abs_diff": d_rot,
            "trans_max_abs_diff": d_t}


def phase_profile(infer, model, assets, batch, smi, tag: str = "shipped"):
    """Where one call's time goes: render, encoders and decoder timed with
    CUDA events (median of 3 after a warm-up; "gru", the decoder's ConvGRU
    calls summed, is part of "decoder"), and, from torch.profiler over
    one call, each kernel's summed device time and count.  The sum over
    kernels can exceed the device timeline (cuDNN's kernels overlap), so it
    is no busy share."""
    from torch.profiler import ProfilerActivity, profile

    from scflow_tpu_torch.device import full_fp32
    from scflow_tpu_torch.refiners.system import render_and_normalize

    b = {k: torch.as_tensor(v, device=assets.verts.device) for k, v in batch.items()}
    times = {"render": [], "encoders": [], "decoder": [], "gru": []}
    gru_ev = []  # (start, end) events of each ConvGRU call, inside the decoder
    gru = model.decoder.gru

    def gru_start(*_):
        gru_ev.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
        gru_ev[-1][0].record()

    def gru_end(*_):
        gru_ev[-1][1].record()

    hooks = [gru.register_forward_pre_hook(gru_start), gru.register_forward_hook(gru_end)]
    with torch.inference_mode(), full_fp32():
        for _ in range(4):
            gru_ev.clear()
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
            times["gru"].append(sum(a.elapsed_time(z) for a, z in gru_ev))
    for h in hooks:
        h.remove()
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
    emit({"phase": "profile", "model": tag, "model_dtype": str(model.dtype),
          "stage_ms": stage_ms,
          "profiled_call_ms": wall_ms,
          "kernel_time_sum_ms": sum(ms for ms, _ in kernels.values()),
          "kernel_names": len(kernels), "ours_ms_count": ours,
          "top_kernels_ms_count": [[name[:90], ms, n] for name, (ms, n) in top], "card": smi})
    return stage_ms


# the shipped recipe (configs/refine_models/scflow.py)
SYMMETRY_TYPES = {"cls_13": {"z": 0}, "cls_16": {"x": 180, "y": 180, "z": 90},
                  "cls_19": {"y": 180}, "cls_20": {"x": 180}, "cls_21": {"x": 180, "y": 90, "z": 180}}
OPTIMIZER = dict(type="AdamW", lr=4e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
LR_CONFIG = dict(policy="OneCycle", max_lr=4e-4, total_steps=100100, pct_start=0.05,
                 anneal_strategy="linear")


def train_model(image: int, iters: int, dtype=None, **options):
    """The shipped network (detach_depth_for_xy=True; with the refiner's
    `options`) in `dtype` with PyTorch's default initialisation from a seed
    (the same weights for either dtype); the pose head's output weights get
    normal(0, 0.005) so that the poses move.  PyTorch's initialisation,
    smaller than the lecun-normal one of seeded_model, keeps the float32
    gradients of two devices within the 2e-2 the card-CPU check allows."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner

    torch.manual_seed(0)
    model = SCFlowRefiner(num_class=NCLASS, image_size=(image, image), iters=iters,
                          detach_depth_for_xy=True, dtype=dtype, **options)
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

    res.update(_profile_call(lambda: step(state, batch)))

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
    return launches, loss


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


def _train_card_vs_cpu(bank, raft: bool = False, options=None):
    """One step on the card and one on the CPU (the plain versions: render
    'pallas' runs the plain v3 raster there, the lookup plain K1 and K1b)
    from the same weights and batch, at batch 2, 128^2, 3 iterations; the
    SCFlow recipe, or with raft the RAFT one, on the model with the
    refiner's `options` (RAFT_SMALL, SCFLOW_OPTIONS)."""
    import copy

    n, image, iters = 2, 128, 3
    options = options or {}
    if raft:
        model, setup = raft_train_model(iters, **options), _raft_train_setup
    else:
        model = train_model(image, iters, **options)

        def setup(*args):
            return _train_setup(*args, render_backend="pallas")[:3]
    cpu_model = copy.deepcopy(model)
    card_state, card_step, card_assets = setup(model, bank, image)
    batch = train_batch(card_assets, n, image, seed=1)
    _, card_logs = card_step(card_state, batch)
    cpu_state, cpu_step, _ = setup(cpu_model, bank, image, "cpu")
    _, cpu_logs = cpu_step(cpu_state, batch)
    torch.cuda.synchronize()
    got = {k: p.grad.cpu() for k, p in card_state.model.named_parameters()}
    want = {k: p.grad for k, p in cpu_state.model.named_parameters()}
    worst, leaf = _worst_grad_rel(got, want)
    loss_rel = abs(float(card_logs["loss"]) / float(cpu_logs["loss"]) - 1)
    require(loss_rel <= 1e-3 and worst <= 2e-2,
            f"card vs CPU step (raft {raft}): loss rel {loss_rel}, worst gradient rel {worst} "
            f"({leaf})")
    return {"loss_card": float(card_logs["loss"]), "loss_cpu": float(cpu_logs["loss"]),
            "loss_rel_diff": loss_rel, "worst_grad_rel_l2": worst, "worst_leaf": leaf,
            "leaves": len(want)}


def _pose_dist(R, t, R_ref, t_ref):
    """Largest |dR| and |dt| between two batches of poses (numpy)."""
    return float(np.abs(R - R_ref).max()), float(np.abs(t - t_ref).max())


def phase_slice_bf16(smi, fp32):
    """make_scflow_infer_fn(slim=True) at the bench configuration with the
    seeded weights of the fp32 slice in bf16 (SCFlowRefiner(dtype=
    torch.bfloat16), bench.py's dtype): one call with every launch count
    reset (8 launches of K1's bf16 instance, 1 K2, nothing else); finite,
    orthonormal, moved poses; the first 4 samples against a CPU run of the
    plain versions at bf16 (lookup 'pallas', K1's plain version) within the
    form of bound tests/test_torch_bf16_system.py states: |card - CPU| <= 2
    x |card bf16 - card fp32| + the fp32 tolerances (rotations 2e-3;
    translations 2e-2 + 2e-3 |t|); refinements/s, ms per call, the stages
    (profile line) and the pose difference against the fp32 call, beside
    the TF32 phase's."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
    from scflow_tpu_torch.refiners.system import RenderAssets, make_scflow_infer_fn
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    model = seeded_model(torch.bfloat16)
    batch = bench_batch()
    assets = RenderAssets.from_bank(bank)
    infer = make_scflow_infer_fn(model, assets, image_size=(IMG, IMG),
                                 render_cull_backfaces=True, slim=True)
    torch.cuda.reset_peak_memory_stats()
    infer(batch)  # warm-up
    torch.cuda.synchronize()
    out, launches = counted(lambda: infer(batch))
    require(only(launches, K1_bf16=ITERS, K2=1), f"bf16 launches per call {launches}")
    require(out["rotations"].dtype == out["translations"].dtype == torch.float32,
            "bf16 model: float32 poses")
    require(all(p.dtype == torch.float32 for p in model.parameters()) and
            all(b.dtype in (torch.float32, torch.int64) for b in model.buffers()),
            "bf16 model: float32 parameters and BatchNorm statistics")
    R, t = out["rotations"].cpu().numpy(), out["translations"].cpu().numpy()
    require(np.isfinite(R).all() and np.isfinite(t).all(), "bf16: finite poses")
    ortho = float(np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max())
    require(ortho < 1e-4, f"bf16: |R^T R - I| {ortho} < 1e-4")
    moved = float(np.abs(t - batch["ref_translations"]).max())
    require(moved > 1.0, "bf16: poses moved")
    vs_fp32 = _pose_dist(R, t, fp32["R"], fp32["t"])

    cpu_model = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=ITERS,
                              dtype=torch.bfloat16)
    cpu_model.load_state_dict(model.state_dict())
    ref = make_scflow_infer_fn(cpu_model, RenderAssets.from_bank(bank, device="cpu"),
                               image_size=(IMG, IMG), render_backend="pallas",
                               render_cull_backfaces=True, lookup_backend="pallas", slim=True,
                               device="cpu")({k: v[:4] for k, v in batch.items()})
    R_ref, t_ref = ref["rotations"].numpy(), ref["translations"].numpy()
    d_rot, d_t = _pose_dist(R[:4], t[:4], R_ref, t_ref)
    d32_rot, d32_t = _pose_dist(R[:4], t[:4], fp32["R"][:4], fp32["t"][:4])
    rot_ok = d_rot <= 2 * d32_rot + 2e-3
    t_excess = float((np.abs(t[:4] - t_ref) - 2 * d32_t
                      - (2e-2 + 2e-3 * np.abs(t_ref))).max())
    require(rot_ok and t_excess <= 0,
            f"bf16 card vs CPU: rot |d| {d_rot} (bf16-fp32 {d32_rot}), t excess {t_excess}")

    calls = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        infer(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stage_ms = phase_profile(infer, model, assets, batch, smi)
    emit({"phase": "slice_bf16", "batch": BATCH, "image": IMG, "iters": ITERS,
          "classes": NCLASS, "launches_per_call": launches, "orthonormality_err": ortho,
          "max_translation_move": moved, "cpu_rot_max_abs_diff": d_rot,
          "cpu_trans_tolerance_excess": t_excess,
          "rot_max_abs_diff_vs_fp32": vs_fp32[0], "trans_max_abs_diff_vs_fp32": vs_fp32[1],
          "tf32_rot_max_abs_diff": fp32["tf32"]["rot_max_abs_diff"],
          "tf32_trans_max_abs_diff": fp32["tf32"]["trans_max_abs_diff"],
          "ms_per_call": 1e3 * dt / calls, "refinements_per_s": BATCH * calls / dt,
          "fp32_ms_per_call": fp32["ms_per_call"], "stage_ms": stage_ms,
          "fp32_stage_ms": fp32["stage_ms"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": smi})
    return {"K1_bf16": launches["K1_bf16"]}


def phase_infer_full(smi):
    """make_scflow_infer_fn(slim=False), the default, at batch 4 of the bench
    configuration (fp32, seeded weights): the final masks (N, H, W) and flow
    (N, H, W, 2) beside the pose, finite, against the CPU run within the
    slice tolerances (poses as the slice phase; masks atol 1e-3, flow atol
    2e-2 px, tests/test_torch_bf16_system.py's bounds); 8 K1 and 1 K2."""
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
    from scflow_tpu_torch.refiners.system import RenderAssets, make_scflow_infer_fn
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    n = 4
    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    model = seeded_model()
    batch = {k: v[:n] for k, v in bench_batch().items()}
    infer = make_scflow_infer_fn(model, RenderAssets.from_bank(bank), image_size=(IMG, IMG),
                                 render_cull_backfaces=True)
    infer(batch)
    out, launches = counted(lambda: infer(batch))
    require(only(launches, K1=ITERS, K2=1), f"slim=False launches {launches}")
    require(set(out) == {"rotations", "translations", "masks", "flow"}
            and tuple(out["masks"].shape) == (n, IMG, IMG)
            and tuple(out["flow"].shape) == (n, IMG, IMG, 2)
            and all(bool(torch.isfinite(v).all()) for v in out.values()),
            f"slim=False outputs {({k: tuple(v.shape) for k, v in out.items()})}")
    cpu_model = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=ITERS)
    cpu_model.load_state_dict(model.state_dict())
    ref = make_scflow_infer_fn(cpu_model, RenderAssets.from_bank(bank, device="cpu"),
                               image_size=(IMG, IMG), render_backend="pallas",
                               render_cull_backfaces=True, device="cpu")(batch)
    got = {k: v.cpu() for k, v in out.items()}
    diff = {k: (got[k] - ref[k]).abs().max().item() for k in got}
    t_excess = float(((got["translations"] - ref["translations"]).abs()
                      - (2e-2 + 2e-3 * ref["translations"].abs())).max())
    require(diff["rotations"] <= 2e-3 and t_excess <= 0 and diff["masks"] <= 1e-3
            and diff["flow"] <= 2e-2, f"slim=False card vs CPU: {diff}, t excess {t_excess}")
    emit({"phase": "infer_full", "batch": n, "launches_per_call": launches,
          "max_abs_diff_vs_cpu": diff, "trans_tolerance_excess": t_excess,
          "flow_max_abs": got["flow"].abs().max().item(),
          "mask_mean": got["masks"].mean().item(), "card": smi})


def phase_train_bf16(smi, fp32_loss):
    """The train step at the shipped recipe with a bf16 model (the same
    seeded weights and batch as the fp32 phase, whose counted step's loss
    is fp32_loss): one step with every launch count reset (1 K2, 8 of K1's
    and 8 of K1b's bf16 instances, nothing else; finite loss; float32
    parameters, gradients and BatchNorm statistics); one step each with
    'shift' and 'bdiag' from the same state (8 of K7's or K8's bf16
    instance; the loss within the tent loss's own distance from the fp32
    phase's: the variants' float32 sums differ from tent's in the last
    bits, and a bf16 network turns that into bf16 roundings, where the
    fp32 phase holds 1e-4); the loss
    falling over 6 steps at lr 1e-3; ms per step, samples/s, peak memory;
    a card step against a CPU step at batch 2, 128^2, 3 iterations."""
    import copy

    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    state0, step, assets, loss_assets = _train_setup(train_model(IMG, ITERS, torch.bfloat16),
                                                     bank, IMG)
    batch = train_batch(assets, TRAIN_BATCH, IMG)
    torch.cuda.reset_peak_memory_stats()
    state0, _ = step(state0, batch)  # warm-up
    torch.cuda.synchronize()
    (state, logs), c = counted(lambda: step(copy.deepcopy(state0), batch))
    require(only(c, K1_bf16=ITERS, K1b_bf16=ITERS, K2=1), f"bf16 train step launches {c}")
    loss = float(logs["loss"])
    require(math.isfinite(loss) and math.isfinite(float(logs["grad_norm"])), f"loss {loss}")
    require(all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                for p in state.model.parameters()) and
            all(b.dtype in (torch.float32, torch.int64) for b in state.model.buffers()),
            "bf16 train step: float32 parameters, gradients and BatchNorm statistics")
    launches = {"K1_bf16": c["K1_bf16"], "K1b_bf16": c["K1b_bf16"]}
    res = {"loss": loss, "grad_norm": float(logs["grad_norm"])}
    for key, variant in (("K7_bf16", "shift"), ("K8_bf16", "bdiag")):
        vstep = _train_setup(state0.model, bank, IMG, lookup_variant=variant)[1]
        (_, vlogs), c = counted(lambda: vstep(copy.deepcopy(state0), batch))
        require(only(c, K1b_bf16=ITERS, K2=1, **{key: ITERS}),
                f"bf16 {variant} train step launches {c}")
        launches[key] = c[key]
        rel, bf16_rel = abs(float(vlogs["loss"]) / loss - 1), abs(loss / fp32_loss - 1)
        require(rel <= bf16_rel, f"bf16 {variant} loss {float(vlogs['loss'])} vs tent {loss} "
                                 f"(rel {rel}; bf16 vs fp32 tent {bf16_rel})")
        res[f"{variant}_loss_rel_diff"] = rel
        res["loss_rel_diff_vs_fp32"] = bf16_rel
    del state
    state = copy.deepcopy(state0)
    steps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    res.update(ms_per_step=1e3 * dt, samples_per_s=TRAIN_BATCH / dt,
               stage_ms=_train_stages(state, assets, loss_assets, batch),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    res.update(_profile_call(lambda: step(state, batch)))
    fall_state, fall_step, _, _ = _train_setup(copy.deepcopy(state0.model), bank, IMG,
                                               lr_cfg=None, optimizer=dict(
                                                   type="AdamW", lr=1e-3, weight_decay=1e-4))
    losses = []
    for _ in range(6):
        fall_state, flogs = fall_step(fall_state, batch)
        losses.append(float(flogs["loss"]))
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0], f"bf16 losses {losses}")
    res["losses_lr_1e-3"] = losses
    del fall_state, state
    res["card_vs_cpu"] = _train_card_vs_cpu_bf16(bank)
    emit({"phase": "train_bf16", "batch": TRAIN_BATCH, "image": IMG, "iters": ITERS,
          "classes": NCLASS, "launches_per_step": launches, **res, "card": smi})
    return launches


def _train_card_vs_cpu_bf16(bank):
    """One bf16 step on the card and one on the CPU (the plain versions)
    from the same weights and batch at batch 2, 128^2, 3 iterations, with a
    float32 CPU step as the yardstick (tests/test_torch_bf16_train.py's
    form of bound): loss |card/CPU - 1| <= 2 |CPU bf16/CPU fp32 - 1| + 1e-3,
    and all gradients together within rel L2 of the CPU bf16 ones no larger
    than the CPU's own bf16-to-fp32 distance."""
    import copy

    n, image, iters = 2, 128, 3
    models = {"card": train_model(image, iters, torch.bfloat16)}
    models["cpu"] = copy.deepcopy(models["card"])
    models["cpu32"] = train_model(image, iters)
    card_state, card_step, card_assets, _ = _train_setup(models["card"], bank, image,
                                                         render_backend="pallas")
    batch = train_batch(card_assets, n, image, seed=1)
    logs = {"card": card_step(card_state, batch)[1]}
    for key in ("cpu", "cpu32"):
        state, cpu_step, _, _ = _train_setup(models[key], bank, image, "cpu",
                                             render_backend="pallas")
        logs[key] = cpu_step(state, batch)[1]
    torch.cuda.synchronize()
    flat = {k: torch.cat([p.grad.detach().cpu().double().ravel()
                          for _, p in sorted(m.named_parameters())]) for k, m in models.items()}

    def rel(a, b):
        return float((flat[a] - flat[b]).norm() / flat[b].norm())

    loss = {k: float(v["loss"]) for k, v in logs.items()}
    loss_rel = abs(loss["card"] / loss["cpu"] - 1)
    loss_bound = 2 * abs(loss["cpu"] / loss["cpu32"] - 1) + 1e-3
    grad_rel, grad_bound = rel("card", "cpu"), rel("cpu", "cpu32")
    require(loss_rel <= loss_bound and grad_rel <= grad_bound,
            f"bf16 card vs CPU step: loss rel {loss_rel} (bound {loss_bound}), gradients rel "
            f"L2 {grad_rel} (bound {grad_bound})")
    return {"loss": loss, "loss_rel_diff": loss_rel, "loss_bound": loss_bound,
            "grad_rel_l2": grad_rel, "grad_rel_l2_bf16_vs_fp32_cpu": grad_bound,
            "grad_rel_l2_card_bf16_vs_cpu_fp32": rel("card", "cpu32")}


# ---- the RAFT baseline (configs/refine_models/raft.py) ----

RAFT_ITERS = 12  # the shipped decoder's and test_cfg's iterations
# apis.py:112-119 from the shipped test_cfg (sample_points num 1000, occ_thresh
# 0.5, the default reprojection error 3.0), num_hypotheses the solver's default
RAFT_PNP = dict(occ_thresh=0.5, num_points=1000, reprojection_error=3.0, num_hypotheses=64)
RAFT_CLIP = 1.0  # configs/refine_models/raft.py optimizer_config


def raft_model(dtype=None, iters: int = RAFT_ITERS, **options):
    """The shipped RAFTRefinerFlowMask (256-channel feature encoders, h and
    context 128; or the refiner's `options`, e.g. RAFT_SMALL) in `dtype`
    with seeded_model's weights: lecun-normal convs, zero biases, default
    norms, the flow head's output conv normal(0, HEAD_STD), so that each of
    the 12 iterations moves the flow by about a tenth of a pixel and two
    devices stay comparable."""
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask

    model = RAFTRefinerFlowMask(iters=iters, dtype=dtype, **options)
    g = torch.Generator().manual_seed(0)
    head = model.decoder.flow_pred.predict_layer
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                std = HEAD_STD if mod is head else 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.copy_(std * torch.randn(mod.weight.shape, generator=g))
                if mod.bias is not None:
                    mod.bias.zero_()
    return model


def _raft_infer(model, assets, device=None, **kw):
    """make_raft_infer_fn of the raft cell: 256^2, culling on, the kernels'
    render and lookup (their plain versions on the CPU)."""
    from scflow_tpu_torch.refiners.system import make_raft_infer_fn

    return make_raft_infer_fn(model, assets, image_size=(IMG, IMG), render_backend="pallas",
                              render_cull_backfaces=True, lookup_backend="pallas",
                              device=device, **kw)


def _raft_stages(model, assets, batch):
    """Median of 3 (after a warm-up) of one call's parts by CUDA events:
    render, encoders, decoder (12 iterations, the last upsampled), PnP."""
    from scflow_tpu_torch.device import full_fp32
    from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow_device
    from scflow_tpu_torch.refiners.system import render_and_normalize

    dev = assets.verts.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    names = ("render", "encoders", "decoder", "pnp")
    times = {k: [] for k in names}
    with torch.inference_mode(), full_fp32():
        for _ in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            ev[0].record()
            images, depths, _ = render_and_normalize(
                assets, b["ref_rotations"], b["ref_translations"], b["k"], b["labels"],
                (IMG, IMG), backend="pallas", cull_backfaces=True)
            ev[1].record()
            feats = model.extract_feat(images, b["real_images"])
            ev[2].record()
            n, _, h, w = feats[1].shape
            out = model.decoder(feats[0], feats[1], torch.zeros((n, h, w, 2), device=dev),
                                feats[2], feats[3], lookup_backend="pallas",
                                output_sequences=False)
            ev[3].record()
            solve_poses_from_flow_device(out["flow"][-1], depths, b["ref_rotations"],
                                         b["ref_translations"], b["k"],
                                         occlusion=out["occlusion"][-1], **RAFT_PNP)
            ev[4].record()
            torch.cuda.synchronize()
            for name, a, z in zip(names, ev, ev[1:]):
                times[name].append(a.elapsed_time(z))
    return {k: statistics.median(v[1:]) for k, v in times.items()}


def _profile_call(fn):
    """torch.profiler over one call of fn: the summed device time of its
    kernels (against the call's time: how far the host holds the card back;
    the sum can exceed the timeline where kernels overlap), launches, ours,
    the top 12 kernels (time, count)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {"kernel_time_sum_ms": sum(ms for ms, _ in kernels.values()),
            "kernel_launches": sum(n for _, n in kernels.values()),
            "ours_ms_count": {name.split("(")[0]: v for name, v in kernels.items()
                              if "lookup_" in name or "raster_v3" in name},
            "top_kernels_ms_count": [[name[:90], ms, n] for name, (ms, n) in top]}


def _raft_gt_scene(batch, depths):
    """The gt flow from the reference to the gt pose on the rendered depth
    (tensors on the depth's device) and an occlusion confidence drawn
    uniformly from (0.5, 1) where the render covers: a constant one would
    tie, and the stable top-k would then take the object's top rows only,
    a strip on which the solve is ill-conditioned."""
    from scflow_tpu_torch.geometry import flow_from_pose_and_depth

    dev = depths.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    flow = flow_from_pose_and_depth(b["ref_rotations"], b["ref_translations"], b["gt_rotations"],
                                    b["gt_translations"], depths, b["k"])
    conf = 0.5 + 0.5 * torch.rand(depths.shape, generator=torch.Generator().manual_seed(4))
    return b, flow, torch.where(depths > 0, conf.to(dev), torch.zeros_like(depths))


def _raft_pnp_gates(batch, depths):
    """Gate 2: the card's device PnP recovers the gt pose from the gt flow
    (every sample: |dR| <= 2e-3, |dt| <= 1 mm at about 700 mm).  Gate 3:
    on the same hypothesis indices (drawn once on the CPU), with 30% of the
    correspondences moved 10-40 px off, the card's ransac_from_indices
    equals the CPU's (|dR| <= 1e-3, |dt| <= 0.5 mm, the same ok, inliers
    differing on <= 1% of the points)."""
    from scflow_tpu_torch import pnp
    from scflow_tpu_torch.geometry import coords_grid, lift_depth_to_object_points
    from scflow_tpu_torch.refiners.flow_pose import solve_poses_from_flow_device

    b, flow, occ = _raft_gt_scene(batch, depths)
    R, t, ok = solve_poses_from_flow_device(flow, depths, b["ref_rotations"],
                                            b["ref_translations"], b["k"], occlusion=occ,
                                            **RAFT_PNP)
    rot_err = (R - b["gt_rotations"]).abs().amax().item()
    t_err = (t - b["gt_translations"]).abs().amax().item()
    require(bool(ok.all()) and rot_err <= 2e-3 and t_err <= 1.0,
            f"gt flow -> gt pose: ok {int(ok.sum())}/{len(ok)}, |dR| {rot_err}, |dt| {t_err}")
    pnp_ms = median_ms(lambda: solve_poses_from_flow_device(
        flow, depths, b["ref_rotations"], b["ref_translations"], b["k"], occlusion=occ,
        **RAFT_PNP), 3, groups=3)

    # gate 3: the selected correspondences with outliers, shared indices
    n, h, w = depths.shape
    pts, valid = lift_depth_to_object_points(depths, b["k"], b["ref_rotations"],
                                             b["ref_translations"])
    score = torch.where(valid, occ, torch.full_like(occ, -float("inf"))).reshape(n, -1)
    idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :1000]
    tgt = (coords_grid(h, w, flow.dtype, flow.device)[None] + flow).reshape(n, -1, 2)
    p3 = pts.reshape(n, -1, 3).gather(1, idx[..., None].expand(-1, -1, 3)).cpu()
    p2 = tgt.gather(1, idx[..., None].expand(-1, -1, 2)).cpu()
    val = valid.reshape(n, -1).gather(1, idx).cpu()
    g = torch.Generator().manual_seed(5)
    out = torch.rand(p2.shape[:2], generator=g) < 0.3
    off = (torch.rand(p2.shape, generator=g) * 30 + 10) * torch.sign(torch.randn(p2.shape,
                                                                                  generator=g))
    p2 = torch.where(out[..., None], p2 + off, p2)
    hyp = pnp.sample_hypotheses(val, 64, 6, g)
    K = b["k"].cpu()
    cpu = pnp.ransac_from_indices(p3, p2, K, val, hyp)
    card = pnp.ransac_from_indices(p3.cuda(), p2.cuda(), K.cuda(), val.cuda(), hyp.cuda())
    d_rot = (card.rotation.cpu() - cpu.rotation).abs().amax().item()
    d_t = (card.translation.cpu() - cpu.translation).abs().amax().item()
    inl = (card.inliers.cpu() != cpu.inliers).float().mean().item()
    same_ok = bool(torch.equal(card.ok.cpu(), cpu.ok))
    require(same_ok and d_rot <= 1e-3 and d_t <= 0.5 and inl <= 1e-2,
            f"card vs CPU RANSAC on shared indices: ok equal {same_ok}, |dR| {d_rot}, "
            f"|dt| {d_t}, inliers differing {inl}")
    return {"gt_flow_pose_rot_max_abs_err": rot_err, "gt_flow_pose_trans_max_abs_err_mm": t_err,
            "pnp_ms_batch": pnp_ms, "shared_index_card_vs_cpu": {
                "rot_max_abs_diff": d_rot, "trans_max_abs_diff_mm": d_t,
                "inlier_diff_share": inl, "ok": int(card.ok.sum())}}


def phase_raft(smi):
    """make_raft_infer_fn at the shipped configuration through the kernels
    (lookup 'pallas', device PnP): one call with every launch count reset
    (12 K1, 1 K2, nothing else); finite flow, occlusion in [0, 1],
    orthonormal poses; gate 1, the first 4 samples' flow and occlusion
    against a CPU run of the plain versions (flow atol 2e-2 px, occlusion
    atol 1e-3: the infer_full phase's bounds); gates 2 and 3
    (_raft_pnp_gates); ms per call, refinements/s, the stages and the
    profile."""
    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    assets = RenderAssets.from_bank(bank)
    model = raft_model()
    batch = train_batch(assets, BATCH, IMG, seed=2)
    infer = _raft_infer(model, assets, pnp_backend="device", pnp_cfg=RAFT_PNP)
    torch.cuda.reset_peak_memory_stats()
    infer(batch)  # warm-up
    torch.cuda.synchronize()
    out, launches = counted(lambda: infer(batch))
    require(only(launches, K1=RAFT_ITERS, K2=1), f"raft launches per call {launches}")
    flow, occ = out["flow"], out["occlusion"]
    require(tuple(flow.shape) == (BATCH, IMG, IMG, 2) and tuple(occ.shape) == (BATCH, IMG, IMG)
            and bool(torch.isfinite(flow).all()) and 0 <= occ.min() and occ.max() <= 1,
            f"raft outputs {tuple(flow.shape)} {tuple(occ.shape)}")
    R = out["rotations"]
    ortho = (R.transpose(1, 2) @ R - torch.eye(3, device=R.device)).abs().amax().item()
    require(ortho < 1e-4 and bool(torch.isfinite(out["translations"]).all()),
            f"raft poses: |R^T R - I| {ortho}")

    cpu_model = raft_model()  # the same seeded weights
    ref = _raft_infer(cpu_model, RenderAssets.from_bank(bank, device="cpu"), "cpu")(
        {k: v[:4] for k, v in batch.items()})
    d_flow = (flow[:4].cpu() - ref["flow"]).abs().max().item()
    d_occ = (occ[:4].cpu() - ref["occlusion"]).abs().max().item()
    require(d_flow <= 2e-2 and d_occ <= 1e-3, f"raft card vs CPU: flow {d_flow}, occ {d_occ}")

    calls = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        infer(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / calls
    res = {"launches_per_call": launches, "orthonormality_err": ortho,
           "flow_max_abs": flow.abs().max().item(), "occlusion_mean": occ.mean().item(),
           "pnp_ok": int(out["pnp_ok"].sum()), "cpu_flow_max_abs_diff": d_flow,
           "cpu_occlusion_max_abs_diff": d_occ, "ms_per_call": 1e3 * dt,
           "refinements_per_s": BATCH / dt,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "stage_ms": _raft_stages(model, assets, batch)}
    res.update(_profile_call(lambda: infer(batch)))
    res.update(_raft_pnp_gates(batch, out["rendered_depths"]))
    emit({"phase": "raft", "batch": BATCH, "image": IMG, "iters": RAFT_ITERS,
          "classes": NCLASS, "pnp_cfg": RAFT_PNP, **res, "card": smi})
    return launches, {"flow": flow, "occ": occ, "ms_per_call": 1e3 * dt, "model": model,
                      "batch": batch, "assets": assets}


def phase_raft_bf16(smi, fp32):
    """One make_raft_infer_fn call with the raft phase's weights in bf16: 12
    launches of K1's bf16 instance and 1 K2, nothing else; the flow and
    occlusion against the fp32 call's (max and mean |d|); ms per call."""
    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    assets = RenderAssets.from_bank(make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0))
    infer = _raft_infer(raft_model(torch.bfloat16), assets, pnp_backend="device",
                        pnp_cfg=RAFT_PNP)
    batch = fp32["batch"]
    infer(batch)
    out, launches = counted(lambda: infer(batch))
    require(only(launches, K1_bf16=RAFT_ITERS, K2=1), f"raft bf16 launches {launches}")
    require(out["flow"].dtype == torch.float32 and bool(torch.isfinite(out["flow"]).all()),
            "raft bf16: finite float32 flow")
    d = (out["flow"] - fp32["flow"]).abs()
    d_occ = (out["occlusion"].float() - fp32["occ"]).abs()
    calls = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        infer(batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / calls
    emit({"phase": "raft_bf16", "batch": BATCH, "launches_per_call": launches,
          "flow_max_abs_diff_vs_fp32": d.max().item(), "flow_mean_abs_diff_vs_fp32":
          d.mean().item(), "occlusion_max_abs_diff_vs_fp32": d_occ.max().item(),
          "ms_per_call": 1e3 * dt, "refinements_per_s": BATCH / dt,
          "fp32_ms_per_call": fp32["ms_per_call"], "card": smi})
    return {"K1_bf16": launches["K1_bf16"]}


def phase_raft_val(smi, fp32):
    """One make_raft_val_step call on the raft phase's model and batch: 12
    K1 and 1 K2; every metric finite, the pixel shares in [0, 1]."""
    from scflow_tpu_torch.refiners.system import make_raft_val_step

    step = make_raft_val_step(fp32["model"], fp32["assets"], image_size=(IMG, IMG),
                              render_backend="pallas", render_cull_backfaces=True,
                              lookup_backend="pallas")
    step(fp32["batch"])
    metrics, launches = counted(lambda: step(fp32["batch"]))
    require(only(launches, K1=RAFT_ITERS, K2=1), f"raft val launches {launches}")
    m = {k: v.item() for k, v in metrics.items()}
    require(len(m) == 9 and all(map(math.isfinite, m.values())) and
            all(0 <= v <= 1 for k, v in m.items() if k.endswith("px")), f"raft val {m}")
    emit({"phase": "raft_val", "batch": BATCH, "launches_per_call": launches, "metrics": m,
          "ms_per_call": median_ms(lambda: step(fp32["batch"]), 1, groups=3), "card": smi})


def phase_raft_all(smi):
    """The RAFT phases in order; {kernel: launches} on the RAFT path (K1 and
    K2 per fp32 call, K1_bf16 per bf16 call, K1b per train step)."""
    launches, fp32 = phase_raft(smi)
    launches.update(phase_raft_bf16(smi, fp32))
    phase_raft_val(smi, fp32)
    del fp32
    launches.update(phase_raft_train(smi))
    return {k: v for k, v in launches.items() if v}


def _raft_train_setup(model, bank, image: int, device=None, lr_cfg=LR_CONFIG,
                      optimizer=OPTIMIZER, **step_kw):
    """(TrainState, step, render assets) of the shipped RAFT recipe (AdamW
    4e-4 + OneCycle + clip 1.0, the kernels' lookup) on `device`."""
    from scflow_tpu_torch.refiners.system import RenderAssets, make_raft_train_step
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    assets = RenderAssets.from_bank(bank, device=device)
    tx, _ = build_optimizer(model.parameters(), optimizer, lr_cfg, grad_clip=RAFT_CLIP)
    step = make_raft_train_step(model, assets, image_size=(image, image),
                                render_backend="pallas", render_cull_backfaces=True,
                                lookup_backend="pallas", device=device, **step_kw)
    return TrainState(model, tx), step, assets


def raft_train_model(iters: int, **options):
    """The shipped RAFTRefinerFlowMask (or one with the refiner's `options`)
    with PyTorch's initialisation from a seed (train_model's reason)."""
    from scflow_tpu_torch.refiners.raft import RAFTRefinerFlowMask

    torch.manual_seed(0)
    return RAFTRefinerFlowMask(iters=iters, **options)


def phase_raft_train(smi):
    """make_raft_train_step at the shipped recipe (batch 16, 256^2, 12
    iterations, lookup 'pallas'): one step with every launch count reset
    (exactly 12 K1, 12 K1b, 1 K2); ms per step, samples/s, the stages by
    CUDA events, the profile, peak memory; the loss falling over the
    recipe's first 6 steps; a card step against a CPU step at batch 2,
    128^2, 3 iterations (loss rtol 1e-3, worst per-leaf gradient rel L2 <=
    2e-2)."""
    import copy

    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    state0, step, assets = _raft_train_setup(raft_train_model(RAFT_ITERS), bank, IMG)
    batch = train_batch(assets, TRAIN_BATCH, IMG)
    torch.cuda.reset_peak_memory_stats()
    state0, _ = step(state0, batch)  # warm-up
    torch.cuda.synchronize()
    (_, logs), c = counted(lambda: step(copy.deepcopy(state0), batch))
    require(only(c, K1=RAFT_ITERS, K1b=RAFT_ITERS, K2=1), f"raft train step launches {c}")
    loss = float(logs["loss"])
    require(math.isfinite(loss) and math.isfinite(float(logs["grad_norm"])), f"loss {loss}")
    res = {"launches_per_step": c, "loss": loss, "grad_norm": float(logs["grad_norm"]),
           "log_keys": len(logs)}
    state = copy.deepcopy(state0)
    steps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    res.update(ms_per_step=1e3 * dt, samples_per_s=TRAIN_BATCH / dt,
               stage_ms=_raft_train_stages(state, assets, batch),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    res.update(_profile_call(lambda: step(state, batch)))
    # the loss falls over 6 steps of the shipped recipe from the first step
    # (OneCycle's warm-up: lr 1.6e-5 and rising); at a constant 1e-3, as the
    # SCFlow phase runs, this network's loss rose (426 -> 679 over 6 steps)
    fall_state, fall_step, _ = _raft_train_setup(copy.deepcopy(state0.model), bank, IMG)
    losses = []
    for _ in range(6):
        fall_state, flogs = fall_step(fall_state, batch)
        losses.append(float(flogs["loss"]))
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0], f"raft losses {losses}")
    res["losses_shipped_recipe"] = losses
    del fall_state, state
    res["card_vs_cpu"] = _train_card_vs_cpu(bank, raft=True)
    emit({"phase": "raft_train", "batch": TRAIN_BATCH, "image": IMG, "iters": RAFT_ITERS,
          "classes": NCLASS, **res, "card": smi})
    return {"K1b": c["K1b"]}


def _raft_train_stages(state, assets, batch):
    """Median of 3 (after a warm-up) of the step's parts by CUDA events:
    render + gt flow, forward + losses, backward, optimizer update."""
    from scflow_tpu_torch.geometry import filter_flow_by_mask, flow_from_pose_and_depth
    from scflow_tpu_torch.losses.basic import l1_loss, raft_loss
    from scflow_tpu_torch.refiners.system import render_and_normalize

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
                (IMG, IMG), backend="pallas", cull_backfaces=True)
            gt = filter_flow_by_mask(flow_from_pose_and_depth(
                b["ref_rotations"], b["ref_translations"], b["gt_rotations"],
                b["gt_translations"], depths, b["k"]), b["gt_masks"])
            gt_occ = (gt.sum(-1) < 400.0).float()
        ev[1].record()
        out = state.model(img, b["real_images"], train=True, lookup_backend="pallas")
        T = out["flow"].shape[0]
        loss = sum(0.8 ** (T - 1 - i) * (raft_loss(out["flow"][i], gt, valid=masks)
                                         + 100.0 * l1_loss(out["occlusion"][i], gt_occ))
                   for i in range(T))
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


# RAFT-S, the RAFT paper's small model (Teed & Deng, "RAFT", ECCV 2020,
# RAFT-S; the authors' core/raft.py small branch): Bottleneck encoders
# (IN features, a norm-free context), h 96 / context 64, radius 3, the
# Conv GRU, bilinear upsampling; 12 iterations as the shipped RAFT
RAFT_SMALL = dict(net_type="Small", h_channels=96, cxt_channels=64, encoder_out_channels=128,
                  encoder_norm="IN", cxt_norm=None, num_levels=4, radius=3, gru_type="Conv")
# the SCFlow options the shipped configuration leaves off, at its widths
SCFLOW_OPTIONS = dict(seperate_encoder=True, radius=3, mask_flow=True, mask_corr=True,
                      detach_mask=False, gru_fuse_gates=True, depth_transform="linear",
                      pose_head_cfg=dict(type="MultiClassPoseHead", num_class=NCLASS,
                                         rotation_mode="quaternion"))


def _timed_calls(fn, calls: int = 10) -> float:
    """Host-clock ms per call of `calls` back-to-back calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def phase_raft_small(smi):
    """RAFT-S (RAFT_SMALL) through the RAFT entry points at the raft phases'
    shapes: make_raft_infer_fn (device PnP) at batch 64, 256^2, 12
    iterations: 12 launches of K1's radius-3 instance and 1 K2 per call,
    nothing else; finite flow, occlusion in [0, 1], orthonormal poses; the
    first 4 samples' flow and occlusion against the CPU run of the plain
    versions (atol 2e-2 px, 1e-3, the raft phase's bounds); ms per call,
    refinements/s, the stages.  Then one bf16 call (12 K1 bf16, 1 K2; its
    first 4 samples' flow within twice the CPU's bf16-to-fp32 distance, max
    and mean, of the CPU's bf16 run) and
    make_raft_train_step at the RAFT recipe (batch 16: 12 K1, 12 K1b at
    radius 3, 1 K2 per step), ms per step, the stages, the loss falling
    over the recipe's first 6 steps, and a card step against a CPU step at
    batch 2, 128^2, 3 iterations.  Returns {kernel: launches} of its calls
    and steps."""
    import copy

    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    assets = RenderAssets.from_bank(bank)
    model = raft_model(**RAFT_SMALL)
    require(model.decoder.radius == 3 and not hasattr(model.decoder, "mask_pred"), "RAFT-S")
    batch = train_batch(assets, BATCH, IMG, seed=2)
    infer = _raft_infer(model, assets, pnp_backend="device", pnp_cfg=RAFT_PNP)
    infer(batch)  # warm-up
    out, launches = counted(lambda: infer(batch))
    require(only(launches, K1=RAFT_ITERS, K2=1), f"raft_small launches per call {launches}")
    flow, occ = out["flow"], out["occlusion"]
    require(tuple(flow.shape) == (BATCH, IMG, IMG, 2) and bool(torch.isfinite(flow).all())
            and 0 <= occ.min() and occ.max() <= 1, f"raft_small outputs {tuple(flow.shape)}")
    R = out["rotations"]
    ortho = (R.transpose(1, 2) @ R - torch.eye(3, device=R.device)).abs().amax().item()
    require(ortho < 1e-4 and bool(torch.isfinite(out["translations"]).all()),
            f"raft_small poses: |R^T R - I| {ortho}")
    cpu_assets = RenderAssets.from_bank(bank, device="cpu")
    ref = _raft_infer(raft_model(**RAFT_SMALL), cpu_assets, "cpu")(
        {k: v[:4] for k, v in batch.items()})
    d_flow = (flow[:4].cpu() - ref["flow"]).abs().max().item()
    d_occ = (occ[:4].cpu() - ref["occlusion"]).abs().max().item()
    require(d_flow <= 2e-2 and d_occ <= 1e-3, f"raft_small card vs CPU: flow {d_flow}, occ {d_occ}")
    ms = _timed_calls(lambda: infer(batch))
    res = {"launches_per_call": launches, "orthonormality_err": ortho,
           "flow_max_abs": flow.abs().max().item(), "pnp_ok": int(out["pnp_ok"].sum()),
           "cpu_flow_max_abs_diff": d_flow, "cpu_occlusion_max_abs_diff": d_occ,
           "ms_per_call": ms, "refinements_per_s": 1e3 * BATCH / ms,
           "stage_ms": _raft_stages(model, assets, batch),
           "parameters": sum(p.numel() for p in model.parameters())}
    res.update(_profile_call(lambda: infer(batch)))

    infer16 = _raft_infer(raft_model(torch.bfloat16, **RAFT_SMALL), assets,
                          pnp_backend="device", pnp_cfg=RAFT_PNP)
    infer16(batch)
    out16, c16 = counted(lambda: infer16(batch))
    require(only(c16, K1_bf16=RAFT_ITERS, K2=1), f"raft_small bf16 launches {c16}")
    require(bool(torch.isfinite(out16["flow"]).all()), "raft_small bf16: finite flow")
    d16 = (out16["flow"] - flow).abs()
    # bf16 rounds differently on the two devices, so the card's bf16 flow is
    # held to the CPU's bf16 flow within twice the CPU's own bf16-to-fp32
    # distance (tests/test_torch_options_raft.py's bound against JAX's bf16)
    ref16 = _raft_infer(raft_model(torch.bfloat16, **RAFT_SMALL), cpu_assets, "cpu")(
        {k: v[:4] for k, v in batch.items()})["flow"]
    d_cpu16, d_card16 = (ref16 - ref["flow"]).abs(), (out16["flow"][:4].cpu() - ref16).abs()
    require(d_card16.max() <= 2 * d_cpu16.max() and d_card16.mean() <= 2 * d_cpu16.mean(),
            f"raft_small bf16 card vs CPU bf16: max {d_card16.max().item()}, mean "
            f"{d_card16.mean().item()}; CPU bf16 vs fp32: max {d_cpu16.max().item()}, mean "
            f"{d_cpu16.mean().item()}")
    res["bf16"] = {"launches_per_call": c16, "ms_per_call": _timed_calls(lambda: infer16(batch)),
                   "flow_max_abs_diff_vs_fp32": d16.max().item(),
                   "flow_mean_abs_diff_vs_fp32": d16.mean().item(),
                   "cpu_bf16_vs_fp32_max_mean": [d_cpu16.max().item(), d_cpu16.mean().item()],
                   "card_vs_cpu_bf16_max_mean": [d_card16.max().item(), d_card16.mean().item()]}
    res["bf16"]["refinements_per_s"] = 1e3 * BATCH / res["bf16"]["ms_per_call"]
    del infer16, out16

    state0, step, tassets = _raft_train_setup(raft_train_model(RAFT_ITERS, **RAFT_SMALL), bank,
                                              IMG)
    tbatch = train_batch(tassets, TRAIN_BATCH, IMG)
    state0, _ = step(state0, tbatch)  # warm-up
    (_, logs), ct = counted(lambda: step(copy.deepcopy(state0), tbatch))
    require(only(ct, K1=RAFT_ITERS, K1b=RAFT_ITERS, K2=1), f"raft_small train launches {ct}")
    require(math.isfinite(float(logs["loss"])), f"raft_small loss {float(logs['loss'])}")
    state = copy.deepcopy(state0)
    ms_step = _timed_calls(lambda: step(state, tbatch), 5)
    train = {"launches_per_step": ct, "loss": float(logs["loss"]), "ms_per_step": ms_step,
             "samples_per_s": 1e3 * TRAIN_BATCH / ms_step,
             "stage_ms": _raft_train_stages(state, tassets, tbatch)}
    fall_state, fall_step, _ = _raft_train_setup(copy.deepcopy(state0.model), bank, IMG)
    losses = []
    for _ in range(6):
        fall_state, flogs = fall_step(fall_state, tbatch)
        losses.append(float(flogs["loss"]))
    require(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
            f"raft_small losses {losses}")
    train["losses_shipped_recipe"] = losses
    del fall_state, state
    train["card_vs_cpu"] = _train_card_vs_cpu(bank, raft=True, options=RAFT_SMALL)
    emit({"phase": "raft_small", "batch": BATCH, "image": IMG, "iters": RAFT_ITERS,
          "classes": NCLASS, "model": RAFT_SMALL, **res, "train": {"batch": TRAIN_BATCH, **train},
          "card": smi})
    return {"K1": launches["K1"], "K1_bf16": c16["K1_bf16"], "K1b": ct["K1b"]}


def phase_scflow_options(smi, shipped):
    """The SCFlow option set (SCFLOW_OPTIONS) at the flagship configuration:
    make_scflow_infer_fn(slim=True) at batch 64, 256^2, 8 iterations, 21
    classes on bench.py's inputs with seeded weights: 8 launches of K1's
    radius-3 instance and 1 K2 per call, nothing else; finite, orthonormal,
    moved poses; the first 4 samples against the CPU run of the plain
    versions (the slice phase's bounds); ms per call, refinements/s, the
    stages; the pose difference from the shipped configuration's call on
    the same inputs (information only).  Then make_scflow_train_step at the
    shipped recipe (batch 16: 8 K1, 8 K1b at radius 3, 1 K2 per step), ms
    per step, and a card step against a CPU step at batch 2, 128^2, 3
    iterations.  Returns {kernel: launches}."""
    import copy

    from scflow_tpu_torch.refiners.system import RenderAssets, make_scflow_infer_fn
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    assets = RenderAssets.from_bank(bank)
    model = seeded_model(**SCFLOW_OPTIONS)
    batch = bench_batch()

    def make_infer(m, a, device=None, **kw):
        return make_scflow_infer_fn(m, a, image_size=(IMG, IMG), render_cull_backfaces=True,
                                    slim=True, device=device, **kw)

    infer = make_infer(model, assets)
    infer(batch)  # warm-up
    out, launches = counted(lambda: infer(batch))
    require(only(launches, K1=ITERS, K2=1), f"scflow_options launches per call {launches}")
    R, t = out["rotations"].cpu().numpy(), out["translations"].cpu().numpy()
    require(np.isfinite(R).all() and np.isfinite(t).all(), "scflow_options: finite poses")
    ortho = float(np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max())
    require(ortho < 1e-4, f"scflow_options |R^T R - I| {ortho}")
    moved = float(np.abs(t - batch["ref_translations"]).max())
    require(moved > 1.0 and np.abs(R - batch["ref_rotations"]).max() > 1e-3,
            "scflow_options: poses moved")
    ref = make_infer(seeded_model(**SCFLOW_OPTIONS), RenderAssets.from_bank(bank, device="cpu"),
                     "cpu", render_backend="pallas")({k: v[:4] for k, v in batch.items()})
    d_rot = float(np.abs(R[:4] - ref["rotations"].numpy()).max())
    t_ref = ref["translations"].numpy()
    t_excess = float((np.abs(t[:4] - t_ref) - (2e-2 + 2e-3 * np.abs(t_ref))).max())
    require(d_rot <= 2e-3 and t_excess <= 0,
            f"scflow_options card vs CPU: rot |d| {d_rot}, t excess {t_excess}")
    ms = _timed_calls(lambda: infer(batch))
    res = {"launches_per_call": launches, "orthonormality_err": ortho,
           "max_translation_move": moved, "cpu_rot_max_abs_diff": d_rot,
           "cpu_trans_tolerance_excess": t_excess, "ms_per_call": ms,
           "refinements_per_s": 1e3 * BATCH / ms,
           "stage_ms": phase_profile(infer, model, assets, batch, smi, tag="scflow_options")}
    if shipped is not None:  # the slice phase's call, where it ran first
        d_shipped = _pose_dist(R, t, shipped["R"], shipped["t"])
        res.update(shipped_ms_per_call=shipped["ms_per_call"], pose_diff_vs_shipped={
            "rot_max_abs": d_shipped[0], "trans_max_abs": d_shipped[1]})

    state0, step, tassets, loss_assets = _train_setup(train_model(IMG, ITERS, **SCFLOW_OPTIONS),
                                                      bank, IMG)
    tbatch = train_batch(tassets, TRAIN_BATCH, IMG)
    state0, _ = step(state0, tbatch)  # warm-up
    (_, logs), ct = counted(lambda: step(copy.deepcopy(state0), tbatch))
    require(only(ct, K1=ITERS, K1b=ITERS, K2=1), f"scflow_options train launches {ct}")
    require(math.isfinite(float(logs["loss"])), f"scflow_options loss {float(logs['loss'])}")
    state = copy.deepcopy(state0)
    ms_step = _timed_calls(lambda: step(state, tbatch), 5)
    train = {"launches_per_step": ct, "loss": float(logs["loss"]), "ms_per_step": ms_step,
             "samples_per_s": 1e3 * TRAIN_BATCH / ms_step,
             "stage_ms": _train_stages(state, tassets, loss_assets, tbatch)}
    del state
    train["card_vs_cpu"] = _train_card_vs_cpu(bank, options=SCFLOW_OPTIONS)
    emit({"phase": "scflow_options", "batch": BATCH, "image": IMG, "iters": ITERS,
          "classes": NCLASS, "options": SCFLOW_OPTIONS, **res,
          "train": {"batch": TRAIN_BATCH, **train}, "card": smi})
    return {"K1": launches["K1"], "K1b": ct["K1b"]}


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


# ---- workflow: the reference's test workflow from a config file ----

YCBV_K = ((1066.778, 0.0, 312.9869), (0.0, 1067.487, 241.3109), (0.0, 0.0, 1.0))
FRAME_H, FRAME_W = 480, 640  # YCB-V's frames
WF_SEQ = 48  # a YCB-V test scene id (48-59)
WF_IMAGES, WF_CPU_IMAGES, WF_RAFT_IMAGES = 48, 4, 8
WF_JITTER = (15.0, 15.0, 15.0, 50.0)  # degrees, x, y, z mm: ycbv_real.py:38-51's PoseJitter
WF_METRIC = {"add": [0.05, 0.10, 0.20, 0.50], "rep": [2, 5, 10, 20], "auc": []}


def _write_ply(path: Path, verts, faces, colors) -> None:
    lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}",
             "property float x", "property float y", "property float z",
             "property uchar red", "property uchar green", "property uchar blue",
             f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    rgb = np.clip(np.rint(np.asarray(colors) * 255), 0, 255).astype(int)
    lines += [f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}" for v, c in zip(verts, rgb)]
    lines += [f"3 {f[0]} {f[1]} {f[2]}" for f in faces]
    path.write_text("\n".join(lines) + "\n")


def _rotation(axis, degrees: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    a = math.radians(degrees)
    return np.eye(3) + math.sin(a) * k + (1 - math.cos(a)) * (k @ k)


def _workflow_scene(root: Path, dev, images: int = WF_IMAGES, seed: int = 0,
                    split: str = "test") -> dict:
    """A synthetic set in YCB-V's BOP layout under root: the slice's 21
    uvsphere classes of 1024 faces as models_1024/ and models_eval/ .ply
    files, box keypoints, and `images` 640x480 PNGs (written by the port's
    imwrite) of 3-9 objects each, rendered at their gt poses with YCB-V's
    camera over a grey background (nearest surface wins), with
    scene_gt/scene_gt_info/scene_camera.json and the image list
    (image_lists/<split>.txt).  split 'test' adds initial poses: the gt
    jittered by up to 15 degrees and 15/15/50 mm (the shipped PoseJitter's
    ranges); 'train_real' adds each object's visible mask as
    mask_visib/{image}_{object}.png.  The first 4 images hold 3, 3, 4 and
    4 objects (the CPU gate's 4-object buckets).  Returns the gt, the
    initial poses and the meshes' vertices."""
    from scflow_tpu_torch.datasets.pipelines.imops import imwrite
    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import MeshBank, make_synthetic_bank
    from scflow_tpu_torch.render.renderer import render_batch

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    verts, keypoints = [], []
    for sub in ("models_1024", "models_eval", "keypoints", "image_lists"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for c in range(NCLASS):
        v = bank.verts[c][bank.vert_valid[c]]
        f = bank.faces[c][bank.face_valid[c]]
        col = bank.colors[c][bank.vert_valid[c]]
        for sub in ("models_1024", "models_eval"):
            _write_ply(root / sub / f"obj_{c + 1:06d}.ply", v, f, col)
        verts.append(v.astype(np.float32))
        lo, hi = v.min(0), v.max(0)
        keypoints.append([[float(x), float(y), float(z)] for x in (lo[0], hi[0])
                          for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    (root / "keypoints" / "bbox.json").write_text(json.dumps(keypoints))
    assets = RenderAssets.from_bank(MeshBank.from_dir(str(root / "models_1024")), device=dev)
    diam = [float(np.linalg.norm(v.max(0) - v.min(0))) for v in verts]

    K = np.array(YCBV_K, np.float32)
    seq = root / split / f"{WF_SEQ:06d}"
    (seq / "rgb").mkdir(parents=True, exist_ok=True)
    if split == "train_real":
        (seq / "mask_visib").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    scene_gt, scene_info, scene_cam, scene_init, gt, init = {}, {}, {}, {}, [], []
    for i in range(images):
        n = 3 + i // 2 if i < 4 else 3 + i % 7
        while True:  # until every object shows at least 400 pixels
            labels = rng.choice(NCLASS, n, replace=False)
            cells = rng.choice(12, n, replace=False)
            R, t = [], []
            for c, cell in zip(labels, cells):
                u = (cell % 4 + rng.uniform(0.3, 0.7)) * FRAME_W / 4
                v = (cell // 4 + rng.uniform(0.3, 0.7)) * FRAME_H / 3
                z = K[0, 0] * diam[c] / rng.uniform(140, 220)
                t.append([(u - K[0, 2]) * z / K[0, 0], (v - K[1, 2]) * z / K[1, 1], z])
                R.append(_rotation(rng.normal(size=3), rng.uniform(0, 360)))
            R, t = np.asarray(R, np.float32), np.asarray(t, np.float32)
            with torch.no_grad():
                out = render_batch(*assets, torch.from_numpy(R).to(dev),
                                   torch.from_numpy(t).to(dev),
                                   torch.from_numpy(np.repeat(K[None], n, 0)).to(dev),
                                   torch.from_numpy(labels).to(dev), FRAME_H, FRAME_W,
                                   backend="auto", cull_backfaces=True)
            depth = out["depths"].cpu().numpy()
            full = out["masks"].cpu().numpy() > 0.5
            near = np.where(full, depth, np.inf).argmin(0)
            visible = full & (np.arange(n)[:, None, None] == near[None])
            if (visible.sum((1, 2)) >= 400).all():
                break
        img = np.full((FRAME_H, FRAME_W, 3), 0.5, np.float32)
        rgb = out["images"].cpu().numpy()
        for o in range(n):
            img[visible[o]] = rgb[o][visible[o]]
        imwrite(str(seq / "rgb" / f"{i:06d}.png"),
                np.clip(np.rint(img[..., ::-1] * 255), 0, 255).astype(np.uint8))
        if split == "train_real":
            for o in range(n):
                imwrite(str(seq / "mask_visib" / f"{i:06d}_{o:06d}.png"),
                        visible[o].astype(np.uint8) * 255)

        def box(m):
            ys, xs = np.nonzero(m)
            return [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                    int(ys.max() - ys.min() + 1)]

        R0, t0 = [], []
        for o in range(n):
            axis = rng.normal(size=3)
            R0.append(_rotation(axis, rng.uniform(0, WF_JITTER[0])) @ R[o])
            t0.append(t[o] + rng.uniform(-1, 1, 3) * np.array(WF_JITTER[1:]))
        R0, t0 = np.asarray(R0, np.float32), np.asarray(t0, np.float32)
        scene_gt[str(i)] = [dict(cam_R_m2c=R[o].reshape(-1).tolist(), cam_t_m2c=t[o].tolist(),
                                 obj_id=int(labels[o]) + 1) for o in range(n)]
        scene_init[str(i)] = [dict(cam_R_m2c=R0[o].reshape(-1).tolist(),
                                   cam_t_m2c=t0[o].tolist(), obj_id=int(labels[o]) + 1)
                              for o in range(n)]
        scene_info[str(i)] = [dict(bbox_obj=box(full[o]), bbox_visib=box(visible[o]),
                                   px_count_visib=int(visible[o].sum()),
                                   visib_fract=float(visible[o].sum() / full[o].sum()))
                              for o in range(n)]
        scene_cam[str(i)] = dict(cam_K=K.reshape(-1).tolist(), depth_scale=1.0)
        gt.append((labels, R, t))
        init.append((labels, R0, t0))
    for name, content in (("scene_gt", scene_gt), ("scene_gt_info", scene_info),
                          ("scene_camera", scene_cam)):
        (seq / f"{name}.json").write_text(json.dumps(content))
    if split == "test":
        (root / "initial_poses" / f"{WF_SEQ:06d}").mkdir(parents=True, exist_ok=True)
        (root / "initial_poses" / f"{WF_SEQ:06d}" / "scene_gt.json").write_text(
            json.dumps(scene_init))
    (root / "image_lists" / f"{split}.txt").write_text(
        "\n".join(f"{WF_SEQ:06d}/rgb/{i:06d}.png" for i in range(images)))
    return dict(gt=gt, init=init, verts=verts, K=K)


def _workflow_config(root: Path, repo: Path, model: str) -> Path:
    """A config that _base_s the shipped configs/refine_models/<model> and
    overrides only the data paths (the test set, its initial poses, image
    list, keypoints and meshes; the test pipeline's ComputeBbox mesh_dir;
    the renderer's meshes) and the work_dir."""
    path = root / f"workflow_{model}"
    path.write_text(f'''_base_ = {str(repo / "configs" / "refine_models" / model)!r}
_root = {str(root / "ycbv")!r}
_dataset = load_cfg_vars({str(repo / "configs" / "refine_datasets" / "ycbv_real.py")!r})
data = dict(test=dict(
    data_root=_root + "/test", ref_annots_root=_root + "/initial_poses",
    image_list=_root + "/image_lists/test.txt", keypoints_json=_root + "/keypoints/bbox.json",
    meshes_eval=_root + "/models_eval",
    pipeline=[dict(t, mesh_dir=_root + "/models_eval") if t["type"] == "ComputeBbox" else t
              for t in _dataset["test_pipeline"]]))
model = dict(renderer=dict(mesh_dir=_root + "/models_1024"))
work_dir = _root + "/work"
del _dataset
''')
    return path


def _independent_metrics(info, cfg, pred, metric) -> dict:
    """ADD(-S), REP and AUC of `pred` (per image: labels, R, t) against the
    scene's gt, computed here in float64 from the definitions
    (datasets/base.py's): per object the mean distance of 1000 mesh points
    (the dataset's seeded draw, default_rng(20230613) per class in order)
    between the gt and the predicted pose, over the nearest predicted point
    for the config's symmetric classes, as a share of the config's
    diameter; the mean 2D distance of their projections; VOCap's area under
    the accuracy curve up to 100 mm; per class, then the mean over classes
    present."""
    rng = np.random.default_rng(20230613)
    pts = [v[rng.choice(v.shape[0], 1000)].astype(np.float64) for v in info["verts"]]
    sym = cfg.data.test.mesh_symmetry
    diam = cfg.data.test.mesh_diameter
    K = info["K"].astype(np.float64)
    errs = {"add": [], "rep": [], "auc": []}
    labels_all = []
    for (labels, R, t), (plabels, pR, pt) in zip(info["gt"], pred):
        for o, c in enumerate(labels):
            j = int(np.nonzero(np.asarray(plabels) == c)[0][0])
            g = pts[c] @ R[o].astype(np.float64).T + t[o]
            p = pts[c] @ np.asarray(pR[j], np.float64).T + np.asarray(pt[j], np.float64)
            if sym.get(f"cls_{c + 1}", False):
                d = np.linalg.norm(g[:, None] - p[None], axis=-1).min(1).mean()
            else:
                d = np.linalg.norm(g - p, axis=-1).mean()
            proj = lambda x: (x @ K.T)[:, :2] / (x @ K.T)[:, 2:]  # noqa: E731
            errs["add"].append(d / diam[c])
            errs["auc"].append(d)
            errs["rep"].append(np.linalg.norm(proj(g) - proj(p), axis=-1).mean())
            labels_all.append(c)
    labels_all = np.asarray(labels_all)
    names = cfg.data.test.class_names
    out, avg = {}, {}
    for name, thresholds in metric.items():
        e = np.asarray(errs[name])
        keys = ([name] if not thresholds else
                [f"{name}_{int(x * 100) if x < 1 else int(x):02d}" for x in thresholds])
        for c, cname in enumerate(names):
            sel = e[labels_all == c]
            for key, x in zip(keys, thresholds or [None]):
                if len(sel) == 0:
                    out[f"{cname}/{key}"] = -1.0
                    continue
                if x is None:
                    s = np.sort(sel)
                    acc = np.arange(1, len(s) + 1) / len(s)
                    keep = s <= 100.0
                    rec = np.concatenate([[0.0], s[keep], [100.0]])
                    pre = np.maximum.accumulate(np.concatenate(
                        [[0.0], acc[keep], [acc[keep][-1] if keep.any() else 0.0]]))
                    idx = np.nonzero(np.diff(rec))[0] + 1
                    v = float(np.sum((rec[idx] - rec[idx - 1]) * pre[idx]) / 100.0)
                else:
                    v = float((sel < x).mean())
                out[f"{cname}/{key}"] = v
                avg.setdefault(key, []).append(v)
    out.update({f"average/{k}": float(np.mean(v)) for k, v in avg.items()})
    return out


def _results_of(path: Path):
    """A test_main --out file as per image (labels, R, t)."""
    return [(np.asarray(r["pred"]["labels"]), np.asarray(r["pred"]["rotations"], np.float32),
             np.asarray(r["pred"]["translations"], np.float32))
            for r in json.loads(path.read_text())]


def _bop_matches_out(save_dir: Path, out_path: Path, n_images: int) -> None:
    """Gate (c): the BOP export parses back with one entry per object equal
    to the --out file's poses."""
    bop = json.loads((save_dir / f"{WF_SEQ:06d}" / "scene_gt.json").read_text())
    out = _results_of(out_path)
    require(sorted(bop, key=int) == [str(i) for i in range(n_images)], "one BOP entry per image")
    for i, (labels, R, t) in enumerate(out):
        entries = bop[str(i)]
        require(len(entries) == len(labels), f"BOP image {i}: one entry per object")
        for e, c, r, tt in zip(entries, labels, R, t):
            require(e["obj_id"] == int(c) + 1 and np.allclose(e["cam_R_m2c"], r.reshape(-1),
                                                               rtol=0, atol=1e-6)
                    and np.allclose(e["cam_t_m2c"], tt, rtol=1e-6, atol=1e-4),
                    f"BOP image {i} equals --out")


def _workflow_run(cli, args, k1: str, iters: int, tag: str, smi, extra=None):
    """One counted test_main run: its launches (exactly `iters` of k1 and 1
    K2 per image, nothing else), finite orthonormal poses, and its line."""
    res, launches = counted(lambda: cli.test_main(args))
    n_img = len(res["results"])
    n_obj = sum(len(r["pred"]["labels"]) for r in res["results"])
    require(only(launches, **{k1: iters * n_img, "K2": n_img}),
            f"{tag}: launches {launches} for {n_img} images")
    R = np.concatenate([r["pred"]["rotations"] for r in res["results"]])
    t = np.concatenate([r["pred"]["translations"] for r in res["results"]])
    ortho = float(np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max())
    require(np.isfinite(R).all() and np.isfinite(t).all() and ortho < 1e-4,
            f"{tag}: finite orthonormal poses ({ortho})")
    st, sec = res["stats"], res["seconds"]
    line = {"phase": f"workflow_{tag}", "images": n_img, "objects": n_obj,
            "ms_per_img": 1e3 * sec / n_img, "refinements_per_s": n_obj / sec,
            "load_ms_per_img": 1e3 * st["load"] / n_img,
            "call_ms_per_img": 1e3 * (st["call"] + st["fetch"]) / n_img,
            "launch_ms_per_img": 1e3 * st["call"] / n_img,
            "fetch_ms_per_img": 1e3 * st["fetch"] / n_img,
            "finish_ms_per_img": 1e3 * st["finish"] / n_img,
            "launches_per_img": {k: v / n_img for k, v in launches.items() if v},
            "metrics": res["metrics"], **(extra or {}), "card": smi}
    emit(line)
    return res, launches, line


def _workflow_alone(cfg, ckpt: Path, smi, tag: str, bucket: int = 8):
    """The entry point alone on one image's batch padded to `bucket`
    (back-to-back calls, median_ms, and device time, device_ms), against
    which the loop's call ms/img is read."""
    from scflow_tpu_torch.apis import build_render_assets, make_infer_from_cfg
    from scflow_tpu_torch.datasets.loader import collate_batch
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.runtime.checkpoint import load_params
    from scflow_tpu_torch.runtime.eval_loop import _bucket, pad_batch

    model = build_refiner_from_config(cfg.model)
    load_params(str(ckpt), model)
    assets, _ = build_render_assets(cfg.model)
    infer, _ = make_infer_from_cfg(cfg, model, assets, (IMG, IMG), slim=True)
    np.random.seed(0)
    dataset = build_dataset(cfg.data["test"])
    for idx in range(len(dataset)):
        batch = collate_batch([dataset[idx]])
        n = len(batch["labels"])
        if _bucket(n) == bucket:
            break
    batch = {k: v for k, v in batch.items() if k not in ("img_metas", "per_img_patch_num")}
    padded = pad_batch(batch, bucket)
    line = {"phase": f"workflow_{tag}_alone", "objects": n, "bucket": bucket,
            "call_ms": median_ms(lambda: infer(padded), 10),
            "call_device_ms": device_ms(lambda: infer(padded), 10), "card": smi}
    emit(line)
    return line


def _card_vs_cpu(card, cpu, tag: str, rot_slack: float = 0.0, t_slack: float = 0.0):
    """Gate (a) on per-image (labels, R, t): the same labels, |dR| within
    2e-3 + rot_slack and |dt| within 2e-2 + 2e-3 |t| + t_slack (the slice's
    card-vs-CPU bounds, widened by the slack for bf16).  Returns the
    largest |dR| and the largest excess of |dt| over its bound."""
    rot = t_excess = -math.inf
    require(len(card) == len(cpu), f"(a) {tag}: {len(card)} vs {len(cpu)} images")
    for (cl, cR, ct), (gl, gR, gt_) in zip(cpu, card):
        require(np.array_equal(cl, gl), f"(a) {tag}: labels")
        rot = max(rot, float(np.abs(cR - gR).max()))
        t_excess = max(t_excess, float((np.abs(ct - gt_)
                                        - (2e-2 + 2e-3 * np.abs(ct) + t_slack)).max()))
    require(rot <= 2e-3 + rot_slack and t_excess <= 0,
            f"(a) {tag} card vs CPU: rot |d| {rot} (slack {rot_slack}), t excess {t_excess}")
    return rot, t_excess


def phase_workflow(smi, root: Path):
    """The reference's test workflow (`cli.test_main --eval --format-only`)
    on the card from a config that _base_s the shipped model, over the
    synthetic YCB-V-layout set: fp32, bf16 (--cfg-options model.dtype=
    bfloat16) and the RAFT config with device PnP, then gates (a)-(d)."""
    import shutil

    from scflow_tpu_torch import cli
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.checkpoint import load_params, save_params

    work = root / "build" / "workflow"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        info = _workflow_scene(work / "ycbv", torch.device("cuda", 0))
        scene_s = time.perf_counter() - t0
        from scflow_tpu_torch.datasets.pipelines.imops import imread

        pngs = sorted((work / "ycbv" / "test" / f"{WF_SEQ:06d}" / "rgb").glob("*.png"))[:8]
        decode = []
        for png in pngs:
            t0 = time.perf_counter()
            imread(str(png), "unchanged")
            decode.append(1e3 * (time.perf_counter() - t0))
        cfg_path = _workflow_config(work, root, "scflow.py")
        cfg = Config.fromfile(str(cfg_path))
        require(cfg.model.decoder.iters == ITERS and tuple(cfg.model.renderer.image_size)
                == (IMG, IMG) and cfg.model.decoder.pose_head_cfg.num_class == NCLASS
                and cfg.model.renderer.cull_backfaces is True
                and cfg.model.test_cfg.get("max_bucket", 64) == 64, "the shipped model")
        model = build_refiner_from_config(cfg.model)
        model.load_state_dict(seeded_model().state_dict())
        model = model.cuda()
        ckpt = work / "scflow.pth"
        save_params(str(ckpt), model)  # from the card
        cpu_model = build_refiner_from_config(cfg.model)
        load_params(str(ckpt), cpu_model)  # gate (d): it loads on the CPU
        require(all(torch.equal(v.cpu(), cpu_model.state_dict()[k])
                    for k, v in model.state_dict().items()), "(d) card checkpoint on the CPU")
        base = [str(cfg_path), "--checkpoint", str(ckpt)]
        lines = {}
        bf16 = ["--cfg-options", "model.dtype=bfloat16"]
        for tag, k1, opts in (("scflow_fp32", "K1", []), ("scflow_bf16", "K1_bf16", bf16)):
            cli.test_main(base + ["--limit", "2"] + opts)  # warm-up: cuDNN plans, allocator
            out_json, save_dir = work / f"{tag}.json", work / f"bop_{tag}"
            res, launches, lines[tag] = _workflow_run(
                cli, base + ["--eval", "--format-only", "--save-dir", str(save_dir),
                             "--out", str(out_json)] + opts, k1, ITERS, tag, smi,
                {"scene_s": scene_s, "imread_640x480_ms": statistics.median(decode)})
            _bop_matches_out(save_dir, out_json, WF_IMAGES)  # gate (c)
            alone = Config.fromfile(str(cfg_path))
            alone.merge_from_dict(Config.parse_options(opts[1:]))
            _workflow_alone(alone, ckpt, smi, tag)
        # gate (a): the same workflow on the CPU for the first 4 images, fp32 and
        # bf16; bf16 within twice the CPU's own bf16-to-fp32 distance more
        cpu_args = base + ["--limit", str(WF_CPU_IMAGES), "--device", "cpu"]
        cpu = cli.test_main(cpu_args + ["--out", str(work / "cpu.json")])
        cli.test_main(cpu_args + ["--out", str(work / "cpu_bf16.json")] + bf16)
        cpu32, cpu16 = _results_of(work / "cpu.json"), _results_of(work / "cpu_bf16.json")
        cpu_rot, t_excess = _card_vs_cpu(
            _results_of(work / "scflow_fp32.json")[:WF_CPU_IMAGES], cpu32, "fp32")
        d16_rot = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(cpu16, cpu32))
        d16_t = max(float(np.abs(a[2] - b[2]).max()) for a, b in zip(cpu16, cpu32))
        bf16_rot, bf16_excess = _card_vs_cpu(
            _results_of(work / "scflow_bf16.json")[:WF_CPU_IMAGES], cpu16, "bf16",
            2 * d16_rot, 2 * d16_t)
        # gate (b): output weights zero, biases the identity: the initial poses come back
        head = model.decoder.pose_pred
        with torch.no_grad():
            head.rotation_pred.weight.zero_()
            head.translation_pred.weight.zero_()
        require(not head.translation_pred.bias.any().item(), "(b) zero translation bias")
        zero_ckpt = work / "identity.pth"
        save_params(str(zero_ckpt), model)
        eval_opts = [f"{k}={v}" for k, v in WF_METRIC.items()]
        ident = cli.test_main([str(cfg_path), "--checkpoint", str(zero_ckpt), "--eval",
                               "--out", str(work / "identity.json"), "--eval-options"]
                              + eval_opts)
        id_rot = id_t = 0.0
        for (labels, R0, t0_), (pl, pR, pt) in zip(info["init"],
                                                    _results_of(work / "identity.json")):
            require(np.array_equal(np.sort(labels), np.sort(pl)), "(b) labels")
            order = [int(np.nonzero(pl == c)[0][0]) for c in labels]
            id_rot = max(id_rot, float(np.abs(pR[order] - R0).max()))
            id_t = max(id_t, float((np.abs(pt[order] - t0_) / (1e-5 * np.abs(t0_) + 1e-3)).max()))
        require(id_rot <= 1e-5 and id_t <= 1.0,
                f"(b) initial poses back: rot {id_rot}, t {id_t} of the bound")
        want = _independent_metrics(info, cfg, info["init"], WF_METRIC)
        got = ident["metrics"]
        require(set(got) == set(want), f"(b) metric keys {sorted(set(got) ^ set(want))[:5]}")
        worst = max(abs(got[k] - want[k]) for k in want)
        require(worst <= 1e-6, f"(b) evaluate vs numpy: {worst}")
        # RAFT: the shipped config with the device PnP, on 8 images
        raft_cfg = _workflow_config(work, root, "raft.py")
        raft_ckpt = work / "raft.pth"
        save_params(str(raft_ckpt), raft_model().cuda())
        ropts = ["--cfg-options", "model.test_cfg.pnp_backend=device"]
        cli.test_main([str(raft_cfg), "--checkpoint", str(raft_ckpt), "--limit", "1"]
                      + ropts)  # warm-up
        _, _, lines["raft"] = _workflow_run(
            cli, [str(raft_cfg), "--checkpoint", str(raft_ckpt), "--limit",
                  str(WF_RAFT_IMAGES), "--eval"] + ropts, "K1", RAFT_ITERS, "raft", smi)
        # gate (a) for RAFT on 4 images: the flow head's output zero, so the flow
        # is 0 and the device PnP solves exact correspondences (on random flow
        # its RANSAC turns the devices' 1e-6 differences into other poses): card
        # and CPU agree, and both return the initial poses
        zero_raft = raft_model()
        with torch.no_grad():
            zero_raft.decoder.flow_pred.predict_layer.weight.zero_()
            zero_raft.decoder.flow_pred.predict_layer.bias.zero_()
        save_params(str(work / "raft_zero.pth"), zero_raft.cuda())
        zargs = [str(raft_cfg), "--checkpoint", str(work / "raft_zero.pth"), "--limit",
                 str(WF_CPU_IMAGES)]
        for dev, name in (([], "raft_zero.json"), (["--device", "cpu"], "raft_zero_cpu.json")):
            cli.test_main(zargs + dev + ["--out", str(work / name)] + ropts)
        zcard = _results_of(work / "raft_zero.json")
        raft_rot, raft_excess = _card_vs_cpu(zcard, _results_of(work / "raft_zero_cpu.json"),
                                             "raft, zero flow")
        raft_init_rot = raft_init_t = 0.0
        for (labels, R0, t0_), (pl, pR, pt) in zip(info["init"], zcard):
            order = [int(np.nonzero(pl == c)[0][0]) for c in labels]
            raft_init_rot = max(raft_init_rot, float(np.abs(pR[order] - R0).max()))
            raft_init_t = max(raft_init_t, float(np.abs(pt[order] - t0_).max()))
        require(raft_init_rot <= 2e-3 and raft_init_t <= 1.0,
                f"(a) raft, zero flow: initial poses back: rot {raft_init_rot}, t {raft_init_t}")
        emit({"phase": "workflow_gates", "cpu_images": WF_CPU_IMAGES,
              "cpu_rot_max_abs_diff": cpu_rot, "cpu_trans_tolerance_excess": t_excess,
              "bf16_cpu_rot_max_abs_diff": bf16_rot, "bf16_cpu_trans_tolerance_excess":
              bf16_excess, "cpu_bf16_to_fp32_rot": d16_rot, "cpu_bf16_to_fp32_trans": d16_t,
              "raft_zero_flow_cpu_rot_max_abs_diff": raft_rot,
              "raft_zero_flow_cpu_trans_tolerance_excess": raft_excess,
              "raft_zero_flow_initial_rot_max_abs_diff": raft_init_rot,
              "raft_zero_flow_initial_trans_max_abs_diff": raft_init_t,
              "identity_rot_max_abs_diff": id_rot, "identity_trans_share_of_bound": id_t,
              "identity_metrics_max_abs_diff": worst,
              "identity_add_10": want["average/add_10"], "identity_auc": want["average/auc"],
              "cpu_seconds": cpu["seconds"], "card": smi})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {tag: line["launches_per_img"] for tag, line in lines.items()}


# ---- train_workflow: the reference's train workflow from a config file ----

TW_TRAIN_IMAGES, TW_VAL_IMAGES = 48, 8
TW_ITERS, TW_RESUME_ITERS, TW_BF16_ITERS, TW_RAFT_ITERS = 30, 40, 10, 5
TW_WARMUP, TW_MEASURED, TW_TRACED = 3, 20, 5  # per worker mode; the last 5 measured traced
TW_INTERVALS = dict(log=5, checkpoint=10, evaluation=20)
TW_CPU = dict(samples=2, iters=3)  # the card-vs-CPU step: the loader's first 2 samples
# the runs that check the path load in worker processes: with the config's
# thread workers a step took 10.9 s on the card's 8-core host (the loader's
# threads starve the step's launches of the GIL), so those runs alone would
# take the script past its time limit; the timed runs measure both modes
TW_FAST = "data.worker_mode=process"


def _train_workflow_config(root: Path, repo: Path, model: str) -> Path:
    """A config that _base_s the shipped configs/refine_models/<model> and
    overrides only the data paths (data.train: the train_real split, its
    image list, keypoints and meshes, and the mesh_dir of the train
    pipeline's PoseJitter and ComputeBbox; data.val: the test set cut to
    TW_VAL_IMAGES images, its initial poses and meshes), the meshes of the
    renderer and of the pose loss, the work_dir, and the log, checkpoint
    and evaluation intervals (TW_INTERVALS)."""
    ycbv = repo / "configs" / "refine_datasets" / "ycbv_real.py"
    loss = ('model = dict(renderer=dict(mesh_dir=_root + "/models_1024"), pose_loss_cfg=dict('
            'loss_func_cfg=dict(mesh_path=_root + "/models_eval")))' if model == "scflow.py"
            else 'model = dict(renderer=dict(mesh_dir=_root + "/models_1024"))')
    path = root / f"train_{model}"
    path.write_text(f'''_base_ = {str(repo / "configs" / "refine_models" / model)!r}
_root = {str(root / "ycbv")!r}
_dataset = load_cfg_vars({str(ycbv)!r})
_meshes = _root + "/models_eval"
data = dict(
    train=dict(
        data_root=_root + "/train_real", gt_annots_root=_root + "/train_real",
        image_list=_root + "/image_lists/train_real.txt",
        keypoints_json=_root + "/keypoints/bbox.json", meshes_eval=_meshes,
        pipeline=[dict(t, mesh_dir=_meshes) if "mesh_dir" in t else t
                  for t in _dataset["train_pipeline"]]),
    val=dict(
        data_root=_root + "/test", ref_annots_root=_root + "/initial_poses",
        image_list=_root + "/image_lists/val.txt",
        keypoints_json=_root + "/keypoints/bbox.json", meshes_eval=_meshes,
        pipeline=[dict(t, mesh_dir=_meshes) if "mesh_dir" in t else t
                  for t in _dataset["val_pipeline"]]))
{loss}
work_dir = _root + "/work"
log_config = dict(interval={TW_INTERVALS["log"]})
checkpoint_config = dict(interval={TW_INTERVALS["checkpoint"]})
evaluation = dict(interval={TW_INTERVALS["evaluation"]})
del _dataset
''')
    return path


def _train_probe(timed: bool = False):
    """A runner hook (placed before the configured ones, so it sees each
    step first): every kernel count set to 0 before each step and read
    after it, CUDA events around the step, the step's loss (kept on the
    device) and the optimizer's lr, and the weights the run starts from.
    With `timed`: after TW_WARMUP steps, TW_MEASURED steps timed on the
    host clock (synchronised at both ends) with the runner's load seconds,
    the last TW_TRACED of them under torch.profiler (CUDA activity only)."""
    from scflow_tpu_torch.runtime.checkpoint import reference_state_dict
    from scflow_tpu_torch.runtime.runner import Hook

    kernels = kernel_counters()

    class Probe(Hook):
        def __init__(self):
            self.launches, self.events, self.losses, self.lrs = [], [], [], []
            self.start_weights = self.start_step = None
            self.window = {}
            self.prof = None

        def before_run(self, runner):
            self.start_weights = {k: v.clone()
                                  for k, v in reference_state_dict(runner.state.model).items()}
            self.start_step = runner.step

        def before_train_iter(self, runner):
            for k in kernels.values():
                k.launches = 0
            self.events.append([torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True)])
            self.events[-1][0].record()

        def after_train_iter(self, runner):
            self.events[-1][1].record()
            self.launches.append({name: k.launches for name, k in kernels.items()})
            self.losses.append(runner.last_log["loss"])
            self.lrs.append(runner.state.tx.tx.param_groups[0]["lr"])
            if not timed:
                return
            done = runner.step - self.start_step
            if done in (TW_WARMUP, TW_WARMUP + TW_MEASURED):
                torch.cuda.synchronize()
                self.window[done] = (time.perf_counter(), dict(runner.stats))
            if done == TW_WARMUP + TW_MEASURED - TW_TRACED:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CUDA])
                torch.cuda.synchronize()
                self.prof.start()
                self.window["trace_start"] = time.perf_counter()
            elif done == TW_WARMUP + TW_MEASURED:
                self.prof.stop()

    return Probe()


def _probe_checks(probe, tag: str, want: dict, falling: int = 0) -> dict:
    """Every step launched exactly `want` and nothing else; finite losses;
    with `falling`, the mean of the last `falling` losses below the mean of
    the first `falling`."""
    bad = [i for i, n in enumerate(probe.launches) if not only(n, **want)]
    require(not bad, f"{tag}: launches per step {probe.launches[bad[0]] if bad else ''} "
                     f"(want {want}) at steps {bad[:5]}")
    losses = [float(v) for v in probe.losses]
    require(all(math.isfinite(v) for v in losses), f"{tag}: finite losses {losses}")
    out = {"steps": len(losses), "launches_per_step": want, "losses": losses}
    if falling:
        first, last = statistics.mean(losses[:falling]), statistics.mean(losses[-falling:])
        require(last < first, f"{tag}: the loss falls (first {falling} mean {first}, last "
                              f"{last})")
        out.update(loss_first_mean=first, loss_last_mean=last)
    return out


def _log_lines(work_dir: Path, log_file: Path = None):
    """(the newest log file of a train_main run, its lines)."""
    log = log_file or max(work_dir.glob("*.log"), key=lambda p: p.stat().st_mtime)
    return log, log.read_text().splitlines()


def _its_per_s(lines) -> list:
    return [float(m.group(1)) for m in (re.search(r", ([0-9.]+) it/s,", ln) for ln in lines) if m]


def _train_card_vs_cpu_cfg(cfg_path: Path) -> dict:
    """One step of make_train_step_from_cfg on the card and on the CPU (the
    plain versions) from the same seeded weights on the loader's first
    batch of TW_CPU['samples'] samples (256^2), the config's iterations cut
    to TW_CPU['iters']: the loss within rtol 1e-3, the worst per-leaf
    gradient within rel L2 2e-2 (phase 12's bounds)."""
    import copy
    import random as pyrandom

    from scflow_tpu_torch.apis import (build_loss_assets, build_render_assets,
                                       init_model_variables, make_train_step_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.datasets import DataLoader
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.runtime.optim import build_optimizer
    from scflow_tpu_torch.runtime.train_state import TrainState

    cfg = Config.fromfile(str(cfg_path))
    cfg.merge_from_dict({"model.decoder.iters": TW_CPU["iters"]})
    pyrandom.seed(0)
    np.random.seed(0)
    it = iter(DataLoader(build_dataset(cfg.data["train"]), samples_per_step=TW_CPU["samples"],
                         num_workers=1, seed=0))
    batch = next(it)
    it.close()
    batch = {k: v for k, v in batch.items() if k not in ("img_metas", "per_img_patch_num")}
    logs, grads = {}, {}
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    init_model_variables(cfg.model, model, seed=0, device="cpu")
    models = {"cuda": copy.deepcopy(model), "cpu": model}
    for dev, m in models.items():
        assets, bank = build_render_assets(cfg.model, device=dev)
        loss_assets = build_loss_assets(cfg.model, bank.num_class, device=dev)
        tx, _ = build_optimizer(m.to(dev), dict(cfg.optimizer), dict(cfg.lr_config),
                                cfg.optimizer_config.grad_clip.max_norm)
        step = make_train_step_from_cfg(cfg, m, assets, loss_assets, (IMG, IMG), device=dev)
        state, logs[dev] = step(TrainState(m, tx), batch)
        grads[dev] = {k: p.grad.cpu() for k, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    worst, leaf = _worst_grad_rel(grads["cuda"], grads["cpu"])
    loss_rel = abs(float(logs["cuda"]["loss"]) / float(logs["cpu"]["loss"]) - 1)
    require(loss_rel <= 1e-3 and worst <= 2e-2,
            f"train_workflow card vs CPU step: loss rel {loss_rel}, worst gradient rel {worst} "
            f"({leaf})")
    return {"samples": TW_CPU["samples"], "iters": TW_CPU["iters"],
            "objects": int(len(batch["labels"])),
            "loss_card": float(logs["cuda"]["loss"]), "loss_cpu": float(logs["cpu"]["loss"]),
            "loss_rel_diff": loss_rel, "worst_grad_rel_l2": worst, "worst_leaf": leaf}


def _idle_share(probe) -> dict:
    """The device's idle share over the traced steps: 1 - (the union of the
    kernels' intervals) / (the host clock's window)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in probe.prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    t0 = probe.window["trace_start"]
    t1 = probe.window[TW_WARMUP + TW_MEASURED][0]
    window_ms = 1e3 * (t1 - t0)
    return {"traced_steps": TW_TRACED, "kernels": len(spans), "window_ms": window_ms,
            "kernel_union_ms": busy_us / 1e3,
            "idle_share": (1.0 - busy_us / 1e3 / window_ms) if spans else None}


def _timed_run(cli, cfg_path: Path, work_dir: Path, mode: str, smi) -> dict:
    """TW_WARMUP + TW_MEASURED steps of the fp32 recipe with
    data.worker_mode `mode`: ms per step (host clock over the runner loop),
    samples/s, load ms per step (time blocked in next(data_iter)), device
    ms per step (CUDA events around the step), the idle share over the
    last TW_TRACED steps."""
    probe = _train_probe(timed=True)
    steps = TW_WARMUP + TW_MEASURED
    cli.train_main([str(cfg_path), "--work-dir", str(work_dir), "--max-iters", str(steps),
                    "--cfg-options", f"data.worker_mode={mode}", "evaluation.interval=100000",
                    "checkpoint_config.interval=100000"], extra_hooks=[probe])
    _probe_checks(probe, f"timed {mode}", {"K1": ITERS, "K1b": ITERS, "K2": 1})
    (ta, sa), (tb, sb) = probe.window[TW_WARMUP], probe.window[TW_WARMUP + TW_MEASURED]
    measured = probe.events[TW_WARMUP:TW_WARMUP + TW_MEASURED]
    ms = 1e3 * (tb - ta) / TW_MEASURED
    line = {"phase": f"train_workflow_{mode}", "worker_mode": mode, "workers": 8,
            "batch": TRAIN_BATCH, "measured_steps": TW_MEASURED, "ms_per_step": ms,
            "samples_per_s": TRAIN_BATCH * 1e3 / ms,
            "load_ms_per_step": 1e3 * (sb["load"] - sa["load"]) / TW_MEASURED,
            "put_ms_per_step": 1e3 * (sb["put"] - sa["put"]) / TW_MEASURED,
            "launch_ms_per_step": 1e3 * (sb["step"] - sa["step"]) / TW_MEASURED,
            "device_ms_per_step": statistics.mean(a.elapsed_time(b) for a, b in measured),
            **_idle_share(probe), "cpu_count": os.cpu_count(), "card": smi}
    emit(line)
    return line


def phase_train_workflow(smi, root: Path):
    """The reference's train workflow (`cli.train_main`, tools/train.py's
    arguments) on the card from a config that _base_s the shipped model,
    over the synthetic YCB-V-layout train_real split: fp32 with the
    checkpoints, evaluation, profiler and TensorBoard hooks, its resume,
    a card step against a CPU step, bf16, RAFT, then both worker modes
    timed."""
    import shutil
    import warnings

    from scflow_tpu_torch import cli
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.runtime.checkpoint import read_checkpoint

    work = root / "build" / "train_workflow"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = {}
    try:
        t0 = time.perf_counter()
        dev = torch.device("cuda", 0)
        _workflow_scene(work / "ycbv", dev, TW_TRAIN_IMAGES, seed=1, split="train_real")
        _workflow_scene(work / "ycbv", dev, WF_IMAGES, seed=0, split="test")
        (work / "ycbv" / "image_lists" / "val.txt").write_text(
            "\n".join(f"{WF_SEQ:06d}/rgb/{i:06d}.png" for i in range(TW_VAL_IMAGES)))
        scene_s = time.perf_counter() - t0
        cfg_path = _train_workflow_config(work, root, "scflow.py")
        cfg = Config.fromfile(str(cfg_path))
        shipped = Config.fromfile(str(root / "configs" / "refine_models" / "scflow.py"))
        require(cfg.model.decoder.iters == ITERS and tuple(cfg.model.renderer.image_size)
                == (IMG, IMG) and cfg.data.samples_per_gpu == TRAIN_BATCH
                and cfg.data.workers_per_gpu == 8 and "worker_mode" not in cfg.data
                and cfg.optimizer == shipped.optimizer and cfg.lr_config == shipped.lr_config
                and cfg.optimizer_config == shipped.optimizer_config
                and [t["type"] for t in cfg.data.train.pipeline]
                == [t["type"] for t in shipped.data.train.pipeline], "the shipped recipe")

        # fp32: 30 steps, the hooks at their intervals
        wd = work / "fp32"
        probe = _train_probe()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            runner = cli.train_main([str(cfg_path), "--work-dir", str(wd), "--max-iters",
                                     str(TW_ITERS), "--profile-steps", "3", "--cfg-options",
                                     TW_FAST], extra_hooks=[probe])
            run_s = time.perf_counter() - t0
        fp32 = _probe_checks(probe, "fp32", {"K1": ITERS, "K1b": ITERS, "K2": 1}, falling=5)
        launches["fp32"] = fp32["launches_per_step"]
        ckpts = sorted(p.name for p in (wd / "checkpoints").glob("*.pth"))
        every = TW_INTERVALS["checkpoint"]
        require({f"iter_{n}.pth" for n in range(every, TW_ITERS + 1, every)} <= set(ckpts),
                f"checkpoints {ckpts}")
        for name in ("eval_history.json", "best.json", "best_ckpt.pth"):
            require((wd / name).exists(), f"{name} written")
        history = json.loads((wd / "eval_history.json").read_text())
        traces = sorted(str(p.relative_to(wd)) for p in (wd / "profile").glob("*.json"))
        require(traces, "a profiler trace")
        tb_files = sorted(p.name for p in (wd / "tb").glob("events.*")) if (wd / "tb").exists() \
            else []
        tb_warned = [str(w.message) for w in caught if "TensorboardHook disabled" in str(w.message)]
        require(tb_files or tb_warned, "TensorBoard event files, or the hook's warning")
        log, lines = _log_lines(wd)
        emit({"phase": "train_workflow_fp32", **fp32, "seconds": run_s, "scene_s": scene_s,
              "its_per_s_logged": _its_per_s(lines), "checkpoints": ckpts,
              "eval_history": [{"step": h["step"], "average/add_10":
                                h["metrics"].get("average/add_10")} for h in history],
              "best": json.loads((wd / "best.json").read_text()), "profile": traces,
              "tensorboard_files": tb_files, "tensorboard_warning": tb_warned[:1],
              "first_lr": probe.lrs[0], "card": smi})
        del runner

        # resume from iter 30 to 40: the weights bit for bit, the schedule's lr
        probe = _train_probe()
        runner = cli.train_main([str(cfg_path), "--work-dir", str(wd), "--resume",
                                 "--max-iters", str(TW_RESUME_ITERS), "--cfg-options", TW_FAST],
                                extra_hooks=[probe])
        saved = read_checkpoint(str(wd / "checkpoints" / f"iter_{TW_ITERS}.pth"))["state_dict"]
        require(probe.start_step == TW_ITERS and set(saved) == set(probe.start_weights)
                and all(torch.equal(saved[k], v) for k, v in probe.start_weights.items()),
                "resumed weights equal iter_30.pth bit for bit")
        log2, lines2 = _log_lines(wd)
        require(log2 != log and any(f"Resumed from iter {TW_ITERS}" in ln for ln in lines2)
                and any(f"Start training: iter {TW_ITERS} -> {TW_RESUME_ITERS}" in ln
                        for ln in lines2), f"resume log lines in {log2.name}")
        want_lr = runner.lr_schedule(TW_ITERS)  # the 31st step's (0-based count 30)
        require(probe.lrs[0] == want_lr, f"first resumed lr {probe.lrs[0]} vs {want_lr}")
        resumed = _probe_checks(probe, "resume", {"K1": ITERS, "K1b": ITERS, "K2": 1})
        emit({"phase": "train_workflow_resume", **resumed, "first_lr": probe.lrs[0],
              "schedule_lr_step_31": want_lr, "card": smi})
        del runner

        cpu = _train_card_vs_cpu_cfg(cfg_path)
        emit({"phase": "train_workflow_card_vs_cpu", **cpu, "card": smi})

        # bf16, then RAFT, each from its own work dir
        probe = _train_probe()
        cli.train_main([str(cfg_path), "--work-dir", str(work / "bf16"), "--max-iters",
                        str(TW_BF16_ITERS), "--cfg-options", "model.dtype=bfloat16", TW_FAST],
                       extra_hooks=[probe])
        bf16 = _probe_checks(probe, "bf16", {"K1_bf16": ITERS, "K1b_bf16": ITERS, "K2": 1},
                             falling=3)
        launches["bf16"] = bf16["launches_per_step"]
        emit({"phase": "train_workflow_bf16", **bf16, "card": smi})
        probe = _train_probe()
        raft_cfg = _train_workflow_config(work, root, "raft.py")
        cli.train_main([str(raft_cfg), "--work-dir", str(work / "raft"), "--max-iters",
                        str(TW_RAFT_ITERS), "--cfg-options", TW_FAST], extra_hooks=[probe])
        raft = _probe_checks(probe, "raft", {"K1": RAFT_ITERS, "K1b": RAFT_ITERS, "K2": 1})
        launches["raft"] = raft["launches_per_step"]
        emit({"phase": "train_workflow_raft", **raft, "card": smi})

        for mode in ("thread", "process"):
            _timed_run(cli, cfg_path, work / f"timed_{mode}", mode, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


PHASE_GROUPS = ("lookup", "raster", "slice", "raft", "options", "workflow",
                "train_workflow")


def run_phase_groups(groups, dev, ptxas, smi, root: Path) -> None:
    """The phases of each named group (PHASE_GROUPS), in the order given."""
    shipped = None
    for group in groups:
        if group == "lookup":
            phase_lookup(dev, ptxas)
            phase_k1b(dev, ptxas)
        elif group == "raster":
            scene = _flagship_scene(dev)
            _, k2_out = phase_k2(dev, scene)
            phase_k3(dev, scene, k2_out)
            phase_k4(dev, scene)
            phase_k56(dev, scene, k2_out)
            del scene, k2_out
        elif group == "slice":
            _, shipped = phase_slice(smi)
        elif group == "raft":
            phase_raft_all(smi)
        elif group == "workflow":
            phase_workflow(smi, root)
        elif group == "train_workflow":
            phase_train_workflow(smi, root)
        else:
            phase_raft_small(smi)
            phase_scflow_options(smi, shipped)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", type=lambda v: v.split(","), default=None,
                        metavar="GROUP[,GROUP...]",
                        help="run only the device and build phases and then these groups, "
                             f"in order: {', '.join(PHASE_GROUPS)}")
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parent,
                        help="the checkout whose scflow_tpu_torch to build and run "
                             "(default: this script's), e.g. an unpacked parent commit")
    args = parser.parse_args()
    if args.phases is not None and not set(args.phases) <= set(PHASE_GROUPS):
        parser.error(f"unknown phase groups in {args.phases}; expected {PHASE_GROUPS}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import scflow_tpu_torch  # noqa: F401  (fails at once outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    name, smi = phase_device()
    emit({"phase": "package", "path": str(Path(scflow_tpu_torch.__file__).parent)})
    ptxas = phase_build(strict=args.root.resolve() == Path(__file__).resolve().parent)
    if args.phases is not None:
        run_phase_groups(args.phases, dev, ptxas, smi, args.root.resolve())
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    scene = _flagship_scene(dev)
    res = phase_lookup(dev, ptxas)
    res.update(phase_k1b(dev, ptxas))
    res["K2"], k2_out = phase_k2(dev, scene)
    res["K3"] = phase_k3(dev, scene, k2_out)
    res["K4"] = phase_k4(dev, scene)
    k56 = phase_k56(dev, scene, k2_out)
    res["K5"], res["K6"] = k56[1], k56[2]
    del k2_out
    launches, fp32_slice = phase_slice(smi)
    launches.update(phase_render(dev, scene, smi))
    del scene
    launches.update(phase_slice_bf16(smi, fp32_slice))
    phase_infer_full(smi)
    train_launches, fp32_loss = phase_train(smi)
    launches.update(train_launches)
    launches.update(phase_train_bf16(smi, fp32_loss))
    raft_launches = phase_raft_all(smi)
    # the radius-3 instances' launches on the two option paths
    r3_launches = {"raft_small": phase_raft_small(smi),
                   "scflow_options": phase_scflow_options(smi, fp32_slice)}
    del fp32_slice
    # launches per image of each workflow run (the main path of test_main)
    wf_launches = phase_workflow(smi, args.root.resolve())
    # launches per step of each train_workflow run (the main path of train_main)
    tw_launches = phase_train_workflow(smi, args.root.resolve())
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
        ("K1_bf16", "corr_lookup on bf16 maps", "corr_lookup.cu",
         "corr_lookup.py:230 (_kernel, bf16 levels)"),
        ("K7_bf16", "corr_lookup(variant='shift') on bf16 maps", "corr_lookup_shift.cu",
         "corr_lookup.py:147 (_kernel_shift, bf16 levels)"),
        ("K8_bf16", "corr_lookup(variant='bdiag') on bf16 maps", "corr_lookup_bdiag.cu",
         "corr_lookup.py:41 (_kernel_bdiag, bf16 levels)"),
        ("K1b_bf16", "corr_lookup backward on bf16 maps", "corr_lookup_bwd.cu",
         "corr_lookup.py:346 (_lookup_bwd, bf16 levels: level grads in bf16)"),
    ]
    def radius_3(key):
        """The key's radius-3 instance: its numbers from the kernel phases
        and its launches per call or step on the option paths."""
        if f"{key}_r3" not in res:
            return {}
        got = {path: n[key] for path, n in r3_launches.items() if key in n}
        return {"radius_3": {**res[f"{key}_r3"], "launches": got}}

    def workflow(key):
        """The key's launches per image in each workflow run, and per step
        in each train_workflow run."""
        got = {run: n[key] for run, n in wf_launches.items() if key in n}
        steps = {run: n[key] for run, n in tw_launches.items() if key in n}
        return {**({"workflow_launches_per_image": got} if got else {}),
                **({"train_workflow_launches_per_step": steps} if steps else {})}

    emit({"kernels": [
        {"name": f"{key} {fn}", "route": "cuda", "source": src + file, "replaces": tpu + where,
         "launches": launches[key], **({"raft_launches": raft_launches[key]}
                                       if key in raft_launches else {}), **res[key],
         **radius_3(key), **workflow(key)}
        for key, fn, file, where in table], "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
