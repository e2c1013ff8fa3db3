#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (scflow_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases GROUP[,GROUP...] [--root DIR]

--phases runs phases 1 and 2 and then only the named groups, in the order
given, of the package in DIR (default: this checkout; e.g. an unpacked
parent commit), without the kernels line: lookup (phases 3, 10 and 11),
raster (4-7), slice (8), raft (14), options (16 and 17; with slice
before it, 17 prints its pose difference from the slice's call), workflow
(18), train_workflow (19), train_pbr (20), serve (21-23), train_augment
(24), export (25), parallel (26), learn (the learning check's tools, run
only there: see phase 27) and tools (28, plus each user tool in a fresh
process, only there).

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
               written under build/workflow/ (removed afterwards): 16
               640x480 PNGs (the port's imwrite) of 3-9 of the slice's
               21 uvsphere classes each, rendered at the gt pose with YCB-V's
               camera over grey, initial poses the gt jittered by up to 15
               degrees and 15/15/50 mm (the shipped PoseJitter's ranges).
               The slice's seeded weights, saved with save_params.  Runs,
               each after a 2-image warm-up: fp32 and bf16 (--cfg-options
               model.dtype=bfloat16) on the 16 images, and the shipped
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
               a checkpoint saved from the card loads on the CPU, equal.
               Cycled inference: fp32 with --cfg-options
               model.test_cfg.cycles=2 on 8 images (each refined, re-rendered
               at its refined pose and refined again): exactly 2 K2 and 16 K1
               per image, its ms/img, gate (c) on its export, and gate (a)
               cycle by cycle on the first 4 images' batches: the card's
               first cycle against the CPU's one-cycle call, the card's
               cycled output against the CPU's one-cycle call from the
               card's first-cycle poses (the slice's bounds), and, ungated,
               the card's against the CPU's whole cycled call (random weights
               amplify the first cycle's differences in the second);
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
               split of 24 frames (phase 18's scene with visible masks)
               with the val set 8 images of phase 18's test set.  The
               checking runs load with data.worker_mode='process' (TW_FAST:
               the config's thread workers took 10.9 s a step).  Runs,
               each counting every kernel's launches per step (reset before
               each step, read after it): fp32, 20 steps with
               --profile-steps 3: exactly 1 K2, 8 K1, 8 K1b per step,
               finite losses, the mean of the last 5 below that of the
               first 5, checkpoints iter_10/20, eval_history.json,
               best.json and best_ckpt.pth, a profiler trace, TensorBoard
               event files or the hook's warning, the logged it/s; --resume
               --max-iters 30: the log's "Resumed from iter 20" and "Start
               training: iter 20 -> 30", the weights equal iter_20.pth bit
               for bit, the first step's lr the schedule's at count 20; the
               card step against the CPU step (the plain versions) on the
               loader's first 2 samples with 3 iterations (loss rtol 1e-3,
               worst per-leaf gradient rel L2 2e-2); bf16
               (model.dtype=bfloat16), 6 steps: 8 K1_bf16, 8 K1b_bf16, 1 K2
               per step, finite, falling (first 3 against last 3); the
               shipped raft.py, 5 steps: 12 K1, 12 K1b, 1 K2 per step,
               finite; then data.worker_mode 'thread' and 'process', each 2
               warm-up steps, then 6 timed (ms per step on the host clock
               over the runner loop, samples/s, load ms per step blocked in
               next(data_iter), device ms per step by CUDA events around
               the step), the last 3 of them traced (the device's idle
               share: 1 - the union of the kernels' intervals over the host
               window), with os.cpu_count(); thread mode (8.7-11.9 s a
               step) is cut to 1 warm-up and 1 measured step, traced;
 20. train_pbr - the PBR recipe, `cli.train_main` from a config that _base_s
               the shipped scflow.py and takes ycbv_mixpbr.py's data.train and
               batch as they are (a ConcatDataset of train_real and train_pbr
               at ratios 1:2, batch 24, RandomBackground p=0.3 at index 5 of
               the pipeline, min_visib_fract 0.2 on the PBR part), the data
               paths moved to synthetic splits under build/train_pbr/
               (removed afterwards): phase 19's 24-frame train_real split
               (PNG), a 24-frame train_pbr split of 640x480 JPEGs (the port's
               encoder) with PNG visible masks and every third object's
               visib_fract recorded as 0.1, and a background directory of
               JPEG and PNG files of COCO-like sizes (one JPEG with EXIF
               orientation 6).  imread's median ms and the bytes of one
               rendered frame as PNG, as JPEG, and as JPEG after Gaussian
               noise of sigma 8 (line "train_pbr_imread"); the patches whose
               background RandomBackground swapped over 16 samples drawn in
               this process (at least one); 11 steps with process workers (2
               warm-up, 9 timed as phase 19's runs, the last 3 traced):
               exactly 1 K2, 8 K1, 8 K1b per step, finite losses, the mean
               of the last 5 below that of the first 5; the card step
               against the CPU step on the loader's first 2 samples (phase
               19's bounds);
 21. serve   - make_serving_fn(slim=True) at tools/serve_bench.py's
               configuration (64 objects from 4 uniform-noise frames of
               640x480, 256^2 patches, 8 iterations, the 21-class bank,
               culling on, the slice's seeded weights), fp32 ("serve") and
               bf16 ("serve_bf16"): exactly 8 K1 (K1_bf16) and 1 K2 per
               call; ms per call and objects/s (host clock), device ms
               (events), the crop alone; gates: the served poses equal
               make_scflow_infer_fn's on the patches and K' that
               project_bboxes + crop_resize_patches give (the slice's
               bounds), and (fp32) 4 objects served on the CPU (the plain
               versions) within the slice's card-vs-CPU bounds;
 22. serve_http - `python -m scflow_tpu_torch.cli serve` in a subprocess
               from a config that _base_s the shipped scflow.py (only the
               renderer's meshes, written under build/serve/, and the
               work_dir overridden), the slice's weights saved with
               save_params, --frame-hw 480 640 --max-objects 64
               --max-frames 8 --port 0 (the log names the port; /healthz
               polled for at most 60 s after it, the log for 300 s);
               `python -m scflow_tpu_torch.cli loadtest` with 8 clients x 3
               requests x 4 objects: req/s, objects/s, client p50/p90/p99,
               objects and requests per batch (/v1/stats); gates: 24 answers
               and /v1/stats 0 errors, SIGTERM drains and the process exits
               0, every answer equals PoseService.run of the same request in
               this process (rotations 2e-5, translations 2e-3: the padding-
               invariance bounds of tests/test_server.py), that run 8 K1 and
               1 K2; then the same load on a server started with
               --pow2-buckets ("serve_http_pow2"), the same gates but the
               answers within the slice's bounds of that run (other batch
               shapes);
 23. serve_raft - make_serving_from_cfg on a config that _base_s the shipped
               raft.py (raft_model's weights) on 4 requests of 16 objects:
               host PnP (the serve fn and its fetch; the cv2 solve where cv2
               is installed) and device PnP (PoseService.run), each 12 K1 and
               1 K2 per call, ms per call; gate: with the flow head's output
               zeroed and occ_thresh 0, the card's and the CPU's device PnP
               solve every object and return the reference poses (|dR| 2e-3,
               1 mm) on 4 objects;
 24. train_augment - the train phase's step with the render augmentations
               (ColorJiggle 0.3/0.3/0.3/0.05, RandomGaussianNoise 0.05 p 0.5,
               RandomGaussianBlur 5 (0.1, 2.0) p 0.5, RandomGrayscale 0.1):
               exactly 1 K2, 8 K1, 8 K1b per step; ms per step beside the
               plain step (plain, augmented, augmented, plain, 3 steps each);
               gates: one key's per-sample draws equal on the card and the
               CPU, and equal parameters (the card's noise field included)
               give augmented renders within 1e-5; `cli.train_main` for 3
               steps (process workers) from a config that sets
               model.render_augmentations, 1 K2, 8 K1, 8 K1b per step;
 25. export  - `python -m scflow_tpu_torch.cli export` (tools/export_model.py's
               arguments) from configs that _base_ the shipped scflow.py and
               raft.py (only the renderer's meshes, written under
               build/export/, and the work_dir overridden), --batch-size 64,
               the slice's (raft_model's) weights saved with save_params:
               fp32 with --platforms cuda cpu ("export"), bf16 with
               --cfg-options model.dtype=bfloat16 ("export_bf16") and RAFT
               with model.test_cfg.pnp_backend=device ("export_raft"), the
               three exports at once; one fresh process loads each artifact
               (load_exported) as its export ends and, once all have ended,
               calls each on the bench batch: exactly 8 K1 (K1_bf16) and 1
               K2 per SCFlow call, 12 K1 and 1 K2 per RAFT call; gates: the
               loading process has imported none of the model, refiner,
               config, apis or checkpoint modules; the loaded outputs within
               the slice's bounds of the live make_infer_from_cfg call in
               the same process (RAFT: flow 2e-2 px, occlusion 1e-3, poses
               |dR| 2e-3, 1 mm), the fp32 artifact's 'cpu' program on the
               first 4 samples within the slice's bounds of the card's, and
               that artifact cut to its 'cpu' program refuses to load for
               the card (ValueError); the export's seconds, the artifact's
               MB, the load's seconds, ms per call (host clock over 10 calls)
               and device ms beside the live call's;
 26. parallel - data parallelism (scflow_tpu_torch/parallel), under
               build/parallel/ (removed afterwards): (a) `python -m
               torch.distributed.run --standalone --nproc_per_node 1 -m
               scflow_tpu_torch.cli train --launcher pytorch` (one rank,
               NCCL) on phase 19's recipe and split with SGD in AdamW's
               place, 3 steps with process workers, against
               `cli.train_main` with --launcher none: the logged losses (4
               decimals) within 1e-4 + 1e-5 |loss|, the final parameters
               and BatchNorm buffers each apart by at most 5% of the
               distance the steps moved them (L2; two processes' rounding
               differs; another batch gives ~1); at one rank no collective
               runs, so (a) shows NCCL's start and the launcher's plumbing;
               (b) 2 ranks sharing cuda:0 over gloo (this
               script with --parallel-rank), batch 16 each, against one
               process at batch 32, one step: the shipped network, SGD 1e-3
               (momentum 0.9) + clip 10, the four render augmentations;
               the step's own rounding floor on the card is the same
               process's step with BatchNorm's statistics summed in float64
               (the ranks' path) instead of float32 means: each log within
               rtol 1e-5, atol 1e-6 (tests/test_torch_parallel.py's bounds)
               or 3 x its floor, the per-leaf gradients (shares of the
               global norm) within 3 x theirs, every weight and BatchNorm
               buffer after the step within rtol 1e-5, atol 1e-6; the
               floor itself under 1% of the norm, and 2 ranks that keep
               their own BatchNorm statistics must miss these bounds;
               exactly 1 K2, 8 K1, 8 K1b per rank in each of 4 steps; each
               rank's ms per step over 2 more steps, the gradient
               all-reduce's ms, one process's ms at batch 32 with and
               without the float64 sums, in turns; (c) `cli test --launcher
               pytorch` at 2 ranks (gloo) on 5 images of phase 18's set
               against one process: the same results within the slice's
               bounds, in order, and the BOP export equal to --out; (d)
               PoseService over Mesh(['cuda:0', 'cuda:0']) (a serve fn per
               device from parallel.replicate) at tools/serve_bench.py's 64
               objects against one device: 8 K1 and 1 K2 per shard, the
               poses within the slice's bounds, ms per call of each.  Every
               part runs; any failure fails the phase;
 27. learn   - the learning check (scflow_tpu_torch/tools/overfit_check.py, the
               JAX package's tools/overfit_check.py: one synthetic batch of 8
               cube samples at 128^2, 4 iterations, AdamW 4e-4) for
               LEARN_STEPS steps on lookup 'pallas', then one evaluation:
               every step exactly 1 K2, 4 K1 and 4 K1b, the evaluation 1 K2
               and 4 K1, nothing else; finite losses; the train-batch ADD/d
               below its initial value / LEARN_FACTOR (fixed from the learn
               group's full-length runs: at most half the smallest factor
               they showed at LEARN_STEPS); ms per step.
     The learn group (--phases learn, not in the full run): the same check
               at the tool's 2000 steps on 'xla' (JAX's default: 1 K2 a
               step) and on 'pallas', evaluated every LEARN_STEPS, each step
               counted; each curve's final ADD/d below its initial one (the
               JAX tool expects below 0.01); the 'pallas' run's weights
               saved with save_params to build/learn/overfit_pallas.pth;
               `cli serve-bench` in fp32 and bf16 (64 objects, 8 K1 or
               K1_bf16 and 1 K2 a call) in this process; `cli warmup` on a
               config that _base_s the shipped scflow.py with only its
               paths moved (the slice's meshes), in a fresh process; and
               `cli bf16-parity` at PARITY's scale, whose exit code (1 on
               PROTOCOL FAIL) is the group's, with its report, crossings,
               divergence and the train's seconds per step.  Every part
               runs; any failure fails the group;
 28. tools   - the user tools in this process, on phase 18's synthetic
               YCB-V layout written under build/tools/ (removed afterwards:
               TOOLS_IMAGES test images of 3 objects, TOOLS_SAMPLES
               train_real frames) from a config that _base_s the shipped
               scflow.py with only its paths moved, and the slice's seeded
               weights saved with save_params: `cli keypoints` in each mode
               on the 21 meshes (21 x 8 x 3, finite; 'bbox' the set's own
               box corners within 1e-3); `cli browse` on TOOLS_SAMPLES
               samples with and without --skip-types PoseJitter (every
               file decodes at 256 x 256 x 3); `cli visualize` on
               TOOLS_IMAGES images, every count read and set to 0 as each
               image's batch is padded: exactly 1 K2 and 8 K1 per image
               (the infer call; the 'xla' silhouette render launches none),
               none before the first, finite poses, one panel per object
               decoding at 256 x 512 x 3; `cli mmflow-convert --strict
               --save-torch` on a seeded RAFT of the shipped raft.py saved
               in mmflow's layout: its --out loads into that model with
               every tensor equal, the duplicated file has real_encoder.*
               keys, and --strict on the file without one key raises
               naming it; seconds of each (visualize per image: load,
               infer, render, draw).
     The tools group (--phases tools, not in the full run): phase 28, then
               each of the four commands once as `python -m
               scflow_tpu_torch.cli ...` in a fresh process on the card
               (exit code 0, its outputs), with each process's seconds;
 15. the kernels line (float32 and bf16 instances; "raft_launches": each
     kernel's launches per RAFT call or step; "radius_3": the radius-3
     instance's numbers from phases 3/10/11 and its launches per call or
     step on phases 16 and 17; "workflow_launches_per_image": per image of
     each workflow run, the cycled one included;
     "train_workflow_launches_per_step": per step of the fp32, bf16 and
     RAFT train_workflow runs and of the train_pbr run; "serve_launches":
     per call of each serving run and per step of the augmented steps;
     "export_launches": per call of each loaded artifact; "parallel_launches":
     per step of each rank of phase 26 (b) and per shard of its mesh
     service (d); "learn_launches": per step and per evaluation of phase
     27's learning check; "tools_launches": per image of phase 28's cli
     visualize), then the device line the chip harness reads.
Imports no JAX.  Needs one card; without one it exits non-zero at once.
"""

import argparse
import itertools
import json
import math
import os
import re
import statistics
import struct
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


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's clock at its
    end ("script_s")."""
    if "phase" in obj:
        obj = {**obj, "script_s": round(time.perf_counter() - T0, 1)}
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
# 16 images: the count is cut (48 -> 24 -> 16) so that the script keeps
# inside its time with the later phases
WF_IMAGES, WF_CPU_IMAGES, WF_RAFT_IMAGES = 16, 4, 8
WF_JITTER = (15.0, 15.0, 15.0, 50.0)  # degrees, x, y, z mm: ycbv_real.py:38-51's PoseJitter
WF_METRIC = {"add": [0.05, 0.10, 0.20, 0.50], "rep": [2, 5, 10, 20], "auc": []}
WF_CYCLES, WF_CYCLED_IMAGES = 2, 8  # the cycled run: test_cfg.cycles, images


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
    mask_visib/{image}_{object}.png; 'train_pbr' does too, writes the frames
    as JPEG (the port's encoder, quality 95, 4:2:0) and records every third
    object's visib_fract as 0.1 (below ycbv_pbr.py's min_visib_fract 0.2).
    The first 4 images hold 3, 3, 4 and 4 objects (the CPU gate's 4-object
    buckets).  Returns the gt, the initial poses and the meshes' vertices."""
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
    train = split in ("train_real", "train_pbr")
    ext = "jpg" if split == "train_pbr" else "png"
    if train:
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
        imwrite(str(seq / "rgb" / f"{i:06d}.{ext}"),
                np.clip(np.rint(img[..., ::-1] * 255), 0, 255).astype(np.uint8))
        if train:
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
                                   visib_fract=0.1 if split == "train_pbr" and (i + o) % 3 == 0
                                   else float(visible[o].sum() / full[o].sum()))
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
        "\n".join(f"{WF_SEQ:06d}/rgb/{i:06d}.{ext}" for i in range(images)))
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


def _workflow_run(cli, args, k1: str, iters: int, tag: str, smi, extra=None, k2: int = 1):
    """One counted test_main run: its launches (exactly `iters` of k1 and
    `k2` K2 per image, nothing else), finite orthonormal poses, and its
    line."""
    res, launches = counted(lambda: cli.test_main(args))
    n_img = len(res["results"])
    n_obj = sum(len(r["pred"]["labels"]) for r in res["results"])
    require(only(launches, **{k1: iters * n_img, "K2": k2 * n_img}),
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


def _cycled_card_vs_cpu(cfg_path: Path, ckpt: Path) -> dict:
    """Gate (a) for cycled inference, cycle by cycle, on the first
    WF_CPU_IMAGES images' batches (make_infer_from_cfg's calls, as test_main
    makes them): the card's first cycle against the CPU's one-cycle call on
    the same batch, and the card's cycled output against the CPU's
    one-cycle call started from the card's first-cycle poses, each within
    the slice's bounds (rotations 2e-3, translations 2e-2 + 2e-3 |t|).
    Also returns, ungated, the largest difference between the card's and
    the CPU's whole cycled calls: with random weights the second cycle
    amplifies the first's small differences."""
    from scflow_tpu_torch.apis import build_render_assets, make_infer_from_cfg
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.datasets.loader import collate_batch
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.registry import build_dataset
    from scflow_tpu_torch.runtime.checkpoint import load_params

    cfg = Config.fromfile(str(cfg_path))
    calls = {}
    for dev in ("cuda", "cpu"):
        model = build_refiner_from_config(cfg.model)
        load_params(str(ckpt), model)
        assets, _ = build_render_assets(cfg.model, device=dev)
        for cycles in (1, WF_CYCLES):
            cfg.merge_from_dict({"model.test_cfg.cycles": cycles})
            calls[dev, cycles], _ = make_infer_from_cfg(cfg, model, assets, (IMG, IMG),
                                                        slim=True, device=dev)
    np.random.seed(0)
    dataset = build_dataset(cfg.data["test"])
    worst = {"cycle_1": [0.0, -math.inf], "cycle_2": [0.0, -math.inf],
             "end_to_end": [0.0, 0.0]}

    def record(key, got, want, bound: bool):
        R = [v["rotations"].cpu().numpy() for v in (got, want)]
        t = [v["translations"].cpu().numpy() for v in (got, want)]
        rot = float(np.abs(R[0] - R[1]).max())
        dt = np.abs(t[0] - t[1])
        excess = float((dt - (2e-2 + 2e-3 * np.abs(t[1]))).max()) if bound else float(dt.max())
        worst[key] = [max(worst[key][0], rot), max(worst[key][1], excess)]

    for idx in range(WF_CPU_IMAGES):
        batch = collate_batch([dataset[idx]])
        batch = {k: v for k, v in batch.items() if k not in ("img_metas", "per_img_patch_num")}
        card1, cardc = calls["cuda", 1](batch), calls["cuda", WF_CYCLES](batch)
        record("cycle_1", card1, calls["cpu", 1](batch), True)
        from_card = dict(batch, ref_rotations=card1["rotations"].cpu().numpy(),
                         ref_translations=card1["translations"].cpu().numpy())
        record("cycle_2", cardc, calls["cpu", 1](from_card), True)
        record("end_to_end", cardc, calls["cpu", WF_CYCLES](batch), False)
    for key in ("cycle_1", "cycle_2"):
        require(worst[key][0] <= 2e-3 and worst[key][1] <= 0,
                f"(a) cycled, {key}, card vs CPU: rot |d| {worst[key][0]}, t excess "
                f"{worst[key][1]}")
    return {"cycled_cycle_1_rot_max_abs_diff": worst["cycle_1"][0],
            "cycled_cycle_1_trans_tolerance_excess": worst["cycle_1"][1],
            "cycled_cycle_2_rot_max_abs_diff": worst["cycle_2"][0],
            "cycled_cycle_2_trans_tolerance_excess": worst["cycle_2"][1],
            "cycled_end_to_end_rot_max_abs_diff": worst["end_to_end"][0],
            "cycled_end_to_end_trans_max_abs_diff": worst["end_to_end"][1]}


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
        # cycled inference (test_cfg.cycles): each image re-rendered at its
        # refined pose and refined again, on WF_CYCLED_IMAGES images; gate (c)
        # on its export, gate (a) cycle by cycle on the first 4 images
        copts = ["--cfg-options", f"model.test_cfg.cycles={WF_CYCLES}"]
        cli.test_main(base + ["--limit", "1"] + copts)  # warm-up
        out_json, save_dir = work / "scflow_cycled.json", work / "bop_cycled"
        _, _, lines["scflow_cycled"] = _workflow_run(
            cli, base + ["--limit", str(WF_CYCLED_IMAGES), "--eval", "--format-only",
                         "--save-dir", str(save_dir), "--out", str(out_json)] + copts,
            "K1", WF_CYCLES * ITERS, "scflow_cycled", smi, {"cycles": WF_CYCLES}, k2=WF_CYCLES)
        _bop_matches_out(save_dir, out_json, WF_CYCLED_IMAGES)
        cycled = _cycled_card_vs_cpu(cfg_path, ckpt)
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
              **cycled,
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

TW_TRAIN_IMAGES, TW_VAL_IMAGES = 24, 8
TW_ITERS, TW_RESUME_ITERS, TW_BF16_ITERS, TW_RAFT_ITERS = 20, 30, 6, 5
# timed steps of a worker mode: warm-up, measured, and the last of the measured
# traced; thread mode (8.7-11.9 s a step) is cut to 1 + 1, process mode to
# 2 + 6, to keep the script inside its time
TW_TIMED = {"process": (2, 6, 3), "thread": (1, 1, 1)}
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


def _train_probe(timed=None):
    """A runner hook (placed before the configured ones, so it sees each
    step first): every kernel count set to 0 before each step and read
    after it, CUDA events around the step, the step's loss (kept on the
    device) and the optimizer's lr, and the weights the run starts from.
    With `timed` = (warm-up, measured, traced): after the warm-up steps,
    the measured steps timed on the host clock (synchronised at both ends)
    with the runner's load seconds, the last `traced` of them under
    torch.profiler (CUDA activity only)."""
    from scflow_tpu_torch.runtime.checkpoint import reference_state_dict
    from scflow_tpu_torch.runtime.runner import Hook

    kernels = kernel_counters()

    class Probe(Hook):
        def __init__(self):
            self.warmup, self.measured, self.traced = timed or (0, 0, 0)
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
            end = self.warmup + self.measured
            if done in (self.warmup, end):
                torch.cuda.synchronize()
                self.window[done] = (time.perf_counter(), dict(runner.stats))
            if done == end - self.traced:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CUDA])
                torch.cuda.synchronize()
                self.prof.start()
                self.window["trace_start"] = time.perf_counter()
            elif done == end:
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
    t1 = probe.window[probe.warmup + probe.measured][0]
    window_ms = 1e3 * (t1 - t0)
    return {"traced_steps": probe.traced, "kernels": len(spans), "window_ms": window_ms,
            "kernel_union_ms": busy_us / 1e3,
            "idle_share": (1.0 - busy_us / 1e3 / window_ms) if spans else None}


def _timed_run(cli, cfg_path: Path, work_dir: Path, mode: str, smi, timed=None,
               phase: str = None, batch: int = TRAIN_BATCH, falling: int = 0) -> dict:
    """`timed` = (warm-up, measured, traced) steps (TW_TIMED[mode] by
    default) of the config's fp32 recipe with data.worker_mode `mode`: ms
    per step (host clock over the runner loop), samples/s, load ms per step
    (time blocked in next(data_iter)), device ms per step (CUDA events
    around the step), the idle share over the traced steps; exactly 1 K2,
    8 K1 and 8 K1b per step, finite losses and, with `falling`, falling."""
    warmup, measured, traced = timed or TW_TIMED[mode]
    probe = _train_probe(timed=(warmup, measured, traced))
    phase = phase or f"train_workflow_{mode}"
    cli.train_main([str(cfg_path), "--work-dir", str(work_dir), "--max-iters",
                    str(warmup + measured), "--cfg-options", f"data.worker_mode={mode}",
                    "evaluation.interval=100000", "checkpoint_config.interval=100000"],
                   extra_hooks=[probe])
    checks = _probe_checks(probe, phase, {"K1": ITERS, "K1b": ITERS, "K2": 1}, falling)
    (ta, sa), (tb, sb) = probe.window[warmup], probe.window[warmup + measured]
    events = probe.events[warmup:warmup + measured]
    ms = 1e3 * (tb - ta) / measured
    line = {"phase": phase, "worker_mode": mode, "workers": 8, "batch": batch,
            "warmup_steps": warmup, "measured_steps": measured, "ms_per_step": ms,
            "samples_per_s": batch * 1e3 / ms,
            "load_ms_per_step": 1e3 * (sb["load"] - sa["load"]) / measured,
            "put_ms_per_step": 1e3 * (sb["put"] - sa["put"]) / measured,
            "launch_ms_per_step": 1e3 * (sb["step"] - sa["step"]) / measured,
            "device_ms_per_step": statistics.mean(a.elapsed_time(b) for a, b in events),
            **_idle_share(probe), "cpu_count": os.cpu_count(),
            **({k: checks[k] for k in ("loss_first_mean", "loss_last_mean")} if falling else {}),
            "launches_per_step": checks["launches_per_step"], "card": smi}
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
        _workflow_scene(work / "ycbv", dev, TW_VAL_IMAGES, seed=0, split="test")
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
        want_lr = runner.lr_schedule(TW_ITERS)  # the resumed first step's (0-based count)
        require(probe.lrs[0] == want_lr, f"first resumed lr {probe.lrs[0]} vs {want_lr}")
        resumed = _probe_checks(probe, "resume", {"K1": ITERS, "K1b": ITERS, "K2": 1})
        emit({"phase": "train_workflow_resume", **resumed, "first_lr": probe.lrs[0],
              f"schedule_lr_step_{TW_ITERS + 1}": want_lr, "card": smi})
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


# ---- train_pbr: the PBR recipe (configs/refine_datasets/ycbv_mixpbr.py's data) ----

TP_PBR_IMAGES = 24
TP_STEPS = (2, 9, 3)  # warm-up, measured, traced: 11 steps in process mode
TP_BATCH = 24  # ycbv_mixpbr.py's samples_per_gpu
TP_SWAP_SAMPLES = 16
# background images of other sizes than the frames, as in COCO (one JPEG
# carries EXIF orientation 6, which imread 'color' applies)
TP_BACKGROUNDS = (("000000000001.jpg", 427, 640), ("000000000002.jpg", 333, 500),
                  ("000000000003.png", 480, 640), ("000000000004.png", 375, 500))


def _relocated(obj, ycbv: Path, coco: Path):
    """A plain copy of a config value with the shipped data paths moved to
    the synthetic set."""
    if isinstance(obj, dict):
        return {k: _relocated(v, ycbv, coco) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_relocated(v, ycbv, coco) for v in obj)
    if isinstance(obj, str):
        return obj.replace("data/ycbv", str(ycbv)).replace("data/coco", str(coco))
    return obj


def _exif_orientation_app1(orientation: int) -> bytes:
    """An APP1 Exif segment holding only IFD0's Orientation tag."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIH", 0x0112, 3, 1, orientation) + b"\x00\x00"
            + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _pbr_backgrounds(coco: Path) -> None:
    """TP_BACKGROUNDS, colour ramps with noise, by the port's imwrite."""
    from scflow_tpu_torch.datasets.pipelines.imops import imwrite

    coco.mkdir(parents=True)
    rng = np.random.default_rng(11)
    for i, (name, h, w) in enumerate(TP_BACKGROUNDS):
        y, x = np.mgrid[:h, :w]
        img = np.stack([x * 255 // w, y * 255 // h, (x * (i + 1) + y) % 256], -1)
        img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
        imwrite(str(coco / name), img)
    first = coco / TP_BACKGROUNDS[0][0]
    data = first.read_bytes()
    first.write_bytes(data[:2] + _exif_orientation_app1(6) + data[2:])


def _train_pbr_config(root: Path, repo: Path) -> Path:
    """A config that _base_s the shipped configs/refine_models/scflow.py and
    takes configs/refine_datasets/ycbv_mixpbr.py's data.train (a
    ConcatDataset of train_real and train_pbr at ratios 1:2, RandomBackground
    p=0.3 at index 5 of the pipeline, min_visib_fract 0.2 on the PBR part)
    and samples_per_gpu (24) as they are, the data paths moved to the
    synthetic set; the val set, meshes, work_dir and intervals as
    _train_workflow_config has them."""
    from scflow_tpu_torch.config import Config

    mix = Config.fromfile(str(repo / "configs" / "refine_datasets" / "ycbv_mixpbr.py"))
    train = _relocated(mix.data["train"], root / "ycbv", root / "coco")
    train["_delete_"] = True
    path = root / "train_pbr_scflow.py"
    base = _train_workflow_config(root, repo, "scflow.py").read_text()
    path.write_text(base + f"""data["samples_per_gpu"] = {mix.data["samples_per_gpu"]}
data["train"] = {train!r}
evaluation = dict(interval=100000)
checkpoint_config = dict(interval=100000)
""")
    return path


def _background_swaps(cfg_path: Path) -> dict:
    """Patches whose background RandomBackground swapped, counted in this
    process over TP_SWAP_SAMPLES samples of the config's train set (every
    k-th index, so both parts are drawn)."""
    import random as pyrandom

    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.datasets.pipelines.color import RandomBackground
    from scflow_tpu_torch.registry import build_dataset

    dataset = build_dataset(Config.fromfile(str(cfg_path)).data["train"])
    seen = {"patches": 0, "swapped": 0}
    for part in dataset.datasets:
        for t in part.transformer.transforms:
            if isinstance(t, RandomBackground):
                def counting(img, mask=None, _augment=t.augment):
                    out = _augment(img, mask)
                    seen["patches"] += 1
                    seen["swapped"] += out is not img
                    return out

                t.augment = counting
    pyrandom.seed(0)
    np.random.seed(0)
    step = max(len(dataset) // TP_SWAP_SAMPLES, 1)
    for i in range(TP_SWAP_SAMPLES):
        dataset[i * step]
    return seen


def _imread_times(frame_png: Path, work: Path) -> dict:
    """imread ms (median of 5 after one read) and bytes of a rendered
    640x480 frame as PNG, as JPEG (the port's encoder, quality 95), and as
    JPEG after Gaussian noise of sigma 8."""
    from scflow_tpu_torch.datasets.pipelines.imops import imread, imwrite

    frame = imread(str(frame_png), "unchanged")
    noisy = np.clip(frame + np.random.default_rng(3).normal(0, 8, frame.shape), 0, 255)
    files = {"png": frame_png, "jpeg_smooth": work / "smooth.jpg",
             "jpeg_noisy": work / "noisy.jpg"}
    imwrite(str(files["jpeg_smooth"]), frame)
    imwrite(str(files["jpeg_noisy"]), noisy.astype(np.uint8))
    out = {}
    for name, path in files.items():
        imread(str(path), "unchanged")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            imread(str(path), "unchanged")
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = {"ms": statistics.median(times), "bytes": path.stat().st_size}
    return out


def phase_train_pbr(smi, root: Path):
    """The PBR recipe: `cli.train_main` on the card from a config with the
    shipped scflow.py model and ycbv_mixpbr.py's data (train_real PNG and
    train_pbr JPEG frames at 1:2, batch 24, RandomBackground p=0.3) over
    synthetic splits of TW_TRAIN_IMAGES and TP_PBR_IMAGES 640x480 frames
    and a background directory: 20 steps with process workers, timed as
    train_workflow's runs are (1 K2, 8 K1, 8 K1b per step, the loss
    falling); a card step against a CPU step on the loader's first
    samples; the background swaps; imread's times on JPEG and PNG."""
    import shutil

    from scflow_tpu_torch import cli

    work = root / "build" / "train_pbr"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        dev = torch.device("cuda", 0)
        ycbv = work / "ycbv"
        _workflow_scene(ycbv, dev, TW_TRAIN_IMAGES, seed=1, split="train_real")
        _workflow_scene(ycbv, dev, TP_PBR_IMAGES, seed=2, split="train_pbr")
        _workflow_scene(ycbv, dev, TW_VAL_IMAGES, seed=0, split="test")
        (ycbv / "image_lists" / "val.txt").write_text(
            "\n".join(f"{WF_SEQ:06d}/rgb/{i:06d}.png" for i in range(TW_VAL_IMAGES)))
        _pbr_backgrounds(work / "coco")
        scene_s = time.perf_counter() - t0
        cfg_path = _train_pbr_config(work, root)
        decode = _imread_times(ycbv / "train_real" / f"{WF_SEQ:06d}" / "rgb" / "000000.png",
                               work)
        emit({"phase": "train_pbr_imread", "frame": [FRAME_H, FRAME_W], **decode,
              "scene_s": scene_s, "card": smi})
        swaps = _background_swaps(cfg_path)
        require(swaps["swapped"] >= 1, f"train_pbr: a background swapped ({swaps})")
        line = _timed_run(cli, cfg_path, work / "pbr", "process", smi, timed=TP_STEPS,
                          phase="train_pbr", batch=TP_BATCH, falling=5)
        cpu = _train_card_vs_cpu_cfg(cfg_path)
        emit({"phase": "train_pbr_gates", "background_patches": swaps["patches"],
              "background_swapped": swaps["swapped"], "card_vs_cpu": cpu, "card": smi})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"pbr": line["launches_per_step"]}


# ---- serving: make_serving_fn, the HTTP server, RAFT serving, augmented steps ----

SERVE_FRAMES = 4  # tools/serve_bench.py: 64 objects from 4 frames of 640x480
SERVE_KEYS = ("frames", "frame_idx", "ref_rotations", "ref_translations", "K", "labels")
SERVE_CPU_OBJECTS = 4  # the card-vs-CPU gate's objects
SERVE_LOAD = dict(clients=8, requests=3, objects=4)  # the HTTP phase's load test
SERVE_START_S = 300  # the server subprocess's bound to come up
# the padding-invariance bounds of tests/test_server.py:321-331
SERVE_ROT_ATOL, SERVE_TRANS_ATOL = 2e-5, 2e-3
RENDER_AUGMENTATIONS = [
    dict(type="ColorJiggle", brightness=0.3, contrast=0.3, saturation=0.3, hue=0.05),
    dict(type="RandomGaussianNoise", std=0.05, p=0.5),
    dict(type="RandomGaussianBlur", kernel_size=5, sigma=(0.1, 2.0), p=0.5),
    dict(type="RandomGrayscale", p=0.1)]
TA_CLI_STEPS, TA_CLI_IMAGES = 3, 8  # the augmented cli train run
TA_TIMED_STEPS = 3  # per group of the plain / augmented timing


def serve_inputs(n: int = BATCH, frames: int = SERVE_FRAMES, seed: int = 0) -> dict:
    """tools/serve_bench.py's inputs: uniform-noise 640x480 frames (in [0, 1],
    the range make_serving_fn takes; serve_bench passes 0-255), n objects
    spread over them, random rotations, t = (60 N(0,1), 40 N(0,1),
    U(700, 1100)) mm, the LINEMOD focal lengths at the frame's centre, random
    labels."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    R = quat_to_matrix(torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)))
    t = np.stack([rng.normal(size=n) * 60, rng.normal(size=n) * 40,
                  rng.uniform(700, 1100, n)], -1).astype(np.float32)
    K = np.tile(np.array([[[572.4, 0, FRAME_W / 2], [0, 573.5, FRAME_H / 2], [0, 0, 1]]],
                         np.float32), (n, 1, 1))
    return dict(frames=rng.uniform(0, 1, (frames, FRAME_H, FRAME_W, 3)).astype(np.float32),
                frame_idx=rng.integers(0, frames, n).astype(np.int32),
                ref_rotations=R.float().numpy(), ref_translations=t, K=K,
                labels=rng.integers(0, NCLASS, n).astype(np.int32))


def _poses_ok(R, t, ref_t, tag: str) -> float:
    require(np.isfinite(R).all() and np.isfinite(t).all(), f"{tag}: finite poses")
    ortho = float(np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max())
    require(ortho < 1e-4, f"{tag}: |R^T R - I| {ortho} < 1e-4")
    require(float(np.abs(t - ref_t).max()) > 1.0, f"{tag}: poses moved")
    return ortho


def _slice_bounds(R, t, R_ref, t_ref, what: str):
    """The slice's card-vs-CPU bounds: rotations 2e-3, translations 2e-2 +
    2e-3 |t|.  Returns (largest |dR|, largest excess over the t bound)."""
    d_rot = float(np.abs(R - R_ref).max())
    t_excess = float((np.abs(t - t_ref) - (2e-2 + 2e-3 * np.abs(t_ref))).max())
    require(d_rot <= 2e-3 and t_excess <= 0, f"{what}: rot |d| {d_rot}, t excess {t_excess}")
    return d_rot, t_excess


def phase_serve(smi):
    """make_serving_fn(slim=True) at tools/serve_bench.py's configuration
    (64 objects from 4 frames of 640x480, 256^2 patches, 8 iterations, the
    21-class bank, culling on), fp32 and bf16: launches per call, ms per
    call and objects/s, device ms, the crop alone; gates: serving equals
    make_scflow_infer_fn on the patches and K' crop_resize_patches gives,
    and (fp32) 4 objects served on the CPU agree with the card's."""
    from scflow_tpu_torch.device import full_fp32
    from scflow_tpu_torch.refiners.scflow import SCFlowRefiner
    from scflow_tpu_torch.refiners.system import RenderAssets, make_scflow_infer_fn
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from scflow_tpu_torch.serving import crop_resize_patches, make_serving_fn, project_bboxes

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    assets = RenderAssets.from_bank(bank)
    inputs = serve_inputs()
    dev = torch.device("cuda", 0)
    args = [torch.from_numpy(inputs[k]).to(dev) for k in SERVE_KEYS]

    def crop():
        with torch.inference_mode(), full_fp32():
            boxes = project_bboxes(assets.verts, assets.vert_valid, *args[2:])
            return crop_resize_patches(args[0], boxes, args[1], args[4], IMG)

    launches, fp32 = {}, None
    for tag, dtype, k1 in (("serve", None, "K1"), ("serve_bf16", torch.bfloat16, "K1_bf16")):
        model = seeded_model(dtype)
        serve = make_serving_fn(model, assets, assets.verts, assets.vert_valid, image_size=IMG,
                                iters=ITERS, render_cull_backfaces=True, slim=True)
        serve(*args)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        out, c = counted(lambda: serve(*args))
        require(only(c, K2=1, **{k1: ITERS}), f"{tag}: launches per call {c}")
        launches[tag] = c
        R, t = out["rotations"].cpu().numpy(), out["translations"].cpu().numpy()
        ortho = _poses_ok(R, t, inputs["ref_translations"], tag)
        # serving is the crop, then the infer entry point
        patches, new_k = crop()
        infer = make_scflow_infer_fn(model, assets, image_size=(IMG, IMG), iters=ITERS,
                                     render_cull_backfaces=True, slim=True)
        ref = infer(dict(real_images=patches, ref_rotations=args[2], ref_translations=args[3],
                         k=new_k, labels=args[5]))
        vs_infer = _slice_bounds(R, t, ref["rotations"].cpu().numpy(),
                                 ref["translations"].cpu().numpy(), f"{tag} vs infer")
        line = {"serve_vs_infer_rot_max_abs_diff": vs_infer[0],
                "serve_vs_infer_trans_max_abs_diff":
                    float(np.abs(t - ref["translations"].cpu().numpy()).max())}
        if dtype is None:
            cpu_model = SCFlowRefiner(num_class=NCLASS, image_size=(IMG, IMG), iters=ITERS)
            cpu_model.load_state_dict(model.state_dict())
            cpu_assets = RenderAssets.from_bank(bank, device="cpu")
            cpu_serve = make_serving_fn(cpu_model, cpu_assets, cpu_assets.verts,
                                        cpu_assets.vert_valid, image_size=IMG, iters=ITERS,
                                        render_backend="pallas", render_cull_backfaces=True,
                                        lookup_backend="pallas", slim=True, device="cpu")
            n = SERVE_CPU_OBJECTS
            cpu = cpu_serve(*(torch.from_numpy(inputs[k] if k == "frames" else inputs[k][:n])
                              for k in SERVE_KEYS))
            d_rot, t_excess = _slice_bounds(R[:n], t[:n], cpu["rotations"].numpy(),
                                            cpu["translations"].numpy(), f"{tag}: card vs CPU")
            line.update(cpu_objects=n, cpu_rot_max_abs_diff=d_rot,
                        cpu_trans_tolerance_excess=t_excess)
            fp32 = (R, t)
        else:
            line["pose_diff_vs_fp32"] = _pose_dist(R, t, *fp32)
        calls = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            serve(*args)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / calls
        emit({"phase": tag, "objects": BATCH, "frames": SERVE_FRAMES,
              "frame_hw": [FRAME_H, FRAME_W], "image": IMG, "iters": ITERS, "classes": NCLASS,
              "launches_per_call": c, "orthonormality_err": ortho, **line,
              "ms_per_call": 1e3 * dt, "objects_per_s": BATCH / dt,
              "device_ms_per_call": device_ms(lambda: serve(*args), reps=3, groups=3),
              "crop_ms": median_ms(crop, reps=5, groups=3), "card": smi})
        del model, serve, infer
    return launches


def _serve_work(root: Path, name: str = "serve") -> Path:
    """build/<name>/ with the slice's 21 uvsphere meshes as .ply files
    (models_1024/), which the serve (and export) configs' renderer reads."""
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    work = root / "build" / name
    meshes = work / "models_1024"
    if not meshes.exists():
        meshes.mkdir(parents=True)
        bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
        for c in range(NCLASS):
            _write_ply(meshes / f"obj_{c + 1:06d}.ply", bank.verts[c][bank.vert_valid[c]],
                       bank.faces[c][bank.face_valid[c]], bank.colors[c][bank.vert_valid[c]])
    return work


def _serve_config(work: Path, repo: Path, model: str) -> Path:
    """A config that _base_s the shipped configs/refine_models/<model> and
    overrides only the renderer's meshes and the work_dir."""
    path = work / f"serve_{model}"
    path.write_text(f'''_base_ = {str(repo / "configs" / "refine_models" / model)!r}
model = dict(renderer=dict(mesh_dir={str(work / "models_1024")!r}))
work_dir = {str(work / "work")!r}
''')
    return path


def _serve_service(cfg, ckpt: Path, **cfg_options):
    """PoseService over make_serving_from_cfg on the card, as serve_main
    builds it, from the config (with cfg_options) and the checkpoint."""
    from scflow_tpu_torch.apis import (build_render_assets, load_eval_checkpoint,
                                       make_serving_from_cfg)
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.server import PoseService

    cfg.merge_from_dict(cfg_options)
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    model.cuda()
    assets, bank = build_render_assets(cfg.model)
    load_eval_checkpoint(str(ckpt), model)
    serve_fn, keys, post_fn = make_serving_from_cfg(cfg, model, assets)
    return PoseService(serve_fn, frame_hw=(FRAME_H, FRAME_W), num_class=bank.num_class,
                       max_frames=8, max_objects=BATCH, fetch_keys=keys, post_fn=post_fn)


def _serve_load(cfg_path: Path, ckpt: Path, root: Path, tag: str, extra=()) -> dict:
    """Start `python -m scflow_tpu_torch.cli serve` (--frame-hw 480 640
    --max-objects 64 --max-frames 8 --port 0, then `extra`) in a
    subprocess, wait for the port in its log and for /healthz, drive it
    with `cli loadtest` (SERVE_LOAD, answers saved), read /v1/stats, send
    SIGTERM and wait for the exit.  Gates: every request answered, 0
    errors, exit code 0 after the drain.  The process is killed on any
    failure."""
    import queue
    import signal
    import threading
    from urllib.request import urlopen

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "scflow_tpu_torch.cli", "serve", str(cfg_path), "--checkpoint",
         str(ckpt), "--frame-hw", str(FRAME_H), str(FRAME_W), "--max-objects", str(BATCH),
         "--max-frames", "8", "--port", "0", *extra],
        cwd=str(root), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, ports = [], queue.Queue()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                ports.put(int(m.group(1)))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        try:
            port = ports.get(timeout=SERVE_START_S)
        except queue.Empty:
            raise RuntimeError(f"{tag}: the server did not come up in {SERVE_START_S} s: "
                               + " | ".join(lines[-20:]))
        url = f"http://127.0.0.1:{port}"
        deadline = time.perf_counter() + 60
        while True:
            try:
                if urlopen(url + "/healthz", timeout=5).read() == b"ok":
                    break
            except OSError:
                pass
            require(time.perf_counter() < deadline and proc.poll() is None,
                    f"{tag}: the server answers /healthz within 60 s")
            time.sleep(0.5)
        up_s = time.perf_counter() - t0
        answers = cfg_path.parent / f"{tag}_responses.npz"
        load = subprocess.run(
            [sys.executable, "-m", "scflow_tpu_torch.cli", "loadtest", "--url", url,
             "--clients", str(SERVE_LOAD["clients"]), "--requests", str(SERVE_LOAD["requests"]),
             "--objects", str(SERVE_LOAD["objects"]), "--frame-hw", str(FRAME_H), str(FRAME_W),
             "--num-class", str(NCLASS), "--timeout", "120", "--save-responses", str(answers)],
            cwd=str(root), env=env, capture_output=True, text=True, timeout=600)
        require(load.returncode == 0, f"{tag}: cli loadtest: {load.stderr[-2000:]}")
        report = json.loads(next(ln for ln in load.stdout.splitlines()
                                 if ln.startswith('{"requests_ok"')))
        stats = json.loads(urlopen(url + "/v1/stats", timeout=10).read())
        n = SERVE_LOAD["clients"] * SERVE_LOAD["requests"]
        require(report["requests_ok"] == n and report["requests_failed"] == 0,
                f"{tag}: loadtest report {report}")
        require(stats["errors"] == 0 and stats["requests"] == n, f"{tag}: /v1/stats {stats}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
        require(rc == 0 and any("shutting down" in ln for ln in lines),
                f"{tag}: SIGTERM drains and exits 0 (exit code {rc}): " + " | ".join(lines[-5:]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    lat = report["latency_ms"]
    line = {"requests_per_s": report["requests_per_s"], "objects_per_s": report["objects_per_s"],
            "client_p50_ms": lat["p50"], "client_p90_ms": lat["p90"],
            "client_p99_ms": lat["p99"], "wall_s": report["wall_s"],
            "objects_per_batch": stats["mean_objects_per_batch"],
            "requests_per_batch": stats["mean_requests_per_batch"], "batches": stats["batches"],
            "server_latency_ms": stats["latency_ms"], "errors": stats["errors"],
            "server_up_s": up_s, "sigterm_exit_code": rc}
    return dict(line=line, answers=np.load(answers))


def phase_serve_http(smi, root: Path):
    """`python -m scflow_tpu_torch.cli serve` as a subprocess on the card,
    from a config that _base_s the shipped scflow.py, the slice's seeded
    weights saved with save_params, --frame-hw 480 640 --max-objects 64
    --max-frames 8 --port 0; `cli loadtest` (8 clients x 3 requests x 4
    objects) drives it (_serve_load's gates).  Gate: every answer equals
    PoseService.run of the same request (rotations 2e-5, translations
    2e-3), a run of 8 K1 and 1 K2.  Then the same load on a server with
    --pow2-buckets ("serve_http_pow2": batches padded to their power of
    two), its answers within the slice's bounds of the same run."""
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.checkpoint import save_params
    from scflow_tpu_torch.runtime.server import RefineRequest

    work = _serve_work(root)
    cfg_path = _serve_config(work, root, "scflow.py")
    cfg = Config.fromfile(str(cfg_path))
    require(cfg.model.decoder.iters == ITERS and tuple(cfg.model.renderer.image_size)
            == (IMG, IMG) and cfg.model.decoder.pose_head_cfg.num_class == NCLASS
            and cfg.model.renderer.cull_backfaces is True, "the shipped model")
    with torch.random.fork_rng(devices=[]):
        model = build_refiner_from_config(cfg.model)
    model.load_state_dict(seeded_model().state_dict())
    ckpt = work / "scflow.pth"
    save_params(str(ckpt), model)
    runs = {"serve_http": _serve_load(cfg_path, ckpt, root, "serve_http"),
            "serve_http_pow2": _serve_load(cfg_path, ckpt, root, "serve_http_pow2",
                                           ["--pow2-buckets"])}

    # every answer against PoseService.run of the same request, alone
    service = _serve_service(Config.fromfile(str(cfg_path)), ckpt)
    z = runs["serve_http"]["answers"]
    req = RefineRequest(frame=z["request_frame"], rotations=z["request_rotations"],
                        translations=z["request_translations"], k=z["request_k"],
                        labels=z["request_labels"])
    service.run([req])  # warm-up
    (direct,), c = counted(lambda: service.run([req]))
    require(only(c, K1=ITERS, K2=1), f"serve_http: PoseService.run launches {c}")
    n = SERVE_LOAD["clients"] * SERVE_LOAD["requests"]
    for tag, run in runs.items():
        z = run["answers"]
        d_rot = float(np.abs(z["rotations"] - direct["rotations"][None]).max())
        d_t = float(np.abs(z["translations"] - direct["translations"][None]).max())
        require(len(z["rotations"]) == n, f"{tag}: {n} answers saved")
        if tag == "serve_http":
            require(d_rot <= SERVE_ROT_ATOL and d_t <= SERVE_TRANS_ATOL,
                    f"{tag}: answers vs PoseService.run: rot |d| {d_rot}, t |d| {d_t}")
        else:
            _slice_bounds(z["rotations"].reshape(-1, 3, 3), z["translations"].reshape(-1, 3),
                          np.tile(direct["rotations"], (n, 1, 1)),
                          np.tile(direct["translations"], (n, 1)), f"{tag} vs PoseService.run")
        emit({"phase": tag, **SERVE_LOAD, "frame_hw": [FRAME_H, FRAME_W], "max_objects": BATCH,
              "max_frames": 8, "pow2_buckets": tag.endswith("pow2"), **run["line"],
              "answers_vs_run_rot_max_abs_diff": d_rot, "answers_vs_run_trans_max_abs_diff": d_t,
              "run_launches": c, "card": smi})
    return {"serve_http_run": c}


def _serve_requests(inputs, per_request: int):
    """serve_inputs' objects as RefineRequests of `per_request` objects, each
    on its own frame (the inputs' frame i % frames, as uint8)."""
    from scflow_tpu_torch.runtime.server import RefineRequest

    frames = np.rint(inputs["frames"] * 255).astype(np.uint8)
    return [RefineRequest(frame=frames[i % len(frames)],
                          rotations=inputs["ref_rotations"][s:s + per_request],
                          translations=inputs["ref_translations"][s:s + per_request],
                          k=inputs["K"][s], labels=inputs["labels"][s:s + per_request])
            for i, s in enumerate(range(0, len(inputs["labels"]), per_request))]


def phase_serve_raft(smi, root: Path):
    """make_serving_from_cfg on a config that _base_s the shipped raft.py,
    raft_model's weights: host PnP (the serve fn and its fetch of the flow,
    occlusion, depth, K' and reference poses; the host solve needs cv2,
    which runs only where it is installed) and device PnP
    (test_cfg.pnp_backend=device: PoseService.run) on 4 requests of 16
    objects; 12 K1 and 1 K2 per call; ms per call.  Gate: with the flow
    head's output zeroed, the card's and the CPU's device PnP give the
    reference poses (|dR| 2e-3, 1 mm: the raft phase's gt-flow bounds)."""
    import importlib.util

    from scflow_tpu_torch.apis import _raft_pnp_cfg
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from scflow_tpu_torch.runtime.checkpoint import save_params
    from scflow_tpu_torch.serving import make_raft_serving_fn

    work = _serve_work(root)
    cfg_path = _serve_config(work, root, "raft.py")
    ckpt = work / "raft.pth"
    save_params(str(ckpt), raft_model())
    requests = _serve_requests(serve_inputs(), BATCH // 4)
    res, launches = {}, {}
    host = _serve_service(Config.fromfile(str(cfg_path)), ckpt)
    host.dispatch(requests)  # warm-up
    torch.cuda.synchronize()
    (out, events, counts), c = counted(lambda: host.dispatch(requests))
    for event in events:
        event.synchronize()
    require(only(c, K1=RAFT_ITERS, K2=1), f"serve_raft host: launches per call {c}")
    launches["serve_raft_host"] = {k: n for k, n in c.items() if n}
    require(set(out) == set(host.fetch_keys) and out["flow"].shape == (BATCH, IMG, IMG, 2)
            and bool(torch.isfinite(out["flow"]).all()), "serve_raft host: the fetched outputs")
    if importlib.util.find_spec("cv2") is not None:
        poses = host.post_fn({k: v.numpy() for k, v in out.items()})
        _poses_ok(poses["rotations"], poses["translations"], out["ref_translations"].numpy(),
                  "serve_raft host PnP")
        res["host_pnp"] = "solved with cv2"
        res["host_ms_per_call"] = _timed_calls(lambda: host.fetch(host.dispatch(requests)),
                                               calls=5)
    else:
        res["host_pnp"] = "not run: cv2 is not installed (the serve fn and its fetch ran)"
        res["host_ms_per_call_without_pnp"] = _timed_calls(
            lambda: [e.synchronize() for e in host.dispatch(requests)[1]], calls=5)
    del host
    device = _serve_service(Config.fromfile(str(cfg_path)), ckpt,
                            **{"model.test_cfg.pnp_backend": "device"})
    device.run(requests)
    torch.cuda.synchronize()
    got, c = counted(lambda: device.run(requests))
    require(only(c, K1=RAFT_ITERS, K2=1), f"serve_raft device: launches per call {c}")
    launches["serve_raft_device"] = {k: n for k, n in c.items() if n}
    R = np.concatenate([g["rotations"] for g in got])
    t = np.concatenate([g["translations"] for g in got])
    res["device_orthonormality_err"] = _poses_ok(R, t, np.concatenate(
        [r.translations for r in requests]), "serve_raft device")
    res["device_ms_per_call"] = _timed_calls(lambda: device.run(requests), calls=5)
    del device
    # card vs CPU on exact correspondences: the flow head's output zeroed
    cfg = Config.fromfile(str(cfg_path))
    # occ_thresh 0: every rendered pixel a correspondence, so the solve runs
    # whatever the random occlusion head predicts
    pnp_cfg = dict(_raft_pnp_cfg(cfg.model.test_cfg), occ_thresh=0.0)
    inputs = serve_inputs(SERVE_CPU_OBJECTS)
    zero = raft_model()
    with torch.no_grad():
        zero.decoder.flow_pred.predict_layer.weight.zero_()
        zero.decoder.flow_pred.predict_layer.bias.zero_()
    cpu_zero = raft_model()
    cpu_zero.load_state_dict(zero.state_dict())
    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    poses = {}
    for dev_name, m in (("cuda", zero), ("cpu", cpu_zero)):
        assets = RenderAssets.from_bank(bank, device=dev_name)
        serve = make_raft_serving_fn(m, assets, assets.verts, assets.vert_valid, image_size=IMG,
                                     render_backend="pallas", render_cull_backfaces=True,
                                     lookup_backend="pallas", pnp_backend="device",
                                     pnp_cfg=pnp_cfg, device=dev_name)
        o = serve(*(torch.from_numpy(inputs[k]) for k in SERVE_KEYS))
        require(bool(o["pnp_ok"].all()) and float(o["flow"].abs().max()) == 0,
                f"zero flow on {dev_name}: PnP ok")
        poses[dev_name] = (o["rotations"].cpu().numpy(), o["translations"].cpu().numpy())
    for dev_name, (Rz, tz) in poses.items():
        dR = float(np.abs(Rz - inputs["ref_rotations"]).max())
        dt = float(np.abs(tz - inputs["ref_translations"]).max())
        require(dR <= 2e-3 and dt <= 1.0, f"zero flow on {dev_name}: |dR| {dR}, |dt| {dt} mm")
        res[f"zero_flow_{dev_name}_vs_reference"] = [dR, dt]
    emit({"phase": "serve_raft", "objects": BATCH, "requests": len(requests),
          "frame_hw": [FRAME_H, FRAME_W], "image": IMG, "iters": RAFT_ITERS,
          "zero_flow_pnp": pnp_cfg, "launches_per_call": launches, **res, "card": smi})
    return launches


def phase_train_augment(smi, root: Path):
    """The shipped recipe's step (batch 16, 256^2, 8 iterations, lookup
    'pallas') with RENDER_AUGMENTATIONS: 1 K2, 8 K1, 8 K1b per step; ms per
    step beside the same step without them (plain, augmented, augmented,
    plain); gate: the card and the CPU draw the same per-sample parameters
    for one key, and equal parameters (the card's noise field included)
    give equal augmented renders (1e-5); then `cli.train_main` for
    TA_CLI_STEPS steps from a config that sets model.render_augmentations,
    with the same launches per step."""
    import copy
    import shutil

    from scflow_tpu_torch import cli
    from scflow_tpu_torch.models.augment import build_render_augmentation
    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from scflow_tpu_torch.render.renderer import render_batch

    want = {"K1": ITERS, "K1b": ITERS, "K2": 1}
    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    state0, plain, assets, _ = _train_setup(train_model(IMG, ITERS), bank, IMG)
    augmented = _train_setup(state0.model, bank, IMG,
                             render_augmentations=RENDER_AUGMENTATIONS)[1]
    batch = train_batch(assets, TRAIN_BATCH, IMG)
    for step in (plain, augmented):  # warm-up: cuDNN plans, allocator, Adam moments
        state0, _ = step(state0, batch)
    torch.cuda.synchronize()
    (_, logs), c = counted(lambda: augmented(copy.deepcopy(state0), batch))
    require(only(c, **want), f"augmented train step launches {c}")
    require(math.isfinite(float(logs["loss"])), "augmented step: finite loss")
    ms = {"plain": [], "augmented": []}
    state = copy.deepcopy(state0)
    for name in ("plain", "augmented", "augmented", "plain"):
        step = plain if name == "plain" else augmented
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TA_TIMED_STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / TA_TIMED_STEPS)
    del state

    # equal parameters, equal renders on the card and the CPU
    aug = build_render_augmentation(RENDER_AUGMENTATIONS)
    images = {}
    for dev_name in ("cuda", "cpu"):
        a = RenderAssets.from_bank(bank, device=dev_name)
        with torch.no_grad():
            images[dev_name] = render_batch(
                *a, *(torch.as_tensor(batch[k], device=dev_name) for k in
                      ("ref_rotations", "ref_translations", "k")),
                torch.as_tensor(batch["labels"], device=dev_name), IMG, IMG, backend="pallas",
                cull_backfaces=True)["images"]
    key = (0, 7)
    p_card, p_cpu = aug.draw(key, images["cuda"]), aug.draw(key, images["cpu"])
    same = all(torch.equal(a[k].cpu(), b[k]) for a, b in zip(p_card, p_cpu) for k in a
               if k != "noise")
    require(same, "the card and the CPU draw the same per-sample parameters")
    gates = [p["gate"].tolist() for p in p_card]
    got = aug.apply(images["cuda"], p_card).cpu()
    ref = aug.apply(images["cpu"], [{k: v.cpu() for k, v in p.items()} for p in p_card])
    render_err = float((images["cuda"].cpu() - images["cpu"]).abs().max())
    aug_err = float((got - ref).abs().max())
    require(aug_err <= 1e-5, f"augmented renders, card vs CPU: {aug_err}")
    launches = {"train_augment": c}

    # cli train with render_augmentations in its config file
    work = root / "build" / "train_augment"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        _workflow_scene(work / "ycbv", torch.device("cuda", 0), TA_CLI_IMAGES, seed=1,
                        split="train_real")
        base = _train_workflow_config(work, root, "scflow.py")
        cfg_path = work / "train_augment.py"
        cfg_path.write_text(f"_base_ = {str(base)!r}\n"
                            f"model = dict(render_augmentations={RENDER_AUGMENTATIONS!r})\n")
        probe = _train_probe()
        cli.train_main([str(cfg_path), "--work-dir", str(work / "run"), "--max-iters",
                        str(TA_CLI_STEPS), "--num-workers", "2", "--cfg-options", TW_FAST],
                       extra_hooks=[probe])
        cli_run = _probe_checks(probe, "train_augment cli", want)
        dumped = (work / "run" / "config_dump.py").read_text()
        require("render_augmentations" in dumped and "RandomGaussianBlur" in dumped,
                "the config's render_augmentations reached train_main")
        launches["train_augment_cli"] = probe.launches[-1]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "train_augment", "batch": TRAIN_BATCH, "image": IMG, "iters": ITERS,
          "augmentations": RENDER_AUGMENTATIONS, "launches_per_step": c,
          "loss": float(logs["loss"]), "ms_per_step_augmented": ms["augmented"],
          "ms_per_step_plain": ms["plain"], "card_cpu_render_max_abs_diff": render_err,
          "card_cpu_augmented_max_abs_diff": aug_err, "gates_key_0_7": gates,
          "cli_train": cli_run, "card": smi})
    return launches


EXPORT_CPU_SAMPLES = 4  # the 'cpu' program's samples held to the card's
EXPORT_TIMEOUT_S = 900  # each export process, and the loading process
EXPORT_MODEL_CODE = ("models", "refiners", "config", "apis", "runtime.checkpoint")


def export_loader(spec_path: Path) -> dict:
    """The loading side of phase 25 (`chip_smoke.py --export-loader SPEC`),
    one fresh process for every artifact of spec["runs"]: load_exported on
    the card of each artifact as soon as its export has finished (its
    "<artifact>.ready" marker; the loads overlap the exports still
    running), with spec["cpu"] its 'cpu' program too, and with
    spec["refusal"] the artifact cut to that program, loaded for the card
    (it must raise ValueError); once every export has finished, each loaded
    program's call on the batch with every launch count reset, ms per call
    (host clock over 10 calls) and device ms; the import gate (none of
    EXPORT_MODEL_CODE loaded); the 'cpu' programs on the batch; then each
    live call, built from the config and checkpoint as cli export builds
    it (which imports the model code, after the gate), its launches and
    times.  Saves the outputs to <artifact>.npz and returns the numbers
    per run."""
    from scflow_tpu_torch.runtime.export import load_exported, read_meta

    spec = json.loads(Path(spec_path).read_text())
    runs = spec["runs"]
    res = {tag: {} for tag in runs}
    calls, cpu_calls, waiting = {}, {}, list(runs)
    while waiting:
        ready = [t for t in waiting if Path(runs[t]["artifact"] + ".ready").exists()]
        failed = [t for t in waiting if Path(runs[t]["artifact"] + ".failed").exists()]
        if failed:
            raise RuntimeError(f"export failed: {failed}")
        if not ready:
            time.sleep(0.5)
            continue
        tag = ready[0]
        waiting.remove(tag)
        run, r = runs[tag], res[tag]
        t0 = time.perf_counter()
        calls[tag], meta = load_exported(run["artifact"])
        r["load_s"] = time.perf_counter() - t0
        if run["cpu"]:
            t0 = time.perf_counter()
            cpu_calls[tag] = load_exported(run["artifact"], device="cpu")[0]
            r["cpu_load_s"] = time.perf_counter() - t0
            data = Path(run["artifact"]).read_bytes()
            (n,) = struct.unpack_from("<Q", data, 8)
            cut = json.dumps(dict(read_meta(data), platforms=["cpu"],
                                  programs={"cpu": meta["programs"]["cpu"]})).encode()
            try:
                load_exported(data[:8] + struct.pack("<Q", len(cut)) + cut + data[16 + n:])
                r["refusal"] = None
            except ValueError as e:
                r["refusal"] = str(e)
    batch = dict(np.load(spec["batch"]))
    arrays = {tag: {} for tag in runs}
    for tag, call in calls.items():
        r = res[tag]
        call(batch)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        out, r["launches_per_call"] = counted(lambda: call(batch))
        r["ms_per_call"] = _timed_calls(lambda: call(batch))
        r["device_ms_per_call"] = device_ms(lambda: call(batch), reps=2, groups=2)
        arrays[tag].update({f"loaded_{k}": v.cpu().numpy() for k, v in out.items()})
    imported = sorted(m for m in sys.modules if any(
        m == f"scflow_tpu_torch.{n}" or m.startswith(f"scflow_tpu_torch.{n}.")
        for n in EXPORT_MODEL_CODE))
    for tag, call in cpu_calls.items():
        t0 = time.perf_counter()
        arrays[tag].update({f"cpu_{k}": v.numpy() for k, v in call(batch).items()})
        res[tag]["cpu_call_s"] = time.perf_counter() - t0
    from scflow_tpu_torch.apis import (build_render_assets, load_eval_checkpoint,
                                       make_infer_from_cfg)
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config

    for tag, run in runs.items():
        r = res[tag]
        cfg = Config.fromfile(run["config"])
        if run["cfg_options"]:
            cfg.merge_from_dict(Config.parse_options(run["cfg_options"]))
        with torch.random.fork_rng(devices=[]):
            model = build_refiner_from_config(cfg.model)
        assets, _ = build_render_assets(cfg.model)
        load_eval_checkpoint(run["checkpoint"], model.cuda())
        live, _ = make_infer_from_cfg(cfg, model, assets, (IMG, IMG), slim=True)
        live(batch)
        torch.cuda.synchronize()
        out, r["live_launches_per_call"] = counted(lambda: live(batch))
        r["live_ms_per_call"] = _timed_calls(lambda: live(batch))
        r["live_device_ms_per_call"] = device_ms(lambda: live(batch), reps=2, groups=2)
        arrays[tag].update({f"live_{k}": v.cpu().numpy() for k, v in out.items()})
        np.savez(run["artifact"] + ".npz", **arrays[tag])
        del model, live, assets
    return {"runs": res, "model_code_imported": imported}


def _export_start(tag: str, cfg_path: Path, ckpt: Path, work: Path, root: Path, env,
                  options, platforms):
    """`python -m scflow_tpu_torch.cli export` of one artifact, started (not
    waited for): (process, artifact path, log path, start time)."""
    out = work / f"{tag}.scflowx"
    log = work / f"{tag}.log"
    cmd = [sys.executable, "-m", "scflow_tpu_torch.cli", "export", str(cfg_path),
           "--checkpoint", str(ckpt), "--out", str(out), "--batch-size", str(BATCH),
           "--platforms", *platforms]
    if options:
        cmd += ["--cfg-options", *options]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=str(root), env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    return proc, out, log, time.perf_counter()


def phase_export(smi, root: Path) -> dict:
    """Phase 25: `python -m scflow_tpu_torch.cli export` of the shipped
    scflow.py (fp32 for 'cuda' and 'cpu'; bf16 with --cfg-options
    model.dtype=bfloat16 for 'cuda') and raft.py (test_cfg.pnp_backend
    device, 'cuda'), each at --batch-size 64 with the slice's (raft_model's)
    seeded weights saved with save_params and the meshes under
    build/export/ (removed afterwards); the three exports run at once, each
    in its own process, and one fresh process loads and calls the
    artifacts (export_loader).  Gates: exactly 8 K1 (K1_bf16) and 1 K2 per
    loaded SCFlow call, 12 K1 and 1 K2 per RAFT call, as many as the live
    call; the loading process had imported none of EXPORT_MODEL_CODE after
    loading and calling every artifact; the loaded poses within the slice's
    bounds of the live make_infer_from_cfg call on the bench batch (RAFT:
    flow 2e-2 px, occlusion 1e-3, poses |dR| 2e-3 and 1 mm); the fp32
    artifact's 'cpu' program on the same batch within the slice's bounds of
    the card's on the first 4 samples; that artifact cut to its 'cpu'
    program refuses to load for the card.  Returns {run: launches per
    loaded call}."""
    import shutil

    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.checkpoint import save_params

    work = _serve_work(root, "export")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    try:
        cfgs = {m: _serve_config(work, root, f"{m}.py") for m in ("scflow", "raft")}
        cfg = Config.fromfile(str(cfgs["scflow"]))
        require(cfg.model.decoder.iters == ITERS and tuple(cfg.model.renderer.image_size)
                == (IMG, IMG) and cfg.model.decoder.pose_head_cfg.num_class == NCLASS
                and cfg.model.renderer.cull_backfaces is True, "the shipped model")
        ckpts = {"scflow": work / "scflow.pth", "raft": work / "raft.pth"}
        with torch.random.fork_rng(devices=[]):
            model = build_refiner_from_config(cfg.model)
        model.load_state_dict(seeded_model().state_dict())
        save_params(str(ckpts["scflow"]), model)
        save_params(str(ckpts["raft"]), raft_model())
        del model
        batch = bench_batch()
        np.savez(work / "batch.npz", **batch)
        runs = {"export": ("scflow", [], ["cuda", "cpu"], {"K1": ITERS, "K2": 1}),
                "export_bf16": ("scflow", ["model.dtype=bfloat16"], ["cuda"],
                                {"K1_bf16": ITERS, "K2": 1}),
                "export_raft": ("raft", ["model.test_cfg.pnp_backend=device"], ["cuda"],
                                {"K1": RAFT_ITERS, "K2": 1})}
        started = {tag: _export_start(tag, cfgs[m], ckpts[m], work, root, env, opts, platforms)
                   for tag, (m, opts, platforms, _) in runs.items()}
        procs = [v[0] for v in started.values()]
        spec = work / "loader_spec.json"
        spec.write_text(json.dumps({"batch": str(work / "batch.npz"), "runs": {
            tag: {"artifact": str(started[tag][1]), "config": str(cfgs[m]),
                  "checkpoint": str(ckpts[m]), "cfg_options": opts, "cpu": "cpu" in platforms}
            for tag, (m, opts, platforms, _) in runs.items()}}))
        t_loader = time.perf_counter()
        loader_log = work / "loader.log"
        with open(loader_log, "w") as f:
            loader = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--root", str(root),
                 "--export-loader", str(spec)], cwd=str(root), env=env, stdout=f,
                stderr=subprocess.STDOUT)
        procs.append(loader)
        export_s, pending = {}, dict(started)
        while pending:
            for tag, (proc, out, log, t0) in list(pending.items()):
                rc = proc.poll()
                if rc is None:
                    continue
                del pending[tag]
                export_s[tag] = time.perf_counter() - t0
                Path(f"{out}.{'ready' if rc == 0 else 'failed'}").touch()
                require(rc == 0, f"{tag}: cli export exited {rc}: {log.read_text()[-3000:]}")
            require(time.perf_counter() - t_loader < EXPORT_TIMEOUT_S, "the exports finish")
            require(loader.poll() in (None, 0), "the loading process runs: "
                    + loader_log.read_text()[-3000:])
            time.sleep(0.2)
        rc = loader.wait(timeout=EXPORT_TIMEOUT_S)
        loader_s = time.perf_counter() - t_loader
        text = loader_log.read_text()
        require(rc == 0, f"the loading process exited {rc}: {text[-3000:]}")
        got = json.loads(text.strip().splitlines()[-1])
        require(not got["model_code_imported"],
                f"the loading process imported {got['model_code_imported']}")
        launches = {}
        for tag, (m, opts, platforms, want) in runs.items():
            res = got["runs"][tag]
            artifact = started[tag][1]
            z = np.load(f"{artifact}.npz")
            require(only(res["launches_per_call"], **want),
                    f"{tag}: loaded launches per call {res['launches_per_call']}")
            require(res["live_launches_per_call"] == res["launches_per_call"],
                    f"{tag}: live launches per call {res['live_launches_per_call']}")
            launches[tag] = res["launches_per_call"]
            line = {"loaded_vs_live_rot_max_abs_diff": float(np.abs(
                        z["loaded_rotations"] - z["live_rotations"]).max()),
                    "loaded_vs_live_trans_max_abs_diff": float(np.abs(
                        z["loaded_translations"] - z["live_translations"]).max())}
            if m == "raft":
                d_flow = float(np.abs(z["loaded_flow"] - z["live_flow"]).max())
                d_occ = float(np.abs(z["loaded_occlusion"] - z["live_occlusion"]).max())
                require(d_flow <= 2e-2 and d_occ <= 1e-3
                        and line["loaded_vs_live_trans_max_abs_diff"] <= 1.0
                        and line["loaded_vs_live_rot_max_abs_diff"] <= 2e-3,
                        f"{tag}: loaded vs live: flow {d_flow}, occlusion {d_occ}, {line}")
                line.update(loaded_vs_live_flow_max_abs_diff=d_flow,
                            loaded_vs_live_occlusion_max_abs_diff=d_occ,
                            pnp_ok=int(z["loaded_pnp_ok"].sum()))
            else:
                _slice_bounds(z["loaded_rotations"], z["loaded_translations"],
                              z["live_rotations"], z["live_translations"],
                              f"{tag}: loaded vs live")
                line["orthonormality_err"] = _poses_ok(
                    z["loaded_rotations"], z["loaded_translations"], batch["ref_translations"],
                    tag)
            if "cpu" in platforms:
                n = EXPORT_CPU_SAMPLES
                d_rot, t_excess = _slice_bounds(
                    z["loaded_rotations"][:n], z["loaded_translations"][:n],
                    z["cpu_rotations"][:n], z["cpu_translations"][:n],
                    f"{tag}: the 'cpu' program vs the card's")
                require(res["refusal"] is not None and "platforms ['cpu']" in res["refusal"],
                        f"{tag}: a 'cpu' artifact loaded for the card: {res['refusal']}")
                line.update(cpu_samples=n, cpu_rot_max_abs_diff=d_rot,
                            cpu_trans_tolerance_excess=t_excess, cpu_load_s=res["cpu_load_s"],
                            cpu_call_s=res["cpu_call_s"], refusal=res["refusal"])
            emit({"phase": tag, "batch": BATCH, "image": IMG, "platforms": platforms,
                  "cfg_options": opts, "export_s": export_s[tag],
                  "exports_at_once": len(runs), "artifact_mb": artifact.stat().st_size / 1e6,
                  "load_s": res["load_s"], "loader_s": loader_s,
                  "launches_per_call": res["launches_per_call"], **line,
                  "ms_per_call": res["ms_per_call"],
                  "device_ms_per_call": res["device_ms_per_call"],
                  "live_ms_per_call": res["live_ms_per_call"],
                  "live_device_ms_per_call": res["live_device_ms_per_call"], "card": smi})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
    return launches


def serve_phases(smi, root: Path) -> dict:
    """The serving phases (serve, serve_http, serve_raft), build/serve/
    removed afterwards; {run: launches per call}."""
    import shutil

    try:
        launches = phase_serve(smi)
        launches.update(phase_serve_http(smi, root))
        launches.update(phase_serve_raft(smi, root))
    finally:
        shutil.rmtree(root / "build" / "serve", ignore_errors=True)
    return launches


# ---- parallel: data-parallel train, test and serve (phase 26) ----

PAR_TIMED = 2  # the timed steps after the compared one
PAR_FLOOR = 3.0  # (b): allowed distance in units of the step's own rounding floor
PAR_FLOOR_MAX = 1e-2  # (b): the floor's own bound, as a share of the gradients' norm
PAR_A_SHARE = 0.05  # (a): the runs' weights apart, as a share of what their steps moved
PAR_OPT = dict(type="SGD", lr=1e-3, momentum=0.9)  # updates linear in the gradient
PAR_AUGMENT = [dict(type="ColorJiggle", brightness=0.3, contrast=0.3, saturation=0.3, hue=0.05),
               dict(type="RandomGaussianNoise", std=0.05, p=0.5),
               dict(type="RandomGaussianBlur", kernel_size=5, sigma=(0.1, 2.0), p=0.5),
               dict(type="RandomGrayscale", p=0.1)]
PAR_RTOL, PAR_ATOL = 1e-5, 1e-6  # tests/test_torch_parallel.py's bounds
PAR_TRAIN_ITERS, PAR_TEST_IMAGES = 3, 5  # (a)'s steps; (c)'s images (odd: shards 3 and 2)
PAR_START_S = 600  # a torchrun job's bound


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _job_env(root: Path, **extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(root), env.get("PYTHONPATH", "")])
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _torchrun(root: Path, nproc: int, args, tag: str):
    """Start `python -m torch.distributed.run --standalone --nproc_per_node N
    -m scflow_tpu_torch.cli ARGS`; returns wait() -> (its output, which a
    failure prints, seconds from the start), which kills a job that
    outlives PAR_START_S."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", str(nproc), "-m", "scflow_tpu_torch.cli", *args],
                            cwd=str(root), env=_job_env(root), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        try:
            out = proc.communicate(timeout=max(PAR_START_S - (time.perf_counter() - t0), 1))[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        require(proc.returncode == 0, f"{tag}: torchrun exited {proc.returncode}: {out[-3000:]}")
        return out, time.perf_counter() - t0

    return wait


def parallel_rank(spec_path: Path) -> dict:
    """One rank of phase 26 (b), in a process of its own with torchrun's
    variables set: the shipped train step on its rows of the global batch,
    data-parallel (process_group WORLD), one compared step, then PAR_TIMED
    timed steps (each counted apart), and the gradient all-reduce alone.  Writes
    its logs and state to the spec's out path.  A planted spec (each rank's
    own BatchNorm statistics) runs the compared step alone."""
    import torch.distributed as dist

    from scflow_tpu_torch.parallel import (average_gradients, maybe_initialize_distributed,
                                           rank_world)
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    spec = torch.load(spec_path, weights_only=False)
    dev = maybe_initialize_distributed("pytorch")
    rank, world = rank_world()
    if spec["plant"]:  # each rank's own BatchNorm statistics: (b)'s gate must refuse it
        from scflow_tpu_torch.models import layers

        layers.batch_sum = lambda x: x
    model = train_model(IMG, ITERS)
    model.load_state_dict(spec["weights"])
    state, step, _, _ = _train_setup(model, make_synthetic_bank(NCLASS, kind="uvsphere",
                                                                size=80.0), IMG, device=dev,
                                     lr_cfg=None, optimizer=PAR_OPT,
                                     render_augmentations=PAR_AUGMENT, augment_seed=3,
                                     process_group=dist.group.WORLD)
    n = len(spec["batch"]["labels"]) // world
    batch = {k: v[rank * n:(rank + 1) * n] for k, v in spec["batch"].items()}
    (state, log), c = counted(lambda: step(state, batch))
    logs, counts, grads = {k: float(v) for k, v in log.items()}, [c], _step_grads(state)
    weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    if spec["plant"]:
        torch.save(dict(rank=rank, logs=logs, grads=grads, state=weights),
                   f"{spec['out']}.rank{rank}")
        dist.destroy_process_group()
        return {"rank": rank}
    for _ in range(PAR_TIMED):  # the timed steps' launches too, counted apart
        (state, _), c = counted(lambda: step(state, batch))
        counts.append(c)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / PAR_TIMED
    reduce_ms = []
    for _ in range(3):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        average_gradients(state.tx.params, dist.group.WORLD)
        torch.cuda.synchronize()
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
    out = dict(rank=rank, world=world, device=str(dev), backend=dist.get_backend(), logs=logs,
               counts=counts, grads=grads, state=weights, ms_per_step=ms,
               allreduce_ms=statistics.median(reduce_ms),
               grad_mb=sum(p.numel() for p in state.tx.params) * 4 / 1e6)
    torch.save(out, f"{spec['out']}.rank{rank}")
    dist.destroy_process_group()
    return {"rank": rank}


def _par_train_recipe(smi, root: Path, work: Path):
    """(a): torchrun --nproc_per_node 1 ... train --launcher pytorch (NCCL),
    started in the background, against --launcher none in this process,
    phase 19's recipe and split with SGD in AdamW's place (updates linear
    in the gradient), PAR_TRAIN_ITERS steps each: the logged losses and the
    final checkpoints.  Returns the part that runs this
    process's run, waits for the job and compares."""
    _workflow_scene(work / "ycbv", torch.device("cuda", 0), TW_TRAIN_IMAGES, seed=1,
                    split="train_real")
    _workflow_scene(work / "ycbv", torch.device("cuda", 0), 1, seed=0, split="test")
    (work / "ycbv" / "image_lists" / "val.txt").write_text(f"{WF_SEQ:06d}/rgb/000000.png")
    cfg_path = _train_workflow_config(work, root, "scflow.py")
    common = [str(cfg_path), "--max-iters", str(PAR_TRAIN_ITERS), "--cfg-options", TW_FAST,
              "log_config.interval=1", "evaluation.interval=1000", "optimizer.type=SGD",
              "optimizer.weight_decay=0"]
    wait = _torchrun(root, 1, ["train", *common, "--work-dir", str(work / "nccl"),
                               "--launcher", "pytorch"], "(a)")
    return lambda: _par_train_recipe_check(smi, work, common, wait)


def _par_train_recipe_check(smi, work: Path, common, wait) -> None:
    from scflow_tpu_torch import cli
    from scflow_tpu_torch.runtime.checkpoint import read_checkpoint
    from scflow_tpu_torch.runtime.runner import Hook

    class Init(Hook):  # the weights before the first step, and which are parameters
        def before_run(self, runner):
            self.state = {k: v.detach().cpu().clone()
                          for k, v in runner.state.model.state_dict().items()}
            self.params = {k for k, _ in runner.state.model.named_parameters()}

    init = Init()
    t0 = time.perf_counter()
    try:
        cli.train_main(common + ["--work-dir", str(work / "none")], extra_hooks=[init])
        none_s = time.perf_counter() - t0
    finally:
        log, nccl_s = wait()
    require("backend nccl" in log and "1 devices / 1 processes, global batch 16 (local 16)"
            in log, "(a): one rank over NCCL at the config's batch")
    logged = {}
    for tag in ("none", "nccl"):
        _, lines = _log_lines(work / tag)
        logged[tag] = [float(ln.split("loss: ")[1].split(",")[0]) for ln in lines
                       if "Iter [" in ln and "loss: " in ln]
    # the log prints 4 decimals; two processes' cuDNN and atomics may differ in
    # the last bits (seen: 69.1402 against 69.1401 at step 3)
    require(len(logged["none"]) == PAR_TRAIN_ITERS and all(
        abs(a - b) <= 1e-4 + PAR_RTOL * abs(b) for a, b in zip(logged["nccl"], logged["none"])),
            f"(a) logged losses {logged}")
    a = read_checkpoint(str(work / "none" / "checkpoints" / f"iter_{PAR_TRAIN_ITERS}.pth"))
    b = read_checkpoint(str(work / "nccl" / "checkpoints" / f"iter_{PAR_TRAIN_ITERS}.pth"))
    a, b = a["state_dict"], b["state_dict"]
    # the model's own keys: the files list a shared encoder twice
    keys = [k for k, v in init.state.items() if v.is_floating_point()]
    d = max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)
    # SGD moves the weights linearly in the gradients: the runs' distance
    # over the distance the steps moved them, for the parameters and for
    # BatchNorm's buffers apart; another batch or another init gives ~1
    share = {}
    for part, names in (("parameters", [k for k in keys if k in init.params]),
                        ("buffers", [k for k in keys if k not in init.params])):
        apart = math.sqrt(sum(float(((a[k].double() - b[k].double()) ** 2).sum())
                              for k in names))
        moved = math.sqrt(sum(float(((a[k].double() - init.state[k].double()) ** 2).sum())
                              for k in names))
        share[part] = apart / moved
    require(all(v <= PAR_A_SHARE for v in share.values()),
            f"(a) final weights apart by {share} of their steps, over {PAR_A_SHARE}")
    emit({"phase": "parallel_train_nccl", "steps": PAR_TRAIN_ITERS, "optimizer": "SGD",
          "losses": logged["nccl"], "weights_max_abs_diff": d,
          "weights_apart_share_of_steps": share, "bound": PAR_A_SHARE,
          "seconds_none": none_s, "seconds_torchrun": nccl_s, "overlapped": True,
          "card": smi})


def _share_diff(got, want):
    """(the largest per-leaf |got - want| as a share of want's global norm,
    its leaf): the gradients' distance, scale-free."""
    gn = math.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    return max((float((got[k].double() - w.double()).norm()) / gn, k) for k, w in want.items())


def _step_grads(state):
    return {n: p.grad.detach().cpu().clone() for n, p in state.model.named_parameters()}


def _par_ranks(root: Path, work: Path, weights, batch, tag: str, plant: bool = False):
    """Start (b)'s 2 rank processes (parallel_rank) on weights and the global
    batch; returns wait() -> the ranks' outputs, which fails the phase if a
    rank fails."""
    spec = work / f"{tag}.pt"
    torch.save(dict(weights=weights, batch=batch, out=str(work / tag), plant=plant), spec)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--root", str(root),
                               "--parallel-rank", str(spec)], cwd=str(root),
                              env=_job_env(root, RANK=r, WORLD_SIZE=2, LOCAL_RANK=r,
                                           LOCAL_WORLD_SIZE=2, MASTER_ADDR="127.0.0.1",
                                           MASTER_PORT=port),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]

    def wait():
        outs = [p.communicate(timeout=PAR_START_S)[0] for p in procs]
        for p, out in zip(procs, outs):
            require(p.returncode == 0, f"(b) {tag} rank exited {p.returncode}: {out[-3000:]}")
        return [torch.load(f"{work / tag}.rank{r}", weights_only=False) for r in range(2)]

    return wait


def _par_train_step(smi, root: Path, work: Path) -> None:
    """(b): 2 ranks sharing cuda:0 over gloo at the shipped recipe (batch 16
    per rank) against one process at batch 32, one step, held within the
    step's own rounding floor on the card: the same process's step with
    BatchNorm's statistics summed in float64 (the ranks' path) instead of
    float32 means, the same function rounded otherwise.  The floor itself
    must stay under PAR_FLOOR_MAX of the gradients' norm, so a fault in the
    float64 path cannot widen its own bound; and a pair of ranks that keep
    their own BatchNorm statistics must miss the bound, which shows that it
    separates.  Then, with the ranks done, one process's step in turns
    with and without the float64 sums: their cost."""
    from scflow_tpu_torch.models import layers
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    model = train_model(IMG, ITERS)
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state, step, assets, _ = _train_setup(model, bank, IMG, lr_cfg=None, optimizer=PAR_OPT,
                                          render_augmentations=PAR_AUGMENT, augment_seed=3)
    batch = train_batch(assets, 2 * TRAIN_BATCH, IMG)
    wait = _par_ranks(root, work, weights, batch, "rank")
    model64 = train_model(IMG, ITERS)
    model64.load_state_dict(weights)
    state64, step64, _, _ = _train_setup(model64, bank, IMG, lr_cfg=None, optimizer=PAR_OPT,
                                         render_augmentations=PAR_AUGMENT, augment_seed=3)

    def with_f64_sums(fn):  # BatchNorm's rank path (float64 sums) in this one process
        single_path = layers.batch_world
        layers.batch_world = lambda: 2
        try:
            return fn()
        finally:
            layers.batch_world = single_path

    try:
        state, log = step(state, batch)
        one = {k: float(v) for k, v in log.items()}
        one_grads, one_state = _step_grads(state), {
            k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        state64, log64 = with_f64_sums(lambda: step64(state64, batch))
        floor_logs = {k: abs(float(v) - one[k]) for k, v in log64.items()}
        grads64 = _step_grads(state64)
        floor_grads = _share_diff(grads64, one_grads)
    finally:
        ranks = wait()
    planted = _par_ranks(root, work, weights, batch, "planted", plant=True)()

    def against_one(r):
        """(worst log over its allowance, worst weight over the tolerance,
        gradients' share diff): each within 1 (the gradients within
        PAR_FLOOR x the floor) passes."""
        worst_logs, worst_state = (0.0, None), (0.0, None)
        for k, v in one.items():
            allowed = max(PAR_ATOL + PAR_RTOL * abs(v), PAR_FLOOR * floor_logs[k])
            ratio = abs(r["logs"][k] - v) / allowed
            if ratio > worst_logs[0]:
                worst_logs = (ratio, f"{k}: {r['logs'][k]} vs {v}, floor {floor_logs[k]}")
        for k, v in one_state.items():
            if v.is_floating_point():
                ratio = float(((r["state"][k] - v).abs() / (PAR_ATOL + PAR_RTOL * v.abs())).max())
                if ratio > worst_state[0]:
                    worst_state = (ratio, k)
        return worst_logs, worst_state, _share_diff(r["grads"], one_grads)

    def passes(res):
        return res[0][0] <= 1 and res[1][0] <= 1 and res[2][0] <= PAR_FLOOR * floor_grads[0]

    for r in ranks:
        require(r["backend"] == "gloo" and r["device"] == "cuda:0", f"(b) {r['backend']} "
                f"on {r['device']}")
        for c in r["counts"]:
            require(only(c, K1=ITERS, K1b=ITERS, K2=1), f"(b) rank {r['rank']} launches {c}")
    results = [against_one(r) for r in ranks]
    planted_res = against_one(planted[0])
    # the ranks' step and this process's, with and without the float64 sums,
    # in turns on the card the ranks have left
    times = {"float32_means": [], "float64_sums": []}
    for _ in range(2):
        for tag, run in (("float32_means", lambda: step(state, batch)),
                         ("float64_sums", lambda: with_f64_sums(lambda: step64(state64, batch)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PAR_TIMED):
                run()
            torch.cuda.synchronize()
            times[tag].append(1e3 * (time.perf_counter() - t0) / PAR_TIMED)
    del state64, model64
    one_ms, f64_ms = min(times["float32_means"]), min(times["float64_sums"])
    emit({"phase": "parallel_train_gloo", "ranks": 2, "local_batch": TRAIN_BATCH,
          "global_batch": 2 * TRAIN_BATCH, "launches_per_step_per_rank":
          {"K1": ITERS, "K1b": ITERS, "K2": 1}, "loss": one["loss"],
          "loss_ranks": [r["logs"]["loss"] for r in ranks], "grad_norm": one["grad_norm"],
          "grad_norm_ranks": [r["logs"]["grad_norm"] for r in ranks],
          "floor_loss": floor_logs["loss"], "floor_grad_norm": floor_logs["grad_norm"],
          "logs_worst_over_allowed": results[0][0],
          "weights_worst_over_tolerance": max((r[1] for r in results), key=lambda t: t[0]),
          "grads_share_diff": [r[2] for r in results], "grads_floor_share_diff": floor_grads,
          "grads_share_diff_from_float64_sums": _share_diff(ranks[0]["grads"], grads64),
          "planted_rank_bn": {"logs_worst_over_allowed": planted_res[0],
                              "weights_worst_over_tolerance": planted_res[1],
                              "grads_share_diff": planted_res[2],
                              "grads_share_diff_from_float64_sums":
                              _share_diff(planted[0]["grads"], grads64)},
          "floor_factor": PAR_FLOOR, "floor_max": PAR_FLOOR_MAX, "rtol": PAR_RTOL,
          "atol": PAR_ATOL, "ms_per_step_per_rank": [r["ms_per_step"] for r in ranks],
          "ms_per_step_one_process_batch_32": one_ms,
          "ms_per_step_one_process_batch_32_float64_bn_sums": f64_ms,
          "float64_bn_sums_ms": f64_ms - one_ms, "timed_in_turns_ms": times,
          "allreduce_ms": [r["allreduce_ms"] for r in ranks], "grad_mb": ranks[0]["grad_mb"],
          "card": smi})
    require(floor_grads[0] <= PAR_FLOOR_MAX, f"(b) the float64 sums path moves the gradients "
            f"by {floor_grads} of their norm, over {PAR_FLOOR_MAX}")
    require(all(passes(r) for r in results), f"(b) against one process: {results} "
            f"(floor {floor_grads})")
    require(not passes(planted_res), f"(b) ranks with their own BatchNorm statistics pass "
            f"the gate: {planted_res} (floor {floor_grads})")
    return ranks[0]["counts"][0]


def _par_test(smi, root: Path, work: Path):
    """(c): cli test --launcher pytorch at 2 ranks (sharing the card, gloo),
    started in the background, against the single-process run in this
    process on PAR_TEST_IMAGES images of phase 18's set.  Returns the part
    that runs the single process, waits for the job and compares."""
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.checkpoint import save_params

    _workflow_scene(work / "ycbv", torch.device("cuda", 0), PAR_TEST_IMAGES)
    cfg_path = _workflow_config(work, root, "scflow.py")
    model = build_refiner_from_config(Config.fromfile(str(cfg_path)).model)
    model.load_state_dict(seeded_model().state_dict())
    ckpt = work / "scflow.pth"
    save_params(str(ckpt), model)
    base = [str(cfg_path), "--checkpoint", str(ckpt), "--format-only"]
    wait = _torchrun(root, 2, ["test", *base, "--launcher", "pytorch", "--out",
                               str(work / "two.json"), "--save-dir", str(work / "bop_two")], "(c)")
    return lambda: _par_test_check(smi, work, base, wait)


def _par_test_check(smi, work: Path, base, wait) -> None:
    from scflow_tpu_torch import cli

    try:
        cli.test_main(base + ["--out", str(work / "one.json"),
                              "--save-dir", str(work / "bop_one")])
    finally:
        log, two_s = wait()
    require("backend gloo (2 local ranks share 1 card(s)" in log, "(c) gloo on the shared card")
    one, two = _results_of(work / "one.json"), _results_of(work / "two.json")
    require(len(one) == len(two) == PAR_TEST_IMAGES and all(
        np.array_equal(a[0], b[0]) for a, b in zip(one, two)), "(c) every image, in order")
    d_rot = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(one, two))
    d_t = max(float(np.abs(a[2] - b[2]).max()) for a, b in zip(one, two))
    for a, b in zip(one, two):
        _slice_bounds(b[1], b[2], a[1], a[2], "(c) 2 ranks vs one process")
    _bop_matches_out(work / "bop_two", work / "two.json", PAR_TEST_IMAGES)
    emit({"phase": "parallel_test", "ranks": 2, "images": PAR_TEST_IMAGES,
          "rot_max_abs_diff": d_rot, "t_max_abs_diff_mm": d_t, "seconds_torchrun": two_s,
          "overlapped": True, "card": smi})


def _par_serve(smi) -> dict:
    """(d): PoseService over Mesh(['cuda:0', 'cuda:0']) at tools/serve_bench.py's
    64 objects against the one-device service."""
    from scflow_tpu_torch.parallel import Mesh, replicate
    from scflow_tpu_torch.refiners.system import RenderAssets
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank
    from scflow_tpu_torch.runtime.server import PoseService, RefineRequest
    from scflow_tpu_torch.serving import make_serving_fn

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    assets = RenderAssets.from_bank(bank)
    model = seeded_model().cuda().eval()
    mesh = Mesh(["cuda:0", "cuda:0"])
    fns = [make_serving_fn(m, assets, assets.verts, assets.vert_valid, image_size=IMG,
                           render_cull_backfaces=True, slim=True) for m in replicate(model, mesh)]
    inputs = serve_inputs()
    reqs = []
    for f in range(SERVE_FRAMES):
        sel = inputs["frame_idx"] == f
        reqs.append(RefineRequest(frame=inputs["frames"][f], rotations=inputs["ref_rotations"][sel],
                                  translations=inputs["ref_translations"][sel],
                                  k=inputs["K"][sel], labels=inputs["labels"][sel]))
    kw = dict(frame_hw=(FRAME_H, FRAME_W), num_class=NCLASS, max_frames=SERVE_FRAMES,
              max_objects=BATCH)
    one = PoseService(fns[0], **kw)
    two = PoseService(fns, mesh=mesh, **kw)
    one.warmup()
    two.warmup()
    want, c1 = counted(lambda: one.run(reqs))
    got, c2 = counted(lambda: two.run(reqs))
    require(only(c1, K1=ITERS, K2=1) and only(c2, K1=2 * ITERS, K2=2),
            f"(d) launches one device {c1}, mesh {c2}")
    R = lambda res: np.concatenate([r["rotations"] for r in res])  # noqa: E731
    T = lambda res: np.concatenate([r["translations"] for r in res])  # noqa: E731
    d_rot, t_excess = _slice_bounds(R(got), T(got), R(want), T(want), "(d) mesh vs one device")
    times = {}
    for tag, svc in (("one", one), ("mesh", two)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            svc.run(reqs)
        times[tag] = 1e3 * (time.perf_counter() - t0) / 3
    emit({"phase": "parallel_serve", "devices": [str(d) for d in mesh.devices],
          "objects": BATCH, "launches_per_shard": {"K1": ITERS, "K2": 1},
          "rot_max_abs_diff": float(np.abs(R(got) - R(want)).max()),
          "t_max_abs_diff_mm": float(np.abs(T(got) - T(want)).max()),
          "ms_per_call": times, "card": smi})
    return {k: v // 2 for k, v in c2.items()}


def phase_parallel(smi, root: Path) -> dict:
    """Phase 26: (a) the train workflow over torchrun at one rank (NCCL)
    against --launcher none; (b) the data-parallel shipped train step at 2
    ranks sharing the card (gloo) against one process at the global batch;
    (c) cli test --launcher pytorch at 2 ranks against one process; (d)
    PoseService over a mesh of the card twice against one device.
    build/parallel/ is removed afterwards.  Returns {run: launches per rank
    step or mesh shard}."""
    import shutil

    work = root / "build" / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    failed, pending = [], []

    def part(name, fn):
        try:  # every part runs, so one call shows every failure; any fails the phase
            return fn()
        except Exception as e:  # noqa: BLE001
            failed.append(f"({name}) {type(e).__name__}: {e}")
            print(f"phase 26 ({name}) failed: {e!r}", file=sys.stderr, flush=True)

    try:
        for name in "abc":
            (work / name).mkdir()
        # (a)'s and (c)'s jobs run in the background beside this process's
        # runs of the same work; then (d), and (b) last and alone, as it is timed
        for name, start in (("a", _par_train_recipe), ("c", _par_test)):
            check = part(name, lambda: start(smi, root, work / name))
            if check is not None:
                pending.append((name, check))
        for name, check in pending:
            part(name, check)
        launches = {"serve_mesh_shard": part("d", lambda: _par_serve(smi)),
                    "train_rank_step": part("b", lambda: _par_train_step(smi, root, work / "b"))}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    require(not failed, f"phase 26: {failed}")
    emit({"phase": "parallel", "seconds": time.perf_counter() - t0})
    return launches


# ---- learn: the learning check and the user tools (phase 27) ----

LEARN_STEPS = 100  # phase 27's learning check in the full run (lookup 'pallas')
# ADD/d after LEARN_STEPS steps must fall below init / LEARN_FACTOR: half the
# smallest factor at step 100 of the learn group's full-length runs on the H100
# (10.02 'pallas', 10.31 'xla'; phase 27's own run there 17.55; PERF.md §6)
LEARN_FACTOR = 5.0
# --phases learn: the tool's 2000 steps, evaluated every LEARN_STEPS (the tool:
# every 200), so that its curves give the factor at phase 27's step count
OVERFIT_STEPS, OVERFIT_EVERY = 2000, LEARN_STEPS
OVERFIT_LAUNCHES = {"pallas": {"K1": 4, "K1b": 4, "K2": 1}, "xla": {"K2": 1}}  # per step
OVERFIT_EVAL = {"K1": 4, "K2": 1}  # per evaluation (make_scflow_infer_fn, 4 iterations)
# cli bf16-parity's scale under --phases learn: the tool's defaults
PARITY = dict(num_images=125, num_class=8, ckpt_levels="1500,4500")
PARITY_S = 3000  # its subprocess's bound
SERVE_BENCH_ROUNDS = 20  # cli serve-bench's default


def _overfit(route: str, steps: int, every: int) -> dict:
    """overfit_check.run on the card (lookup `route`) with each step's
    launches counted: every step exactly OVERFIT_LAUNCHES[route] (after an
    evaluation, that evaluation's OVERFIT_EVAL too), nothing else; finite
    losses.  Returns run's result and 'launches_per_step'."""
    from scflow_tpu_torch.tools import overfit_check

    kernels = kernel_counters()
    per_step, wrong = OVERFIT_LAUNCHES[route], []

    def on_step(i, logs):
        got = {name: k.launches for name, k in kernels.items()}
        for k in kernels.values():
            k.launches = 0
        want = dict(per_step)
        if i and i % every == 0:  # the evaluation after the step before
            want = {n: want.get(n, 0) + OVERFIT_EVAL.get(n, 0) for n in {*want, *OVERFIT_EVAL}}
        if not only(got, **want):
            wrong.append((i, got))

    for k in kernels.values():
        k.launches = 0
    res = overfit_check.run(steps, every, route, device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    last = {name: k.launches for name, k in kernels.items()}
    require(not wrong, f"overfit ({route}): launches of step {wrong[:3]}, want {per_step}")
    require(steps % every or only(last, **OVERFIT_EVAL),
            f"overfit ({route}): the last evaluation launched {last}")
    require(bool(np.isfinite(res["losses"]).all()), f"overfit ({route}): non-finite loss")
    return {**res, "launches_per_step": per_step}


def phase_learn(smi) -> dict:
    """Phase 27 (the full run): LEARN_STEPS steps of the learning check on
    lookup 'pallas', then one evaluation; ADD/d must fall by LEARN_FACTOR."""
    res = _overfit("pallas", LEARN_STEPS, LEARN_STEPS)
    add = res["curve"][-1]["add"]
    require(add * LEARN_FACTOR < res["init"],
            f"learn: ADD/d {res['init']:.4f} -> {add:.4f} after {LEARN_STEPS} steps, "
            f"want a factor {LEARN_FACTOR}")
    emit({"phase": "learn", "route": "pallas", "steps": LEARN_STEPS, "init_add": res["init"],
          "add": add, "factor": res["init"] / add, "required_factor": LEARN_FACTOR,
          "loss_first": res["losses"][0], "loss_last": res["losses"][-1],
          "first_step_s": res["first_step_s"], "ms_per_step": res["ms_per_step"],
          "launches_per_step": res["launches_per_step"], "eval_launches": OVERFIT_EVAL,
          "card": smi})
    return {"overfit_step": res["launches_per_step"], "overfit_eval": OVERFIT_EVAL}


def _learn_config(work: Path, repo: Path) -> Path:
    """A config that _base_s the shipped configs/refine_models/scflow.py and
    moves only its paths: the renderer's and the pose loss's meshes (the
    slice's 21 uvsphere classes, written here) and the work_dir."""
    from scflow_tpu_torch.render.meshbank import make_synthetic_bank

    bank = make_synthetic_bank(NCLASS, kind="uvsphere", size=80.0)
    for sub in ("models_1024", "models_eval"):
        (work / sub).mkdir(parents=True)
        for c in range(NCLASS):
            _write_ply(work / sub / f"obj_{c + 1:06d}.ply", bank.verts[c][bank.vert_valid[c]],
                       bank.faces[c][bank.face_valid[c]], bank.colors[c][bank.vert_valid[c]])
    path = work / "learn_scflow.py"
    path.write_text(f'''_base_ = {str(repo / "configs" / "refine_models" / "scflow.py")!r}
model = dict(renderer=dict(mesh_dir={str(work / "models_1024")!r}),
             pose_loss_cfg=dict(loss_func_cfg=dict(mesh_path={str(work / "models_eval")!r})))
work_dir = {str(work / "work")!r}
''')
    return path


def _learn_cli(root: Path, args, log: Path, timeout: float):
    """`python -m scflow_tpu_torch.cli ARGS` from the checkout, its output to
    `log`: (exit code, seconds, the output's lines)."""
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "-m", "scflow_tpu_torch.cli", *args], cwd=root,
                            env=_job_env(root), stdout=f, stderr=subprocess.STDOUT,
                            timeout=timeout).returncode
    return rc, time.perf_counter() - t0, log.read_text().splitlines()


def _learn_overfit(smi, work: Path) -> None:
    """The tool's full run on both lookup routes; the 'pallas' run's
    weights saved (save_params) as the port's first trained checkpoint."""
    from scflow_tpu_torch.runtime.checkpoint import read_checkpoint, save_params

    for route in ("xla", "pallas"):
        res = _overfit(route, OVERFIT_STEPS, OVERFIT_EVERY)
        final = res["curve"][-1]["add"]
        at = [p["add"] for p in res["curve"] if p["step"] == LEARN_STEPS]
        line = {"phase": f"learn_overfit_{route}", "steps": OVERFIT_STEPS,
                "init_add": res["init"], "curve": res["curve"], "final_add": final,
                f"factor_at_{LEARN_STEPS}": res["init"] / at[0] if at else None,
                "below_0.01": final < 0.01, "first_step_s": res["first_step_s"],
                "ms_per_step": res["ms_per_step"],
                "launches_per_step": res["launches_per_step"], "eval_launches": OVERFIT_EVAL,
                "card": smi}
        if route == "pallas":
            ckpt = work / "overfit_pallas.pth"
            save_params(str(ckpt), res["model"], {"iter": OVERFIT_STEPS, "tool": "overfit"})
            line.update(checkpoint=str(ckpt), checkpoint_keys=len(
                read_checkpoint(str(ckpt))["state_dict"]), checkpoint_mb=ckpt.stat().st_size / 1e6)
        emit(line)
        require(final < res["init"], f"overfit ({route}): ADD/d {res['init']:.4f} -> {final:.4f}")


def _learn_parity(smi, root: Path, work: Path) -> None:
    """`cli bf16-parity` at PARITY's scale in its own process: its exit
    code is the part's (PROTOCOL FAIL exits 1)."""
    out = work / "parity"
    args = ["bf16-parity", "--root", str(out), "--num-images", str(PARITY["num_images"]),
            "--num-class", str(PARITY["num_class"]), "--ckpt-levels", PARITY["ckpt_levels"]]
    rc, seconds, lines = _learn_cli(root, args, work / "parity.log", PARITY_S)
    report = json.loads((out / "report.json").read_text()) if (out / "report.json").exists() else {}
    its = _its_per_s(_log_lines(out / "work")[1]) if any((out / "work").glob("*.log")) else []
    ckpts = {level: {k: entry[k] for k in ("passed", "max_table_delta", "worst_entry",
                                            "table_entries", "threshold_crossings", "poses",
                                            "divergence", "resolution_per_class_entry",
                                            "fp32_table", "bf16_table")}
             for level, entry in report.get("checkpoints", {}).items()}
    emit({"phase": "learn_bf16_parity", "rc": rc, "seconds": seconds, **PARITY,
          "tolerance": report.get("tolerance"), "passed": report.get("passed"),
          "checkpoints": ckpts, "train_its_per_s": its,
          "train_s_per_step": 1.0 / statistics.median(its[1:] or its) if its else None,
          "lines": [ln for ln in lines if ln.startswith(("[ckpt", "PROTOCOL"))], "card": smi})
    require(rc == 0, f"bf16-parity exited {rc}: {lines[-3:]}")


def _learn_serve_bench(smi) -> None:
    """`cli serve-bench` (its defaults: 64 objects from 4 640x480 frames,
    256^2, 8 iterations, 21 classes) in fp32 and bf16, in this process:
    8 K1 (K1_bf16) and 1 K2 per call, over the warm call and the rounds."""
    from scflow_tpu_torch import cli

    for dtype, k1 in (("fp32", "K1"), ("bf16", "K1_bf16")):
        res, counts = counted(lambda: cli.COMMANDS["serve-bench"](["--dtype", dtype]))
        calls = SERVE_BENCH_ROUNDS + 1
        emit({"phase": f"learn_serve_bench_{dtype}", **res, "calls": calls,
              "launches_per_call": {k: v / calls for k, v in counts.items() if v},
              "card": smi})
        require(only(counts, **{k1: ITERS * calls, "K2": calls}),
                f"serve-bench {dtype}: launches {counts} over {calls} calls")


def _learn_warmup(smi, root: Path, work: Path) -> None:
    """`cli warmup` on _learn_config's config in a fresh process: each
    first call's seconds."""
    cfg = _learn_config(work / "warmup", root)
    rc, seconds, lines = _learn_cli(root, ["warmup", str(cfg)], work / "warmup.log", 900)
    times = [ln for ln in lines if re.match(r"(kernels built|backend=|infer bucket|serving fn|"
                                            r"train step|cache warm)", ln)]
    emit({"phase": "learn_warmup", "rc": rc, "seconds": seconds, "lines": times, "card": smi})
    require(rc == 0 and lines and lines[-1] == "cache warm", f"warmup exited {rc}: {lines[-3:]}")


def phase_learn_tools(smi, root: Path) -> None:
    """The learn group (--phases learn only, outside the full run): the
    learning check at the tool's 2000 steps on both lookup routes, `cli
    bf16-parity` at PARITY's scale, `cli serve-bench` in fp32 and bf16 and
    `cli warmup`.  Every part runs; any failure fails the group.  Under
    build/learn/: the trained checkpoint, kept; the rest removed."""
    import shutil

    work = root / "build" / "learn"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    failed = []
    for name, fn in (("overfit", lambda: _learn_overfit(smi, work)),
                     ("serve-bench", lambda: _learn_serve_bench(smi)),
                     ("warmup", lambda: _learn_warmup(smi, root, work)),
                     ("bf16-parity", lambda: _learn_parity(smi, root, work))):
        try:  # every part runs, so one call shows every failure; any fails the group
            fn()
        except Exception as e:  # noqa: BLE001
            failed.append(f"({name}) {type(e).__name__}: {e}")
            print(f"learn ({name}) failed: {e!r}", file=sys.stderr, flush=True)
    for sub in ("parity", "warmup"):
        shutil.rmtree(work / sub, ignore_errors=True)
    require(not failed, f"learn: {failed}")
    emit({"phase": "learn_tools", "seconds": time.perf_counter() - t0})


# ---- tools: the user tools (cli keypoints, browse, visualize, mmflow-convert) ----

TOOLS_IMAGES, TOOLS_SAMPLES = 2, 2  # cli visualize's test images; cli browse's samples
TOOLS_VIS_LAUNCHES = {"K1": ITERS, "K2": 1}  # per visualized image: the SCFlow infer call
TOOLS_FRESH_S = 600  # each fresh process's bound (--phases tools)


def _tools_config(work: Path, repo: Path) -> Path:
    """A config that _base_s the shipped configs/refine_models/scflow.py and
    moves only its paths: data.train onto the synthetic train_real split
    (the shipped train pipeline, its PoseJitter included), data.test onto
    the synthetic test set, the renderer's meshes and the work_dir."""
    ycbv = repo / "configs" / "refine_datasets" / "ycbv_real.py"
    path = work / "tools_scflow.py"
    path.write_text(f'''_base_ = {str(repo / "configs" / "refine_models" / "scflow.py")!r}
_root = {str(work / "ycbv")!r}
_dataset = load_cfg_vars({str(ycbv)!r})
_meshes = _root + "/models_eval"
data = dict(
    train=dict(
        data_root=_root + "/train_real", gt_annots_root=_root + "/train_real",
        image_list=_root + "/image_lists/train_real.txt",
        keypoints_json=_root + "/keypoints/bbox.json", meshes_eval=_meshes,
        pipeline=[dict(t, mesh_dir=_meshes) if "mesh_dir" in t else t
                  for t in _dataset["train_pipeline"]]),
    test=dict(
        data_root=_root + "/test", ref_annots_root=_root + "/initial_poses",
        image_list=_root + "/image_lists/test.txt",
        keypoints_json=_root + "/keypoints/bbox.json", meshes_eval=_meshes,
        pipeline=[dict(t, mesh_dir=_meshes) if "mesh_dir" in t else t
                  for t in _dataset["test_pipeline"]]))
model = dict(renderer=dict(mesh_dir=_root + "/models_1024"))
work_dir = _root + "/work"
del _dataset
''')
    return path


def _mmflow_source(raft_cfg: Path, path: Path):
    """A RAFT model of the shipped raft.py with PyTorch's initialisation
    from seed 7, and its state dict in mmflow's layout ('encoder.*',
    'cxt_encoder.*', the decoder's keys as they are) saved to `path`."""
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.refiners.build import build_refiner_from_config

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        source = build_refiner_from_config(Config.fromfile(str(raft_cfg)).model)
    mmflow = {}
    for k, v in source.state_dict().items():
        if k.startswith("render_encoder."):
            k = "encoder." + k[len("render_encoder."):]
        elif k.startswith("context."):
            k = "cxt_encoder." + k[len("context."):]
        mmflow[k] = v
    torch.save({"state_dict": mmflow}, str(path))
    return source, mmflow


def _tools_visualize(cli, args):
    """`cli visualize ARGS` with each image's launches: every count is read
    and set to 0 as each image's batch is padded (eval_loop.pad_batch),
    so the counts cover one image's infer call, silhouette render and
    drawing.  Returns (its result, [counts per image], counts before the
    first image)."""
    from scflow_tpu_torch.runtime import eval_loop

    kernels = kernel_counters()
    reads, pad = [], eval_loop.pad_batch

    def read():
        torch.cuda.synchronize()
        reads.append({name: k.launches for name, k in kernels.items()})
        for k in kernels.values():
            k.launches = 0

    def probe(batch, size):
        read()
        return pad(batch, size)

    for k in kernels.values():
        k.launches = 0
    eval_loop.pad_batch = probe
    try:
        res = cli.COMMANDS["visualize"](args)
    finally:
        eval_loop.pad_batch = pad
    read()
    return res, reads[1:], reads[0]


def _tools_run(smi, root: Path, work: Path) -> dict:
    """Phase 28 in this process on the workflow phase's synthetic set (see
    the docstring); emits its line and returns each image's launches."""
    from scflow_tpu_torch import cli
    from scflow_tpu_torch.config import Config
    from scflow_tpu_torch.datasets.pipelines.imops import imread
    from scflow_tpu_torch.refiners.build import build_refiner_from_config
    from scflow_tpu_torch.runtime.checkpoint import load_params, save_params

    t_phase = t0 = time.perf_counter()
    ycbv = work / "ycbv"
    info = _workflow_scene(ycbv, torch.device("cuda", 0), images=TOOLS_IMAGES)
    _workflow_scene(ycbv, torch.device("cuda", 0), images=TOOLS_SAMPLES, seed=1,
                    split="train_real")
    cfg_path = _tools_config(work, root)
    model = build_refiner_from_config(Config.fromfile(str(cfg_path)).model)
    model.load_state_dict(seeded_model().state_dict())
    save_params(str(work / "scflow.pth"), model)
    line = {"phase": "tools", "setup_s": time.perf_counter() - t0}

    kp_s = {}
    for mode in ("bbox", "obb", "fps"):
        t0 = time.perf_counter()
        kps = cli.COMMANDS["keypoints"]([str(ycbv / "models_eval"), "--out",
                                         str(work / f"kp_{mode}.json"), "--mode", mode])
        kp_s[mode] = time.perf_counter() - t0
        require(np.shape(kps) == (NCLASS, 8, 3) and np.isfinite(kps).all(),
                f"keypoints {mode}: shape {np.shape(kps)}")
        if mode == "bbox":  # the set's own box corners (written from the meshes' float32)
            want = json.loads((ycbv / "keypoints" / "bbox.json").read_text())
            require(np.allclose(kps, want, atol=1e-3), "keypoints bbox: the set's box corners")
    line["keypoints_s"] = kp_s

    for tag, extra in (("browse", []), ("browse_skip_pose_jitter", ["--skip-types", "PoseJitter"])):
        t0 = time.perf_counter()
        paths = cli.COMMANDS["browse"]([str(cfg_path), "--num", str(TOOLS_SAMPLES), "--out-dir",
                                        str(work / tag)] + extra)
        line[f"{tag}_ms_per_sample"] = 1e3 * (time.perf_counter() - t0) / TOOLS_SAMPLES
        line[f"{tag}_files"] = len(paths)
        require(len(paths) >= TOOLS_SAMPLES and all(imread(p).shape == (IMG, IMG, 3)
                                                    for p in paths), f"{tag}: {paths}")

    res, per_image, before = _tools_visualize(
        cli, [str(cfg_path), "--checkpoint", str(work / "scflow.pth"), "--num",
              str(TOOLS_IMAGES), "--out-dir", str(work / "vis")])
    objects = sum(len(labels) for labels, _, _ in info["gt"][:TOOLS_IMAGES])
    require(only(before), f"visualize: launches before the first image {before}")
    require(len(per_image) == TOOLS_IMAGES and all(only(c, **TOOLS_VIS_LAUNCHES)
                                                   for c in per_image),
            f"visualize: launches per image {per_image}, want {TOOLS_VIS_LAUNCHES}")
    require(all(np.isfinite(R).all() and np.isfinite(t).all() for R, t in res["poses"]),
            "visualize: non-finite poses")
    require(len(res["paths"]) == objects and all(
        imread(p).shape == (IMG, 2 * IMG, 3) for p in res["paths"]),
        f"visualize: {len(res['paths'])} panels for {objects} objects")
    line.update(visualize_images=res["images"], visualize_panels=len(res["paths"]),
                visualize_s_per_image={k: v / res["images"] for k, v in res["seconds"].items()},
                visualize_launches_per_image=per_image)

    raft_cfg = root / "configs" / "refine_models" / "raft.py"
    source, mmflow = _mmflow_source(raft_cfg, work / "mmflow_raft.pth")
    t0 = time.perf_counter()
    keys = cli.COMMANDS["mmflow-convert"]([str(work / "mmflow_raft.pth"), "--config",
                                           str(raft_cfg), "--out", str(work / "raft_params.pth"),
                                           "--save-torch", str(work / "raft_dup.pth"),
                                           "--strict"])
    line["mmflow_convert_s"] = time.perf_counter() - t0
    loaded = build_refiner_from_config(Config.fromfile(str(raft_cfg)).model)
    load_params(str(work / "raft_params.pth"), loaded)
    require(not keys["missing"] and all(torch.equal(loaded.state_dict()[k], v)
                                        for k, v in source.state_dict().items()),
            f"mmflow-convert: the params differ from the source's ({keys['missing'][:3]})")
    dup = torch.load(str(work / "raft_dup.pth"), map_location="cpu",
                     weights_only=True)["state_dict"]
    require({k for k in dup if k.startswith("real_encoder.")} and
            len(dup) == len(mmflow) + sum(k.startswith("encoder.") for k in mmflow),
            "mmflow-convert: the duplicated keys")
    del mmflow["cxt_encoder.res_layer2.0.conv1.weight"]
    torch.save({"state_dict": mmflow}, str(work / "mmflow_bad.pth"))
    try:
        cli.COMMANDS["mmflow-convert"]([str(work / "mmflow_bad.pth"), "--config", str(raft_cfg),
                                        "--out", str(work / "bad.pth"), "--strict"])
        named = False
    except ValueError as e:
        named = "cxt_encoder.res_layer2.0.conv1.weight" in str(e)
    require(named, "mmflow-convert --strict: the removed key is not named")
    emit({**line, "seconds": time.perf_counter() - t_phase, "card": smi})
    return {"visualize": per_image[0]}


def _tools_fresh(smi, root: Path, work: Path) -> None:
    """Each of the four commands once as `python -m scflow_tpu_torch.cli`
    in a fresh process on the card, on phase 28's files: exit code 0 and
    its outputs, with the process's seconds."""
    from scflow_tpu_torch.datasets.pipelines.imops import imread

    cfg, raft_cfg = work / "tools_scflow.py", root / "configs" / "refine_models" / "raft.py"
    runs = {
        "keypoints": ["keypoints", str(work / "ycbv" / "models_eval"), "--out",
                      str(work / "fresh_kp.json"), "--mode", "fps"],
        "browse": ["browse", str(cfg), "--num", str(TOOLS_SAMPLES), "--out-dir",
                   str(work / "fresh_browse"), "--skip-types", "PoseJitter"],
        "visualize": ["visualize", str(cfg), "--checkpoint", str(work / "scflow.pth"), "--num",
                      str(TOOLS_IMAGES), "--out-dir", str(work / "fresh_vis")],
        "mmflow-convert": ["mmflow-convert", str(work / "mmflow_raft.pth"), "--config",
                           str(raft_cfg), "--out", str(work / "fresh_params.pth"), "--strict"]}
    line, failed = {"phase": "tools_fresh"}, []
    for name, args in runs.items():
        rc, seconds, lines = _learn_cli(root, args, work / f"fresh_{name}.log", TOOLS_FRESH_S)
        line[name] = {"rc": rc, "seconds": seconds, "last_line": lines[-1] if lines else ""}
        pngs = [ln for ln in lines if ln.endswith(".png")]
        ok = rc == 0 and {
            "keypoints": lambda: len(json.loads((work / "fresh_kp.json").read_text())) == NCLASS,
            "browse": lambda: bool(pngs) and all(imread(p).shape == (IMG, IMG, 3) for p in pngs),
            "visualize": lambda: bool(pngs) and all(imread(p).shape == (IMG, 2 * IMG, 3)
                                                    for p in pngs),
            "mmflow-convert": lambda: (work / "fresh_params.pth").exists()}[name]()
        if not ok:
            failed.append(f"{name}: rc {rc}, {lines[-3:]}")
    emit({**line, "card": smi})
    require(not failed, f"tools_fresh: {failed}")


def phase_tools(smi, root: Path, fresh: bool = False) -> dict:
    """Phase 28 (the full run; with fresh=True, the tools group: then also
    each command in a fresh process) under build/tools/, removed
    afterwards."""
    import shutil

    work = root / "build" / "tools"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        launches = _tools_run(smi, root, work)
        if fresh:
            _tools_fresh(smi, root, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


PHASE_GROUPS = ("lookup", "raster", "slice", "raft", "options", "workflow",
                "train_workflow", "train_pbr", "serve", "train_augment", "export", "parallel",
                "learn", "tools")


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
        elif group == "train_pbr":
            phase_train_pbr(smi, root)
        elif group == "serve":
            serve_phases(smi, root)
        elif group == "train_augment":
            phase_train_augment(smi, root)
        elif group == "export":
            phase_export(smi, root)
        elif group == "parallel":
            phase_parallel(smi, root)
        elif group == "learn":
            phase_learn_tools(smi, root)
        elif group == "tools":
            phase_tools(smi, root, fresh=True)
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
    parser.add_argument("--export-loader", type=Path, default=None, metavar="SPEC",
                        help=argparse.SUPPRESS)  # phase 25's loading process
    parser.add_argument("--parallel-rank", type=Path, default=None, metavar="SPEC",
                        help=argparse.SUPPRESS)  # a rank of phase 26 (b)
    args = parser.parse_args()
    if args.phases is not None and not set(args.phases) <= set(PHASE_GROUPS):
        parser.error(f"unknown phase groups in {args.phases}; expected {PHASE_GROUPS}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import scflow_tpu_torch  # noqa: F401  (fails at once outside the repo)
    if args.export_loader is not None:
        print(json.dumps(export_loader(args.export_loader)), flush=True)
        return 0
    if args.parallel_rank is not None:
        print(json.dumps(parallel_rank(args.parallel_rank)), flush=True)
        return 0
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
    # launches per step of the PBR recipe's train_main run
    tw_launches.update(phase_train_pbr(smi, args.root.resolve()))
    # launches per call of each serving run, per step of the augmented steps
    serve_launches = serve_phases(smi, args.root.resolve())
    serve_launches.update(phase_train_augment(smi, args.root.resolve()))
    # launches per call of each loaded artifact (phase 25)
    export_launches = phase_export(smi, args.root.resolve())
    # launches per rank step and per mesh shard (phase 26)
    parallel_launches = phase_parallel(smi, args.root.resolve())
    # launches per step and per evaluation of the learning check (phase 27)
    learn_launches = phase_learn(smi)
    # launches per visualized image of the user tools (phase 28)
    tools_launches = phase_tools(smi, args.root.resolve())
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

    def serving(key):
        """The key's launches per call of each serving run (serve, serve_bf16,
        serve_http_run, serve_raft_host, serve_raft_device) and per step of
        the augmented train steps (train_augment, train_augment_cli)."""
        got = {run: n[key] for run, n in serve_launches.items() if n.get(key)}
        return {"serve_launches": got} if got else {}

    def parallel(key):
        """The key's launches per step of each rank of phase 26 (b) and per
        shard of its mesh service (d)."""
        got = {run: n[key] for run, n in parallel_launches.items() if n.get(key)}
        return {"parallel_launches": got} if got else {}

    def learn(key):
        """The key's launches per step (overfit_step) and per evaluation
        (overfit_eval) of phase 27's learning check."""
        got = {run: n[key] for run, n in learn_launches.items() if n.get(key)}
        return {"learn_launches": got} if got else {}

    def tools(key):
        """The key's launches per image of phase 28's cli visualize."""
        got = {run: n[key] for run, n in tools_launches.items() if n.get(key)}
        return {"tools_launches": got} if got else {}

    def exported(key):
        """The key's launches per call of each loaded artifact (export,
        export_bf16, export_raft)."""
        got = {run: n[key] for run, n in export_launches.items() if n.get(key)}
        return {"export_launches": got} if got else {}

    emit({"kernels": [
        {"name": f"{key} {fn}", "route": "cuda", "source": src + file, "replaces": tpu + where,
         "launches": launches[key], **({"raft_launches": raft_launches[key]}
                                       if key in raft_launches else {}), **res[key],
         **radius_3(key), **workflow(key), **serving(key), **exported(key), **parallel(key),
         **learn(key), **tools(key)}
        for key, fn, file, where in table], "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
