#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch's CUDA
   version and ``nvcc --version``;
2. build: the K1 and K2 kernels from ``squeezedet_torch/csrc``, one nvcc
   each, started together; ptxas' register and shared-memory reports;
   the tensor-core instructions (HMMA) in each kernel's SASS, by
   ``cuobjdump -sass``: the bf16 (tensor-core) kernels must have some;
3. K1 against its plain PyTorch version on the card, at the flagship
   shape (B=8, 384x1248) in f32 and bf16 and at an odd shape, then
   timed with CUDA events at B=128 bf16 beside its plain version and the
   unfused cuDNN layers;
4. K2 against its plain version on the card in f32 (TF32 off) and bf16,
   at every conv shape the train step routes to it (B=20, 1248x384) and
   at five odd shapes (B=2); two launches must be bitwise equal; K2, its
   plain version and cuDNN's weight gradient timed at the train shapes
   (B=20), and K2 and cuDNN at B=128;
5. serving path: uint8 -> detections at 1248x384 with seeded random
   weights: f32 at B=2 against the same weights on the CPU, then bf16 at
   B=128 for throughput; then the HTTP server at --max_batch 8:
   /healthz, then 16 concurrent single-frame requests;
6. train path: ``make_train_step_device`` at 1248x384: one f32 B=2 step
   on the card against the same step on the CPU (equal matcher targets;
   loss, params and momentum within tolerance); one f32 B=20 step in each
   filter-grad mode (K2 on against cuDNN's weight gradient, and 12 / 10 /
   0 K2 launches per backward); then a bf16 training run with dropout
   and the on-device augment at B=20 and B=128 in each mode (a smoke
   reading of ms/step, not a benchmark), whose loss must fall;
7. train loop: ``squeezedet_torch.train.main``, the train CLI, on a
   fixture of 48 KITTI-shaped 1242x375 PNGs written by ``data/synth.py``
   (libpng's adaptive row filters): B=20 at 1248x384 in bf16 with
   ``--device_assign --uint8_ingest --device_augment --pallas_grads``, 30
   steps with a checkpoint every 10 (two kept), then a resume to step 40,
   then 10 ``--device_dataset`` steps in a fresh directory.  Checked: the
   retained checkpoints and sampler files, that the resume starts at step
   30 and draws the batches of a straight run's steps 30-39, that the
   logged loss is finite and falls, and that K1 launches once per
   forward and K2 10 times per step.  Prints ms/step, img/s and peak
   memory (smoke readings, not a benchmark), the host's decode time per
   frame (by the data layer's decoder and by ``data/png.py``) and whether
   the summary writer was enabled.  ``python -m
   squeezedet_torch.profile_train_loop`` breaks the loop's host time down;
8. eval and demo: one port checkpoint of seeded weights (the head
   rescaled as in phase 5) and 24 KITTI-shaped 1242x375 PNGs with 5-8
   boxes each.  The ground truth scored as detections gives AP 1.0 with
   the native C++ evaluator, which must be the scorer that ran, and the
   C++ and Python scorers agree on jittered GT and on the model's
   detections.  ``squeezedet_torch.eval.main --run_once`` at 1248x384 in
   three modes: f32 B=1 with the host postprocess (the reference
   protocol), f32 B=8 with the device postprocess, which must give the
   same detections and APs, and bf16 B=8 ``--device_dataset``, which
   must score every image with finite APs; the f32 B=1 run's first two
   raw forwards match the CPU's.  Then ``squeezedet_torch.demo.main`` in
   image mode on 4 frames and in video mode on 6 MJPG frames of
   1920x1080 (cropped to 375x1242).  K1 launches once per eval batch and
   demo frame, K2 never.  Prints each eval mode's time per image and
   mAP, and the demo's per-frame times; then, with launches no longer
   counted, K1 timed at the eval and demo shapes and the f32 B=1 eval
   forward's host time against its device time;
9. the other backbones, squeezeDet+ (B=20), VGG16 (B=5) and ResNet50
   (B=20) at 1242x375 with seeded weights.  First, not counted: K2
   against its plain version in f32 and bf16 at every conv shape their
   train steps route to it (two launches bitwise equal), then timed in
   bf16 beside cuDNN's weight gradient and the bound.  Then, per net:
   uint8 -> detections in f32 on the card against the CPU (B=2; VGG16
   B=1) and a bf16 reading at the config batch; one f32 B=2 train step
   on the card against the CPU in filter-grad mode True, and one f32 B=4
   step per mode (K2 launches per backward 20 / 10 / 1 in True, 0 in
   "1x1"); the train CLI (10 bf16 steps at the config batch,
   ``--device_assign --uint8_ingest --device_augment --pallas_grads``,
   on 24 fixture frames: finite logged loss, a checkpoint), the eval CLI
   on that checkpoint (every image scored, finite APs) and, for
   squeezeDet+, the demo.  K1 must launch 0 times (it is squeezeDet's
   front end only) and K2 as many times as the steps need;
10. int8 and the exported artifact, on phase 8's checkpoint and fixture.
   squeezeDet at 1248x384 calibrated on the card on 2 uint8 batches
   (B=2): the int8 detector built from those scales on the CPU holds the
   same tree, and its int8 activation tape and raw preds at B=2 equal the
   card's bit for bit; the int8 uint8 -> detections program timed at
   B=128 beside bf16, with its peak memory; a hybrid int8 forward (start
   fire2) launches K1 once; squeezeDet+, VGG16 and ResNet50 at 1242x375
   in int8 at B=2, card against CPU (ResNet50's float conv1 within the
   f32 tolerance, its int8 blocks, fed the card's conv1, exactly);
   ``squeezedet_torch.export.main`` at B=8, bf16
   and int8, on cuda: each reloaded artifact equals the direct program
   bit for bit, K1 launching once per bf16 artifact call and never in
   the whole-net int8 one; the server on the bf16 artifact
   (``--artifact``, ``--max_batch 8``, 16 concurrent requests); the eval
   CLI with ``--quantize int8 --run_once`` (every image scored, finite
   APs) and the demo with ``--quantize int8`` on 4 frames.  Then, not
   counted, each int8 conv of squeezeDet (im2col + ``torch._int_mm`` +
   epilogue) timed at B=128 beside the bf16 cuDNN conv of the same layer;
11. data parallelism on the one card (``squeezedet_torch.parallel``),
   squeezeDet at 1248x384 with phase 6's seeded weights: (a) the f32
   train step (TF32 off, dropout on) at global batch 4 on two gloo ranks
   sharing the card, each on 2 rows, and on one NCCL rank, against the
   one-process step from the same weights, generator and batch (loss
   terms within LOSS_RTOL, every parameter and momentum leaf within
   DP_STEP_TOL of its update's norm); (b) the train CLI with ``--num_devices
   2`` (two gloo ranks on the card) at global B=20 in bf16 with
   ``--device_assign --uint8_ingest --device_augment``: 10 steps and a
   checkpoint, then 10 sharded ``--device_dataset`` steps, then the same
   two ranks at ``--steps_per_dispatch 8`` (48 steps, each rank's K steps
   a chain of CUDA graphs split at its host all-reduces; ms/step beside
   the K=1 run's), then one NCCL
   rank (a torchrun environment) with ``--pallas_grads``: finite logged
   loss, one events file, one sampler file per rank, each rank's K1
   launches equal to its forwards and K2 0 (10 a step under
   ``--pallas_grads``), with each rank's ms/step, img/s and peak memory
   (smoke readings of ranks that share one card, not a scaling figure)
   and the profiler's all-reduce time per step; (c) eval's ``detect_all``
   over two replicas on the card, f32 B=8 and bf16 B=8
   ``--device_dataset``, against one replica's detections; (d) the server
   over two replicas (``--num_devices 2 --max_batch 8``, f32): 16
   concurrent frames get one replica's replies.  K1 launches once per
   replica per batch, and once per forward on every rank;
12. K steps per dispatch as one captured CUDA graph (``trainer.
   make_train_step_device_scan``): (a) K=4 steps at B=20 bf16, 1248x384,
   dropout on, ``--device_dataset``-style inputs, mode "1x1", over three
   dispatches (eager, capture and replay, replay) against the same steps
   run eagerly from the same weights and generator: loss terms, every
   parameter and momentum leaf (within DP_STEP_TOL of its update) and the
   generator's state; the K1 and K2 launches of the last dispatch counted
   by ``torch.profiler``'s kernel rows (K1 K times, K2 10K times) and by
   the port's counters, with each dispatch's ms and the device's idle
   share, eager against replayed; then the same dispatches over two gloo
   ranks sharing the card, each rank's K steps captured as a chain of
   graphs split at its host all-reduces, against its steps one at a
   time, bit for bit (K1 once a forward, K2 0); (b) the train CLI at B=20 bf16
   ``--device_dataset --pallas_grads``, ms/step at K=1 and at
   ``--steps_per_dispatch 8`` (eight dispatches and an odd tail), then a
   K=8 run with a checkpoint every 8 steps to step 21 (checkpoints at
   dispatch boundaries and the tail's steps) and its resume to step 37,
   which draws a straight run's batches; one NCCL rank (a launcher's
   environment) at K=4 with ``--pallas_grads``, its all-reduces captured;
   (c) ``--activation_summary`` at two histogram steps: the
   ``activations/`` and ``activation_summary/`` tags written and no K1
   launch in the tape's forwards; (d) the learning check: the recipe's
   fixture (256 + 75 frames at 1248x384, ``data/synth.make_synth_kitti``)
   and its large arm (B=128, ``--recipe_batch 128``, seed 0,
   ``--device_dataset``, K=8, 375 steps), then ``eval --run_once``: val
   mAP must reach LEARN_MIN_MAP.  K1 launches once per step, forward and
   eval batch, K2 ten times per backward, replays included;
13. spatial partitioning on the one card (``squeezedet_torch.models.
   halo``: height x width tiles with hand-written halo exchanges, the
   head gathered on the card; every tile shares ``cuda:0``, so nothing
   here is a scaling figure): (a) squeezeDet at 1248x384 with phase 6's
   weights (head rescaled as in phase 5), uint8 -> raw preds and ->
   detections at B=1 in f32 (TF32 off) over 2x1, 3x1, 4x1 and 2x2 tiles
   against the unsharded forward on the card (boxes rtol/atol 1e-4,
   probs rtol 1e-4 atol 1e-6, classes and NMS choices equal), K1 once per
   tile, halo copies made and no tile of the frame's height; bf16 over
   4x1 tiles within 2 bf16 ulps of the bf16 frame's raw preds;
   (b) squeezeDet+, VGG16 and ResNet50 at 1242x375 over 2x1 and 2x2 with
   phase 9's tolerances, K1 0; (c) whole-net int8 over
   ``spatial_factors(4, 384, 1248)`` tiles, raw preds and int8 tape bit
   for bit; (d) ``squeezedet_torch.eval.main --run_once
   --eval_batch_size 1 --num_devices 4`` in f32 and ``--quantize int8``
   on a fixture of 6 frames: "Evaluating spatially over 4 devices" and
   the detections and APs of ``--num_devices 1``; (e) the f32 step
   (dropout on) over (1, 2) tiles at B=2, the data x spatial step of two
   gloo ranks with 2 tiles each at global B=4, against the unsharded
   one-process step, and K=4 captured dispatches over the tiles against
   their eager steps (K1 once per tile a forward, K2 0), in one process
   and over two gloo ranks of 2 tiles each (a chain of graphs split at
   the host all-reduces, bit for bit); (f) K1 against
   its plain version on every tile window of the 2x1, 4x1 and 2x2 grids
   at 1248x384 in f32 and bf16 (phase 1's tolerances), then readings:
   B=1 forward ms at 1, 2 and 4 tiles in f32 and bf16, halo copies and
   bytes a forward, K1 at a tile's shape beside its bound;
14. the host paths, on 24 KITTI-shaped 1242x375 frames: (a) deterministic
   training (``trainer.deterministic``, the train loop's default): the
   train CLI at B=20, 1248x384, 4 steps straight against 2 steps and a
   resume to 4, in f32 and in bf16 with ``--pallas_grads``, at one and at
   two steps per dispatch: params and momentum equal bit for bit, K1
   once a forward, K2 ten times a ``--pallas_grads`` step; (b) the native
   loader (``native/dataloader``): the headers g++ finds and the build,
   a bf16 ``--native_loader --device_assign --pallas_grads`` train run of
   8 steps whose every batch the library loads (the Python decoder reads
   no frame), its batches against the Python reader's on the same frames
   (pixels within 5e-3, scales within 1e-6, GT equal), host ms a B=20
   batch for both, alone and with 4 readers, and the eval CLI at B=8 with
   and without ``--native_loader`` (K1 once a batch, im_read of each);
   (c) a caffe pickle of seeded weights through ``squeezedet-torch-import``
   into a port checkpoint, whose f32 B=2 forward on the card equals the
   in-memory weights' bit for bit.  Then, not counted, (d) the cost of
   deterministic mode in turns (off; on; on without the NaN fill of new
   tensors): ms/step of the B=20 bf16 step at K=1 and of the train CLI at
   K=8 ``--device_dataset --pallas_grads``.

Each path is driven with the kernels' launch counts set to 0 just before
it and read just after.  The last lines are a JSON object describing
each kernel (its times, its launches on the paths, and its bound: the
larger of the bytes it must move over the card's memory rate and its
operations over the peak rate of their type), and then
``{"ok": true, "device": {...}}``.  Without a CUDA
device, or when ``squeezedet_torch`` does not sit beside this file, the
script fails before printing either.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# Tolerances of the K1 check.  f32: |kernel - plain| <= 1e-4 + 1e-5*|plain|
# (the two sum 27 taps in different orders).  bf16: both round one f32
# value once, so |kernel - plain| <= 2 bf16 ulps of the plain value, with
# the f32 bound as a floor where ReLU leaves values near zero.
K1_F32_ATOL, K1_F32_RTOL = 1e-4, 1e-5
K1_BF16_ULPS = 2
# Main path, GPU f32 against the CPU: preds within rtol 1e-4 + atol 1e-4
# (std ~1 after the head rescale below); boxes within 1e-3 px, probs 1e-5.
PRED_RTOL, PRED_ATOL = 1e-4, 1e-4
BOX_ATOL, PROB_ATOL = 1e-3, 1e-5
# Order, class and keep must be equal.  Near-ties would make that luck,
# so the input batch is the first seeded one whose CPU reference keeps
# its top-65 scores MIN_GAP apart and its same-class top-64 IoUs
# MIN_IOU_MARGIN away from nms_thresh: many times the GPU-CPU f32
# differences of the scores (~1e-6) and IoUs (~3e-6), which the run prints.
MIN_GAP, MIN_IOU_MARGIN = 5e-6, 1e-4
# Phase 9's deeper backbones (VGG16: 14 convs without normalisation)
# carry more f32 rounding into the box deltas: the card and the CPU gave
# VGG16 boxes 1.6e-3 px (5.2e-6 relative) apart on an H100, so there the
# boxes may also differ by BACKBONE_BOX_RTOL of their value.
BACKBONE_BOX_RTOL = 2e-5
HEAD_SPREAD = 0.5  # std of the rescaled head's box deltas (see below)

KERNELS = ("conv1_pool1", "filter_grad")
# the bf16 (tensor-core) kernel functions of each source, by name
TC_FUNCTIONS = {"conv1_pool1": "conv1_pool1_tc",
                "filter_grad": "filter_grad_tc_partial"}
# H100 SXM data sheet peaks (at 700 W): HBM bytes/s, dense bf16 tensor-core
# and f32 CUDA-core FLOP/s
HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# K2 against its plain version: both sum f32 products (bf16 operands
# widen exactly) in different orders over up to 150k terms, so each
# output may differ by K2_RTOL times sum|x|*|dy| of its own terms (the
# plain version run on absolute values), plus K2_ATOL.
K2_RTOL, K2_ATOL = 1e-5, 1e-6
# (calls, kh, C, O, H, W) of the convs the train step routes to K2 at
# 1248x384, each called once for each of its two conv2d_pair halves: the
# squeeze 1x1s of fire5, fire6, fire9, fire10, fire11 ("1x1" mode), then
# conv12's 3x3 (True mode adds it).
K2_TRAIN_SHAPES = [(2, 1, 128, 32, 48, 156), (2, 1, 128, 48, 24, 78),
                   (2, 1, 256, 64, 24, 78), (2, 1, 256, 96, 24, 78),
                   (2, 1, 384, 96, 24, 78), (2, 3, 384, 72, 24, 78)]
K2_TRAIN_BATCH = 20
K2_BIG_BATCH = 128  # the device-bound train step (PERF.md section 5)
# the odd shapes of tests/test_filter_grad.py: (kh, kw, H, W), C = O = 128
K2_ODD_SHAPES = [(1, 1, 4, 4), (1, 1, 5, 7), (3, 3, 6, 10), (3, 3, 5, 7),
                 (5, 5, 9, 11)]
# K2 launches per backward of one train step, by filter-grad mode
K2_PER_STEP = {False: 0, "1x1": 10, True: 12}
# Train step, card against CPU (f32, TF32 off): loss terms to rtol
# LOSS_RTOL; each updated param and momentum leaf within STEP_TOL of that
# leaf's update norm (L2).  STEP_TOL is wide because a weight or bias
# gradient is an f32 sum over B*H*W positions whose terms mostly cancel
# (the 1e-4 head init keeps the data gradients small), and the card and
# the CPU, or cuDNN and K2, sum in other orders: the worst leaf measured
# 6.5e-3 (fire3.squeeze1x1.weight) card against CPU on an H100, while a
# routing or layout fault is off by O(1).  The matcher's choices must be
# equal, so the batch is the first seeded one whose CPU matching keeps
# every choice MIN_MATCH_GAP in IoU above the next smaller IoU (see
# match_gap): the matched anchors, labels and boxes must then be equal,
# and the deltas within DELTA_RTOL (relative, with the same floor), a few
# f32 ulps of a log that the two devices may round differently.
LOSS_RTOL, STEP_TOL, MIN_MATCH_GAP, DELTA_RTOL = 1e-4, 2e-2, 1e-4, 1e-6
MAX_GT = 48  # GT slots per image, as the JAX data layer pads them
# bf16 training run: steps of warm-up and of timing per (batch, mode)
WARMUP_STEPS, TIMED_STEPS = 3, 10
TRAIN_RUN_BATCHES = (20, 128)
# phase 7: the fixture, the CLI's flags and the cadences it is run with
LOOP_IMAGES, LOOP_FRAME = 48, (375, 1242)  # (H, W) of a KITTI frame
LOOP_ARGV = ["--device", "cuda", "--image_width", "1248", "--image_height",
             "384", "--batch_size", "20", "--compute_dtype", "bfloat16",
             "--learning_rate", "0.001", "--device_assign", "--uint8_ingest",
             "--device_augment", "--pallas_grads", "--checkpoint_step", "10",
             "--summary_step", "10", "--max_to_keep", "2"]
LOOP_EVERY, LOOP_KEEP = 10, 2  # --checkpoint_step / --summary_step, kept
LOOP_STEPS, LOOP_RESUME_TO, LOOP_DATASET_STEPS = 30, 40, 10
LOOP_TIMED_FROM = 2  # steps of each run left out of its ms/step
LOOP_DECODE_SAMPLE = 4  # frames data/png.py decodes beside read_frame
# phase 8: the eval split (5-8 boxes a frame, so that each class has the
# 41 GT the KITTI protocol needs for an AP of 1), the checkpoint's step,
# and the eval CLI's modes at 1248x384
EVAL_IMAGES, EVAL_BOXES, EVAL_STEP, FULL_AP_GT = 24, (5, 9), 1, 41
EVAL_MODES = (("f32 B=1 host postprocess", ["--eval_batch_size", "1"]),
              ("f32 B=8 device postprocess", ["--eval_batch_size", "8"]),
              ("bf16 B=8 --device_dataset",
               ["--eval_batch_size", "8", "--compute_dtype", "bfloat16",
                "--device_dataset"]))
# the two f32 modes' detections, as tests/test_eval_dp.py holds the JAX
# package's eval modes to each other; the scorers as
# tests/test_torch_kitti_eval.py holds them
EVAL_BOX_RTOL, EVAL_BOX_ATOL = 1e-4, 1e-3
SCORER_AP_RTOL, SCORER_ROW_ATOL = 1e-5, 1e-6
# the demo: fixture frames in image mode; in video mode MJPG frames of
# 1920x1080 whose [500:-205, 239:-439] crop is a 375x1242 fixture frame
DEMO_IMAGES, DEMO_VIDEO_FRAMES, VIDEO_FRAME = 4, 6, (1080, 1920)
# phase 9: the other backbones at their published configurations.  K2's
# routed convs of one train-step backward in filter-grad mode True, as
# (calls, kh, C, O, H, W) at the config's batch (the JAX package routes
# the same convs: tests/test_torch_backbones.py); "1x1" (--pallas_grads)
# routes none of them.  squeezeDet+: the 1x1 squeezes of fire5/6 (C=128)
# and fire9-11 (C=256) on both pair halves, the fire8-11 expands (C=384)
# and conv12's halves; VGG16: conv3_1..conv5_3 and conv6 (conv2_2's
# backward never runs: it and its input are frozen); ResNet50: conv5.
BACKBONES = ("squeezeDet+", "vgg16", "resnet50")
K2_BACKBONE_SHAPES = {
    "squeezeDet+": [(2, 1, 128, 192, 45, 153), (2, 1, 128, 288, 45, 153),
                    (1, 1, 384, 256, 45, 153), (1, 3, 384, 256, 45, 153),
                    (6, 1, 256, 384, 22, 76), (3, 1, 384, 256, 22, 76),
                    (3, 3, 384, 256, 22, 76), (2, 3, 256, 72, 22, 76)],
    "vgg16": [(1, 3, 128, 256, 94, 311), (2, 3, 256, 256, 94, 311),
              (1, 3, 256, 512, 47, 156), (2, 3, 512, 512, 47, 156),
              (3, 3, 512, 512, 24, 78), (1, 3, 512, 72, 24, 78)],
    "resnet50": [(1, 3, 1024, 72, 24, 78)],
}
# steps of the f32 mode comparison, and the train CLI's bf16 run (at the
# config's batch and resolution) with its fixture of 1242x375 frames
BACKBONE_MODE_BATCH, BACKBONE_CLI_STEPS, BACKBONE_IMAGES = 4, 10, 24
BACKBONE_DEMO_FRAMES = 3
# phase 10: int8 and the exported artifact.  Calibration batches (uint8,
# B=2), the batches of the int8 readings, the hybrid boundary, the
# artifact's batch, and the int8 eval's calibration batches.
INT8_CALIB_BATCHES, INT8_CHECK_BATCH, INT8_BIG_BATCH = 2, 2, 128
INT8_HYBRID_START, EXPORT_BATCH, INT8_EVAL_CALIB = "fire2", 8, 2
# phase 11: data parallelism on the one card.  Ranks (and replicas) that
# share it; the f32 step's global batch; the train CLI's steps (global
# batch LOOP_ARGV's 20) and the steps it traces for the collectives; the
# fixture frames; eval's batch.  Two ranks' f32 step against one
# process's is held to phase 6's LOSS_RTOL and to DP_STEP_TOL of each
# leaf's update norm: the same sums in other orders on one card, whose
# worst leaf measured 2.756e-4 (two gloo ranks) and 2.080e-4 (one NCCL
# rank) on an H100; the limit leaves room of about 7x above them, and is
# 10x tighter than phase 6's card-against-CPU STEP_TOL.
DP_RANKS, DP_STEP_BATCH, DP_CLI_STEPS, DP_IMAGES = 2, 4, 10, 24
DP_STEP_TOL = 2e-3
DP_PROFILE_STEPS, DP_EVAL_BATCH = "7:9", 8
# the two gloo ranks' train CLI at DP_SCAN_K steps per dispatch beside its
# K=1 --device_dataset run: DP_SCAN_STEPS steps, six dispatches (eager,
# captured, four replayed; the median step is read from the last three)
DP_SCAN_K, DP_SCAN_STEPS = 8, 48
# phase 12: K steps per dispatch as one captured CUDA graph.  (a) K steps,
# the batch, the canvases they gather from and the dispatches (the first
# runs eagerly, the second captures and replays, the rest replay), with a
# warm-up that ends inside the second dispatch; held to phase 6's
# LOSS_RTOL and phase 11's DP_STEP_TOL.  (b) the train CLI's K, the K=1
# and K runs' steps (eight dispatches and an odd tail), then a run with a
# checkpoint every GRAPH_EVERY steps to GRAPH_CKPT_TO and its resume to
# GRAPH_RESUME_TO; the NCCL rank's K (phase 11's 10 steps); (c) the
# histogram steps of the --activation_summary run; (d) the learning check:
# the recipe's fixture (scripts/torch_large_batch_recipe.sh gen) and its
# large arm at seed 0 with --device_dataset, whose val mAP must reach
# LEARN_MIN_MAP, below all 11 of the JAX package's per-seed results on
# this fixture (lowest 0.829, PARITY.md).
GRAPH_K, GRAPH_BATCH, GRAPH_CANVASES, GRAPH_DISPATCHES = 4, 20, 40, 3
GRAPH_WARMUP = 6
# (a) over two gloo ranks sharing the card: GRAPH_K-step dispatches of the
# global batch GRAPH_BATCH, GRAPH_DISPATCHES of them, captured as a chain
# of graphs split at the host all-reduces, against the same steps run one
# at a time on the same ranks, bit for bit (gloo_scan_check)
GRAPH_CLI_K, GRAPH_K1_STEPS, GRAPH_STEPS = 8, 40, 69
GRAPH_EVERY, GRAPH_CKPT_TO, GRAPH_RESUME_TO = 8, 21, 37
NCCL_SCAN_K, ACT_STEPS, ACT_HIST_EVERY = 4, 3, 2
LEARN_TRAIN, LEARN_VAL, LEARN_FRAME = 256, 75, (384, 1248)
LEARN_ARGV = ["--image_width", "1248", "--image_height", "384",
              "--batch_size", "16", "--learning_rate", "0.001",
              "--max_steps", "375", "--checkpoint_step", "125",
              "--device_assign", "--uint8_ingest", "--compute_dtype",
              "bfloat16", "--image_cache_mb", "768", "--seed", "0",
              "--recipe_batch", "128", "--device_dataset",
              "--steps_per_dispatch", "8"]
LEARN_STEPS, LEARN_MIN_MAP = 375, 0.75
# phase 13: spatial partitioning on the one card (every tile on cuda:0).
# (a) squeezeDet's tile grids (n_h, n_w) in f32, and the bf16 one, held to
# tests/test_spatial.py's tolerances (boxes rtol/atol SPATIAL_BOX_TOL,
# probs rtol SPATIAL_BOX_TOL atol SPATIAL_PROB_ATOL, classes, keep and
# post-NMS choices equal; the input is the first seeded frame whose
# unsharded output keeps its ranks and NMS choices MIN_GAP and
# MIN_IOU_MARGIN clear).  bf16 tiles: each raw pred within
# SPATIAL_BF16_ULPS bf16 ulps of the bf16 frame's value.  Tile and frame
# run the same ops on the same rows, so they may differ only where cuDNN
# picks another summation order for a tile's shape and a rounding flips;
# on the card they were equal bit for bit (NVIDIA H100 80GB HBM3,
# 700.00 W, PERF.md section 6).  (b) the other nets'
# grids, with phase 9's tolerances; (c) the int8 grid of
# SPATIAL_DEVICES devices (spatial_factors), bit for bit; (d) the eval
# CLI over SPATIAL_DEVICES tiles on its fixture of SPATIAL_EVAL_IMAGES
# frames; (e) the f32 step's batch over (1, SPATIAL_TILES) tiles, the
# data x spatial step's global batch over two gloo ranks of SPATIAL_TILES
# tiles each, and a K=SPATIAL_SCAN_K captured dispatch over those tiles
# against its eager steps (SPATIAL_DISPATCHES dispatches), held to phase
# 6's LOSS_RTOL and phase 11's DP_STEP_TOL.  cuDNN's f32 algorithms at
# B=2 are not deterministic run to run: two eager runs of those 12 steps
# differed by up to 9.7e-5 of the loss and 2.4e-3 of a leaf's update,
# tiled or not, and were bit for bit equal under cudnn.deterministic, as
# were the captured and eager runs (NVIDIA H100 80GB HBM3, 700.00 W), so
# that comparison runs under trainer.deterministic, as the train loop
# does.  (f) K1 against its plain version
# (phase 1's tolerances) on every tile window of the SPATIAL_K1_GRIDS
# tilings at 1248x384, at the tile's geometry, in f32 and bf16; then
# readings at SPATIAL_READ_TILES height tiles.
SPATIAL_GRIDS = ((2, 1), (3, 1), (4, 1), (2, 2))
SPATIAL_BF16_GRID, SPATIAL_BACKBONE_GRIDS = (4, 1), ((2, 1), (2, 2))
SPATIAL_BF16_ULPS = 2
SPATIAL_K1_GRIDS = ((2, 1), (4, 1), (2, 2))
SPATIAL_BOX_TOL, SPATIAL_PROB_ATOL = 1e-4, 1e-6
SPATIAL_DEVICES, SPATIAL_EVAL_IMAGES, SPATIAL_TILES = 4, 6, 2
SPATIAL_STEP_BATCH, SPATIAL_DP_BATCH = 2, 4
SPATIAL_SCAN_K, SPATIAL_DISPATCHES = 4, 3
# (e) also: two gloo ranks of SPATIAL_TILES tiles each at the global batch
# SPATIAL_DP_BATCH, SPATIAL_DISPATCHES captured K=SPATIAL_SCAN_K dispatches
# against the same steps run one at a time, bit for bit (gloo_scan_check)
SPATIAL_READ_TILES = (1, 2, 4)


# phase 14: the host paths of the port.  (a) deterministic training: the
# train CLI at B=20 1248x384 on DET_IMAGES KITTI-shaped frames, DET_STEPS
# steps straight against DET_SPLIT steps plus a resume, in each DET_MODES
# mode at each of DET_KS steps per dispatch, params and momentum bit for
# bit; (b) the native loader: a NATIVE_ARGV train run it feeds, its
# pixels within NATIVE_PIXEL_ATOL of the Python reader's (the tolerance of
# tests/test_native_loader.py: the two subtract the means in float32 and
# float64), and the eval CLI at NATIVE_EVAL_BATCH; (c) the checkpoint
# import; (d) the cost of deterministic mode, COST_VARIANTS in turns: the
# step over COST_STEPS (the first COST_WARMUP untimed) and the train CLI
# at K=COST_CLI_K.
DET_IMAGES, DET_BATCH, DET_STEPS, DET_SPLIT, DET_KS = 24, 20, 4, 2, (1, 2)
DET_ARGV = ["--device", "cuda", "--image_width", "1248", "--image_height",
            "384", "--batch_size", str(DET_BATCH), "--learning_rate",
            "0.001", "--device_assign", "--uint8_ingest", "--device_augment",
            "--checkpoint_step", str(DET_SPLIT), "--summary_step", "0"]
DET_MODES = (("f32", ["--compute_dtype", "float32"]),
             ("bf16 --pallas_grads", ["--compute_dtype", "bfloat16",
                                      "--pallas_grads"]))
NATIVE_ARGV = ["--device", "cuda", "--image_width", "1248",
               "--image_height", "384", "--batch_size", str(DET_BATCH),
               "--compute_dtype", "bfloat16", "--learning_rate", "0.001",
               "--device_assign", "--native_loader", "--pallas_grads",
               "--max_steps", "8", "--checkpoint_step", "1000",
               "--summary_step", "0"]
NATIVE_PIXEL_ATOL, NATIVE_EVAL_BATCH = 5e-3, 8
COST_STEPS, COST_WARMUP, COST_CLI_K = 13, 3, 8
COST_VARIANTS = ("off", "on", "on, no fill")
COST_CLI_ARGV = ["--device", "cuda", "--image_width", "1248",
                 "--image_height", "384", "--batch_size", str(DET_BATCH),
                 "--compute_dtype", "bfloat16", "--learning_rate", "0.001",
                 "--device_assign", "--uint8_ingest", "--device_dataset",
                 "--pallas_grads", "--steps_per_dispatch", str(COST_CLI_K),
                 "--max_steps", str(5 * COST_CLI_K), "--checkpoint_step",
                 "1000", "--summary_step", "0"]


def log(*a):
    print(*a, flush=True)


def import_port():
    """Import squeezedet_torch from this file's directory, and only there."""
    sys.path.insert(0, HERE)
    import squeezedet_torch
    where = os.path.dirname(os.path.dirname(
        os.path.abspath(squeezedet_torch.__file__)))
    if where != HERE:
        raise SystemExit("chip_smoke: squeezedet_torch found at {}, not "
                         "beside this script".format(where))
    return squeezedet_torch


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, peak):
    """(ms, what binds): the least time for moving ``nbytes`` and doing
    ``flops`` at the card's peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_bound(b, h, w, f32=False, geo=None):
    """K1 (bf16 on the tensor cores, or f32 on the CUDA cores): read the
    images once, write the pooled output once; 27 multiply-adds for each
    of the 64 channels of each conv output.  ``geo``: a tile's geometry
    (``fused_frontend.tile_geometry``) over its h x w window."""
    from squeezedet_torch.ops import fused_frontend as ff
    hc, wc, hp, wp = (geo or ff.geometry(h, w))[:4]
    size, peak = (4, F32_FLOPS) if f32 else (2, BF16_FLOPS)
    return bound(size * (b * h * w * 3 + b * hp * wp * 64),
                 2 * 27 * 64 * b * hc * wc, peak)


def k2_bound(b, kh, c, o, h, w):
    """bf16 K2: read X and dY once, write dW (f32) once; a multiply-add
    for every (position, tap, c, o)."""
    m = b * h * w
    return bound(2 * m * (c + o) + 4 * kh * kh * c * o,
                 2 * m * c * o * kh * kh, BF16_FLOPS)


def tensor_core_counts(so):
    """{kernel function: HMMA/HGMMA instructions} in a library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def _nvcc():
    from squeezedet_torch.ops import _cuda
    return _cuda.nvcc_path()


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "python",
        sys.version.split()[0])
    from squeezedet_torch.ops import _cuda
    log(subprocess.run([_cuda.nvcc_path(), "--version"], capture_output=True,
                       text=True, check=True, timeout=60).stdout.strip())
    return card


def phase_build():
    """One nvcc per kernel source, all started together."""
    from squeezedet_torch.ops import _cuda
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(_cuda.build, KERNELS))
    for name in KERNELS:
        _cuda.load(name)
        log("[build] {} -> {}".format(name, _cuda.library_path(name).name))
        log(_cuda.BUILD_LOGS.get(name, "(cached build)").strip())
    log("[build] {} kernels in {:.1f} s".format(len(KERNELS),
                                                 time.perf_counter() - t0))
    tc = {}
    for name in KERNELS:
        counts = tensor_core_counts(_cuda.library_path(name))
        for fn, n in sorted(counts.items()):
            log("[build] {}: {} tensor-core instructions (HMMA/HGMMA) in "
                "{}".format(name, n, fn))
        tc[name] = sum(n for fn, n in counts.items()
                       if TC_FUNCTIONS[name] in fn)
        if tc[name] == 0:
            raise AssertionError("{}'s bf16 kernel has no tensor-core "
                                 "instruction in its SASS".format(name))
    return tc


def k1_inputs(b, h, w, dtype, seed):
    import numpy as np
    import torch

    from squeezedet_torch.config import VGG_BGR_MEANS
    from squeezedet_torch.data.device_pipeline import normalize_images
    rs = np.random.RandomState(seed)
    u8 = torch.from_numpy(rs.randint(0, 256, (b, h, w, 3), dtype=np.uint8))
    x = normalize_images(u8.cuda(), VGG_BGR_MEANS, dtype)
    k = torch.from_numpy(rs.randn(3, 3, 3, 64).astype(np.float32) * 0.1)
    bias = torch.from_numpy(rs.randn(64).astype(np.float32) * 10.0)
    return x, k.cuda(), bias.cuda()


def bf16_ulp(p):
    """The bf16 ulp of each value of the f32 tensor ``p`` (0 at 0)."""
    import torch
    _, exp = torch.frexp(p.abs())
    return torch.where(p == 0, torch.zeros_like(p),
                       torch.ldexp(torch.ones_like(p), exp - 8))


def check_k1(b, h, w, dtype, seed, window=None, geo=None):
    """K1 against its plain version on seeded b x h x w images, or on
    their ``window`` ((r0, r1), (c0, c1)) at a tile's ``geo``
    (``fused_frontend.tile_geometry``).  Returns the max abs error."""
    import torch

    from squeezedet_torch.ops import fused_frontend as ff
    x, k, bias = k1_inputs(b, h, w, dtype, seed)
    if window is not None:
        (r0, r1), (c0, c1) = window
        x = x[:, r0:r1, c0:c1].contiguous()
    got = ff.conv1_pool1(x, k, bias, geo)
    want = ff.conv1_pool1_reference(x, k, bias, geo)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != dtype:
        raise AssertionError("K1 shape/dtype {} {} vs plain {}".format(
            tuple(got.shape), got.dtype, tuple(want.shape)))
    if not torch.isfinite(got).all():
        raise AssertionError("K1 output is not finite")
    g, p = got.float(), want.float()
    err = (g - p).abs()
    allowed = K1_F32_ATOL + K1_F32_RTOL * p.abs()
    if dtype == torch.bfloat16:
        allowed = torch.maximum(allowed, K1_BF16_ULPS * bf16_ulp(p))
    worst = (err / allowed).max().item()
    max_err = err.max().item()
    log("[k1] {}x{}x{} {}{}: max abs err {:.3e}, worst err/tolerance "
        "{:.3f}".format(b, h, w, str(dtype).replace("torch.", ""),
                        "" if window is None else
                        ", window {} at geometry {}".format(window, geo),
                        max_err, worst))
    if worst > 1.0:
        raise AssertionError("K1 disagrees with its plain version")
    return max_err


def phase_k1(card):
    import torch

    from squeezedet_torch.models import layers as L
    from squeezedet_torch.ops import fused_frontend as ff
    torch.backends.cudnn.allow_tf32 = False  # f32 convs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        return _phase_k1(card)


def _phase_k1(card):
    import torch

    from squeezedet_torch.models import layers as L
    from squeezedet_torch.ops import fused_frontend as ff
    check_k1(8, 384, 1248, torch.float32, 0)
    max_err = check_k1(8, 384, 1248, torch.bfloat16, 1)
    check_k1(2, 375, 1242, torch.float32, 2)
    check_k1(2, 375, 1242, torch.bfloat16, 3)

    x, k, bias = k1_inputs(128, 384, 1248, torch.bfloat16, 4)
    conv = L.Conv(k.permute(3, 2, 0, 1).contiguous(), bias)
    kern = lambda: ff.conv1_pool1(x, k, bias)  # noqa: E731
    plain = lambda: ff.conv1_pool1_reference(x, k, bias)  # noqa: E731
    # what an unfused bf16 port runs: cuDNN conv + bias, ReLU, pool
    unfused = lambda: L.max_pool(L.conv2d(conv, x, 2), 3, 2)  # noqa: E731
    times = {"plain": [], "kernel": [], "unfused": []}
    for name in ("plain", "kernel", "unfused", "unfused", "kernel",
                 "plain"):
        fn = {"plain": plain, "kernel": kern, "unfused": unfused}[name]
        times[name].append(cuda_ms(fn, iters=10))
    ms = {n: sum(v) / len(v) for n, v in times.items()}
    bound_ms, bound_by = k1_bound(128, 384, 1248)
    log("[k1] B=128 384x1248 bf16 on {}: kernel {:.4f} ms, plain {:.4f} ms, "
        "unfused bf16 layers {:.4f} ms, bound {:.4f} ms ({}) (runs: {})".format(
            card, ms["kernel"], ms["plain"], ms["unfused"], bound_ms,
            bound_by, json.dumps(times)))
    # no one PyTorch call computes conv + bias + ReLU + pool: library_ms is
    # null, and the unfused layers' time is printed above as the yardstick
    return {"max_abs_err": max_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_k2(b, kh, kw, h, w, c, o, dtype, gen):
    """K2 against its plain version on one shape; returns max abs err."""
    import torch

    from squeezedet_torch.ops import filter_grad as fg
    x = torch.randn(b, h, w, c, device="cuda", generator=gen).to(dtype)
    dy = torch.randn(b, h, w, o, device="cuda", generator=gen).to(dtype)
    got = fg.filter_grad(x, dy, kh, kw)
    again = fg.filter_grad(x, dy, kh, kw)
    want = fg.filter_grad_reference(x, dy, kh, kw)
    scale = fg.filter_grad_reference(x.abs(), dy.abs(), kh, kw)
    torch.cuda.synchronize()
    if got.shape != (kh, kw, c, o) or got.dtype != torch.float32:
        raise AssertionError("K2 shape/dtype {} {}".format(
            tuple(got.shape), got.dtype))
    if not torch.equal(got, again):
        raise AssertionError("two K2 launches differ")
    err = (got - want).abs()
    worst = (err / (K2_RTOL * scale + K2_ATOL)).max().item()
    log("[k2] B={} {}x{} C={} O={} {}x{} {}: max abs err {:.3e}, worst "
        "err/tolerance {:.3f}, bitwise repeatable".format(
            b, kh, kw, c, o, h, w, str(dtype).replace("torch.", ""),
            err.max().item(), worst))
    if worst > 1.0:
        raise AssertionError("K2 disagrees with its plain version")
    return err.max().item()


def time_k2(card, batch, dtype, gen, with_plain, shapes=K2_TRAIN_SHAPES,
            what="squeezeDet"):
    """K2, (its plain version) and cuDNN's weight gradient timed at the
    ``shapes`` (calls, kh, C, O, H, W) of one backward, each in turn;
    returns the sums over the backward's calls and the per-shape rows."""
    import torch

    from squeezedet_torch.ops import filter_grad as fg
    name = str(dtype).replace("torch.", "")
    total = {"kernel": 0.0, "plain": 0.0, "cudnn": 0.0, "bound": 0.0,
             "bytes": 0.0, "operations": 0.0}
    largest, rows = None, []
    for calls, kh, c, o, h, w in shapes:
        x = torch.randn(batch, h, w, c, device="cuda", generator=gen).to(dtype)
        dy = torch.randn(batch, h, w, o, device="cuda",
                         generator=gen).to(dtype)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        fns = {
            "kernel": lambda: fg.filter_grad(x, dy, kh, kh),
            "plain": lambda: fg.filter_grad_reference(x, dy, kh, kh),
            # what autograd runs with the mode off
            "cudnn": lambda: torch.nn.grad.conv2d_weight(
                xn, (o, c, kh, kh), dyn, padding=kh // 2),
        }
        order = ("plain", "kernel", "cudnn", "cudnn", "kernel", "plain")
        if not with_plain:
            order = ("kernel", "cudnn", "cudnn", "kernel")
        ms = {n: [] for n in fns}
        for n in order:
            ms[n].append(cuda_ms(fns[n], iters=10))
        ms = {n: sum(v) / len(v) if v else 0.0 for n, v in ms.items()}
        ms["bound"], bound_by = k2_bound(batch, kh, c, o, h, w)
        ms["bytes"] = ms["operations"] = 0.0
        ms[bound_by] = ms["bound"]
        for n in total:
            total[n] += calls * ms[n]
        if largest is None or ms["kernel"] > largest[1]["kernel"]:
            largest = ((kh, c, o, h, w), ms)
        rows.append({"batch": batch, "kh": kh, "C": c, "O": o, "H": h,
                     "W": w, "calls": calls, "ms": ms["kernel"],
                     "library_ms": ms["cudnn"], "bound_ms": ms["bound"],
                     "bound_by": bound_by})
        log("[k2] time B={} {}x{} C={} O={} {}x{} {}: kernel {:.4f} ms, "
            "plain {}, cuDNN weight grad {:.4f} ms; bf16 bound {:.4f} ms "
            "({}), kernel at {:.1f} TFLOP/s".format(
                batch, kh, kh, c, o, h, w, name, ms["kernel"],
                "{:.4f} ms".format(ms["plain"]) if with_plain else "not timed",
                ms["cudnn"], ms["bound"], bound_by,
                2 * batch * h * w * c * o * kh * kh / ms["kernel"] / 1e9))
        del x, dy, xn, dyn
    log("[k2] one {} backward's {} K2 calls, B={} {} on {}: kernel {:.4f} "
        "ms, plain {}, cuDNN weight grad {:.4f} ms, bf16 bound {:.4f} ms; "
        "largest call {} kernel {:.4f} ms".format(
            what, sum(s[0] for s in shapes), batch, name, card,
            total["kernel"],
            "{:.4f} ms".format(total["plain"]) if with_plain else "not timed",
            total["cudnn"], total["bound"], largest[0], largest[1]["kernel"]))
    return total, rows


def phase_k2(card):
    """K2 against its plain version at the train step's and the odd
    shapes, then K2, its plain version and cuDNN's weight gradient timed
    at the train step's shapes (B=20) in f32 and bf16, and K2 and cuDNN
    in bf16 at B=128."""
    import torch

    from squeezedet_torch.ops import filter_grad as fg
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for _, kh, c, o, h, w in K2_TRAIN_SHAPES:
            max_err = max(max_err, check_k2(K2_TRAIN_BATCH, kh, kh, h, w, c,
                                            o, dtype, gen))
        for kh, kw, h, w in K2_ODD_SHAPES:
            max_err = max(max_err, check_k2(2, kh, kw, h, w, 128, 128, dtype,
                                            gen))

    t32, _ = time_k2(card, K2_TRAIN_BATCH, torch.float32, gen, True)
    t16, _ = time_k2(card, K2_TRAIN_BATCH, torch.bfloat16, gen, True)
    time_k2(card, K2_BIG_BATCH, torch.bfloat16, gen, False)
    log("[k2] f32 route, B={}: kernel {:.4f} ms against its CUDA-core f32 "
        "bound {:.4f} ms".format(K2_TRAIN_BATCH, t32["kernel"], sum(
            calls * 2 * K2_TRAIN_BATCH * h * w * c * o * kh * kh / F32_FLOPS
            * 1e3 for calls, kh, c, o, h, w in K2_TRAIN_SHAPES)))
    # what binds the larger part of the 12 calls' summed bound
    bound_by = max(("bytes", "operations"), key=lambda k: t16[k])
    return {"max_abs_err": max_err, "ms": t16["kernel"],
            "plain_ms": t16["plain"], "bound_ms": t16["bound"],
            "bound_by": bound_by, "library_ms": t16["cudnn"]}


def _top_gap(probs):
    """Smallest gap between consecutive scores among each image's top 65
    (top-64 ranks are well defined when this exceeds the scores' noise)."""
    import torch
    top = torch.sort(probs, dim=1, descending=True).values[:, :65]
    return (top[:, :-1] - top[:, 1:]).min().item()


def _same_class_iou(boxes, classes):
    """IoUs of the distinct same-class pairs among the top-64 boxes."""
    import torch

    from squeezedet_torch.ops.boxes import pairwise_iou_center
    iou = pairwise_iou_center(boxes, boxes, eps=1e-12)
    same = classes[:, :, None] == classes[:, None, :]
    off = torch.eye(boxes.shape[1], dtype=torch.bool)[None]
    return iou[same & ~off]


def rescaled_detector(net, cfg, u8):
    """``net`` with its seeded weights on the card, the head rescaled so
    that its box deltas have std HEAD_SPREAD on ``u8``: the 1e-4 head init
    leaves every score near 1/6, where top-64 ranks are ties.  One
    forward on the card."""
    import torch

    from squeezedet_torch.models import get_model
    det = get_model(net, cfg, device="cuda")
    with torch.no_grad():
        spread = det.predict_raw(u8.cuda()).pred_box_delta.std().item()
        det.layers()[-1].weight.mul_(HEAD_SPREAD / spread)
    return det


def serving_check(det, tag, box_rtol=0.0):
    """uint8 -> detections of ``det`` (f32, on the card) against the same
    weights on the CPU, on the first seeded batch whose CPU reference
    keeps its ranks and NMS choices clear of near-ties; boxes within
    BOX_ATOL px plus ``box_rtol`` of their value.  Returns the forwards
    run on the card."""
    import numpy as np
    import torch

    from squeezedet_torch.models import get_model
    cfg = det.cfg
    cpu = get_model(det.net, cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    shape = (cfg.batch_size, cfg.image_height, cfg.image_width, 3)
    for seed in range(1, 65):
        u8 = torch.from_numpy(np.random.RandomState(seed).randint(
            0, 256, shape, dtype=np.uint8))
        cpu_interp = cpu.predict_raw(u8)
        cpu_out = cpu.postprocess_device(cpu_interp)
        gap = _top_gap(cpu_interp.det_probs)
        cpu_iou = _same_class_iou(cpu_out[0], cpu_out[2])
        margin = (cpu_iou - cfg.nms_thresh).abs().min().item()
        if gap >= MIN_GAP and margin >= MIN_IOU_MARGIN:
            break
    else:
        raise AssertionError("no seeded batch with separated top-64 ranks")

    gpu_interp = det.predict_raw(u8.cuda())
    gpu_out = det.predict_raw_postprocessed(u8.cuda())
    for name in ("pred_class_logits", "pred_conf", "pred_box_delta"):
        torch.testing.assert_close(getattr(gpu_interp, name).cpu(),
                                   getattr(cpu_interp, name),
                                   rtol=PRED_RTOL, atol=PRED_ATOL)
    boxes, probs, classes, keep = [o.cpu() for o in gpu_out]
    noise = (gpu_interp.det_probs.cpu() - cpu_interp.det_probs).abs().max()
    iou_noise = (_same_class_iou(boxes, cpu_out[2]) - cpu_iou).abs().max()
    log("[{}] {} f32 B={}, input seed {}: preds match the CPU; top-65 score "
        "gap {:.3e} vs max score difference {:.3e}; IoU margin to "
        "nms_thresh {:.3e} vs max IoU difference {:.3e}".format(
            tag, det.net, cfg.batch_size, seed, gap, noise.item(), margin,
            iou_noise.item()))
    torch.testing.assert_close(boxes, cpu_out[0], rtol=box_rtol,
                               atol=BOX_ATOL)
    torch.testing.assert_close(probs, cpu_out[1], rtol=0, atol=PROB_ATOL)
    if not (torch.equal(classes, cpu_out[2]) and
            torch.equal(keep, cpu_out[3])):
        raise AssertionError("classes/keep differ between GPU and CPU")
    log("[{}] {} f32 B={}: boxes (max difference {:.3e} px), probs, "
        "classes and keep agree with the CPU ({} kept)".format(
            tag, det.net, cfg.batch_size,
            (boxes - cpu_out[0]).abs().max().item(), int(keep.sum())))
    return 2


def serving_reading(det, batch, warmup, iters, card, tag):
    """uint8 -> detections of ``det`` (bf16) timed at ``batch`` on the
    host clock, a smoke reading; returns the forwards run."""
    import numpy as np
    import torch
    cfg = det.cfg
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (batch, cfg.image_height, cfg.image_width, 3),
        dtype=np.uint8)).cuda()
    for _ in range(warmup):
        out = det.predict_raw_postprocessed(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = det.predict_raw_postprocessed(x)
    kept = int(out[3].sum().item())  # consumes the last batch's outputs
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    boxes, probs, classes, keep = out
    if boxes.shape != (batch, 64, 4) or probs.shape != (batch, 64) or \
            not (torch.isfinite(boxes).all() and torch.isfinite(probs).all()):
        raise AssertionError("bad bf16 outputs {}".format(
            [tuple(o.shape) for o in out]))
    log("[{}] smoke reading, not a benchmark: {} uint8->detections B={} "
        "{}x{} bf16: {:.3f} ms/batch, {:.1f} img/s, peak {:.2f} GiB, {} "
        "kept, on {}".format(tag, det.net, batch, cfg.image_height,
                             cfg.image_width, dt * 1e3, batch / dt,
                             torch.cuda.max_memory_allocated() / 2**30, kept,
                             card))
    return warmup + iters


def phase_main_path(card):
    import numpy as np
    import torch

    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.models import get_model
    from squeezedet_torch.ops import fused_frontend as ff
    cfg = kitti_squeezedet_config().replace(batch_size=2)
    u8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, cfg.image_height, cfg.image_width, 3), dtype=np.uint8))
    det = rescaled_detector("squeezeDet", cfg, u8)
    forwards = 1 + serving_check(det, "main")
    if ff.LAUNCHES != forwards:
        raise AssertionError("K1 launches {} != forwards {}".format(
            ff.LAUNCHES, forwards))

    det16 = get_model("squeezeDet", cfg.replace(compute_dtype="bfloat16"),
                      device="cuda")
    det16.load_state_dict(det.state_dict())
    forwards += serving_reading(det16, 128, 3, 10, card, "main")
    if ff.LAUNCHES != forwards:
        raise AssertionError("K1 launches {} != forwards {}".format(
            ff.LAUNCHES, forwards))
    return forwards


def phase_server():
    import numpy as np

    from squeezedet_torch import serve
    args = serve.build_arg_parser().parse_args(
        ["--max_batch", "8", "--port", "0", "--device", "cuda"])
    server, batcher = serve.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:{}/healthz".format(server.server_address[1])
        with urllib.request.urlopen(url, timeout=30) as r:
            if r.status != 200 or r.read() != b"ok":
                raise AssertionError("/healthz did not answer 200 ok")
        frames = np.random.RandomState(1).randint(
            0, 256, (16, 384, 1248, 3), dtype=np.uint8)
        with ThreadPoolExecutor(16) as pool:
            replies = list(pool.map(batcher.submit, frames))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if len(replies) != 16:
        raise AssertionError("{} replies".format(len(replies)))
    for boxes, probs, classes, keep in replies:
        if boxes.shape != (1, 64, 4) or probs.shape != (1, 64) or \
                classes.shape != (1, 64) or keep.shape != (1, 64) or \
                not (np.isfinite(boxes).all() and np.isfinite(probs).all()):
            raise AssertionError("bad reply shapes {}".format(
                [o.shape for o in (boxes, probs, classes, keep)]))
    if batcher.batches_run < 2:
        raise AssertionError("batches_run {}".format(batcher.batches_run))
    log("[serve] /healthz 200; 16 requests in {} batches of 8".format(
        batcher.batches_run))
    return 1 + batcher.batches_run  # warm-up forward + batches


def gt_batch(rs, b, cfg):
    """Seeded padded ground truth: MAX_GT center-format boxes per image
    inside the image, of which the first 1..MAX_GT/2 are valid; the padded
    slots hold boxes too, which the matcher must ignore."""
    import numpy as np
    import torch
    bw = rs.uniform(20, cfg.image_width / 4, (b, MAX_GT))
    bh = rs.uniform(20, cfg.image_height / 2, (b, MAX_GT))
    cx = rs.uniform(bw / 2, cfg.image_width - bw / 2)
    cy = rs.uniform(bh / 2, cfg.image_height - bh / 2)
    boxes = np.stack([cx, cy, bw, bh], axis=-1).astype(np.float32)
    labels = rs.randint(0, cfg.classes, (b, MAX_GT))
    num_gt = rs.randint(1, MAX_GT // 2 + 1, b)
    return [torch.from_numpy(a) for a in (boxes, labels, num_gt)]


def match_gap(anchors, boxes, num_gt):
    """The matcher's choices replayed on the CPU: the smallest gap
    between a choice's IoU and the next smaller unclaimed IoU, or -1 if a
    choice falls back to the distance rule.  Exact ties are common (a box
    that contains several anchors of one shape) and harmless: the IoU
    takes only +, -, *, / and min/max, which round the same on both
    devices, and both break an exact tie by the largest index."""
    import torch

    from squeezedet_torch.ops.boxes import batch_iou
    gap = float("inf")
    for i in range(boxes.shape[0]):
        claimed = torch.zeros(anchors.shape[0], dtype=torch.bool)
        for g in range(int(num_gt[i])):
            iou = batch_iou(anchors, boxes[i, g]).masked_fill(claimed, -1.0)
            best = iou.max()
            if best <= 0:
                return -1.0
            gap = min(gap, (best - iou[iou < best].max()).item())
            claimed[(iou == best).nonzero().max()] = True
    return gap


def fresh_state(cfg, device, weights):
    """A TrainState on ``device``: the detector of ``cfg.net`` with
    ``weights`` (a backbone state_dict) and a new optimizer."""
    from squeezedet_torch.models import get_model
    from squeezedet_torch.optim import build_optimizer
    from squeezedet_torch.trainer import TrainState
    det = get_model(cfg.net, cfg, device=device)
    det.backbone.load_state_dict(weights)
    return TrainState(det, build_optimizer(cfg, det))


def worst_step_ratio(got, want, before):
    """max over leaves of ||got - want|| / ||want - before|| (L2): the
    disagreement of two updated params relative to the update."""
    worst, leaf = 0.0, None
    for name, w in want.items():
        diff = (got[name].cpu() - w.cpu()).norm().item()
        moved = (w.cpu() - before[name].cpu()).norm().item()
        if moved == 0.0:
            if diff != 0.0:
                raise AssertionError("{} moved on one side only".format(name))
            continue
        if diff / moved > worst:
            worst, leaf = diff / moved, name
    return worst, leaf


def phase_train_check(weights, cfg):
    """One f32 B=2 train step of ``cfg.net`` in filter-grad mode True on
    the card against the CPU; returns the number of steps run on the
    card."""
    import numpy as np
    import torch

    from squeezedet_torch.data.device_pipeline import assign_anchors_device
    from squeezedet_torch.models import layers as L
    from squeezedet_torch.trainer import make_train_step_device
    cfg = cfg.replace(keep_prob=1.0)
    anchors = torch.tensor(cfg.anchor_box, dtype=torch.float32)
    for seed in range(1, 65):
        rs = np.random.RandomState(seed)
        u8 = torch.from_numpy(rs.randint(0, 256, (2, cfg.image_height,
                                                  cfg.image_width, 3),
                                         dtype=np.uint8))
        gt = gt_batch(rs, 2, cfg)
        gap = match_gap(anchors, gt[0], gt[2])
        if gap >= MIN_MATCH_GAP:
            break
    else:
        raise AssertionError("no seeded batch with separated matches")

    want = assign_anchors_device(anchors, *gt, cfg.classes)
    got = assign_anchors_device(anchors.cuda(), *[t.cuda() for t in gt],
                                cfg.classes)
    for name in ("input_mask", "box_input", "labels"):
        if not torch.equal(getattr(got, name).cpu(), getattr(want, name)):
            raise AssertionError("matcher targets {} differ".format(name))
    # the deltas take a log, which the two devices may round differently
    delta = (got.box_delta_input.cpu() - want.box_delta_input).abs().max()
    torch.testing.assert_close(got.box_delta_input.cpu(),
                               want.box_delta_input, rtol=DELTA_RTOL,
                               atol=DELTA_RTOL)
    log("[train] {} f32 B=2, batch seed {}: {} GT boxes, IoU gap to the "
        "next smaller IoU >= {:.3e}; matcher mask, boxes and labels equal "
        "on card and CPU, deltas within {:.3e}".format(
            cfg.net, seed, int(gt[2].sum()), gap, delta.item()))

    L.set_filter_grad(True)
    cpu = fresh_state(cfg, "cpu", weights)
    gpu = fresh_state(cfg, "cuda", weights)
    lb_cpu = make_train_step_device(cpu, uint8_ingest=True)(u8, *gt)
    lb_gpu = make_train_step_device(gpu, uint8_ingest=True)(
        u8.cuda(), *[t.cuda() for t in gt])
    torch.testing.assert_close(torch.stack(list(lb_gpu)).cpu(),
                               torch.stack(list(lb_cpu)), rtol=LOSS_RTOL,
                               atol=0)
    params, momentum = worst_step_ratio(
        gpu.det.backbone.state_dict(), cpu.det.backbone.state_dict(),
        weights), worst_step_ratio(gpu.opt.trace, cpu.opt.trace,
                                   {n: torch.zeros_like(t)
                                    for n, t in cpu.opt.trace.items()})
    log("[train] {} f32 B=2 step, card vs CPU: loss {} vs {}; worst leaf "
        "||diff||/||update||: params {:.3e} ({}), momentum {:.3e} ({})".format(
            cfg.net, [round(float(v), 6) for v in lb_gpu],
            [round(float(v), 6) for v in lb_cpu], *params, *momentum))
    if params[0] > STEP_TOL or momentum[0] > STEP_TOL:
        raise AssertionError("card and CPU train steps disagree")
    return 1


def phase_train_modes(weights, cfg, batch, per_step):
    """One f32 step of ``cfg.net`` at ``batch`` per filter-grad mode from
    the same state: K2's weight gradients against cuDNN's, and K2's
    launches per backward (``per_step``, by mode).  Returns the number of
    steps run."""
    import numpy as np
    import torch

    from squeezedet_torch.models import layers as L
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.trainer import make_train_step_device
    cfg = cfg.replace(keep_prob=1.0)
    rs = np.random.RandomState(100)
    u8 = torch.from_numpy(rs.randint(0, 256, (batch, cfg.image_height,
                                              cfg.image_width, 3),
                                     dtype=np.uint8)).cuda()
    gt = [t.cuda() for t in gt_batch(rs, batch, cfg)]
    after = {}
    for mode in (False, "1x1", True):
        L.set_filter_grad(mode)
        state = fresh_state(cfg, "cuda", weights)
        launches = fg.LAUNCHES
        make_train_step_device(state, uint8_ingest=True)(u8, *gt)
        torch.cuda.synchronize()
        launches = fg.LAUNCHES - launches
        log("[train] {} f32 B={} step, filter-grad mode {!r}: {} K2 "
            "launches".format(cfg.net, batch, mode, launches))
        if launches != per_step[mode]:
            raise AssertionError("K2 launches {} in mode {!r}, expected "
                                 "{}".format(launches, mode,
                                             per_step[mode]))
        after[mode] = state.det.backbone.state_dict()
        del state
    for mode in ("1x1", True):
        worst, leaf = worst_step_ratio(after[mode], after[False], weights)
        log("[train] {} mode {!r} vs False (cuDNN weight grads): worst leaf "
            "||diff||/||update|| {:.3e} ({})".format(cfg.net, mode, worst,
                                                     leaf))
        if worst > STEP_TOL:
            raise AssertionError("K2 and cuDNN train steps disagree")
    return 3


def phase_train_run(card, weights):
    """bf16 training with dropout and the on-device augment, B=20 and
    B=128, each filter-grad mode from the same weights, on one fixed
    canvas batch at lr 1e-3.  Returns (steps run, K2 launches expected)."""
    import numpy as np
    import torch

    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.models import layers as L
    from squeezedet_torch.trainer import make_train_step_device
    cfg = kitti_squeezedet_config().replace(compute_dtype="bfloat16",
                                            learning_rate=1e-3)
    h0, w0 = 375, 1242  # a KITTI frame; the canvas holds it whole
    steps = k2 = 0
    for batch in TRAIN_RUN_BATCHES:
        rs = np.random.RandomState(batch)
        canvas = torch.from_numpy(rs.randint(0, 256, (batch, h0, w0, 3),
                                             dtype=np.uint8)).cuda()
        dx = rs.randint(-cfg.drift_x, cfg.drift_x + 1, batch)
        dy = rs.randint(-cfg.drift_y, cfg.drift_y + 1, batch)
        aug = torch.from_numpy(np.stack(
            [dx, dy, rs.randint(0, 2, batch), w0 - dx, h0 - dy],
            axis=1).astype(np.float32)).cuda()
        gt = [t.cuda() for t in gt_batch(rs, batch, cfg)]
        for mode in (False, "1x1", True):
            L.set_filter_grad(mode)
            state = fresh_state(cfg, "cuda", weights)
            step = make_train_step_device(state, uint8_ingest=True,
                                          device_augment=True)
            gen = torch.Generator(device="cuda").manual_seed(0)
            losses = [step(canvas, aug, *gt, generator=gen)
                      for _ in range(WARMUP_STEPS)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(TIMED_STEPS):
                losses.append(step(canvas, aug, *gt, generator=gen))
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / TIMED_STEPS
            steps += WARMUP_STEPS + TIMED_STEPS
            k2 += (WARMUP_STEPS + TIMED_STEPS) * K2_PER_STEP[mode]
            totals = [float(lb.total) for lb in losses]
            log("[train] smoke reading, not a benchmark: bf16 B={} "
                "device_augment keep_prob {} mode {!r}: {:.3f} ms/step, "
                "{:.1f} img/s, peak {:.2f} GiB; loss {:.4f} -> {:.4f} over "
                "{} steps on one batch, on {}".format(
                    batch, cfg.keep_prob, mode, dt * 1e3, batch / dt,
                    torch.cuda.max_memory_allocated() / 2**30, totals[0],
                    totals[-1], len(totals), card))
            if not all(np.isfinite(totals)) or totals[-1] >= totals[0]:
                raise AssertionError("loss did not fall: {}".format(totals))
    return steps, k2


def png_decode_ms(root, indices, card):
    """The host's decode time per fixture frame, by the data layer's
    ``read_frame`` (OpenCV where it imports) and by ``data/png.py``, which
    must give the same pixels; and the frames' row-filter mix."""
    import numpy as np

    from squeezedet_torch.data import png
    from squeezedet_torch.data.imdb import _opencv, read_frame
    paths = [os.path.join(root, "training", "image_2", i + ".png")
             for i in indices]
    mix = np.bincount(np.concatenate([png.row_filters(p) for p in paths]),
                      minlength=5)
    t0 = time.perf_counter()
    frames = [read_frame(p) for p in paths]
    ms = {"read_frame": (time.perf_counter() - t0) * 1e3 / len(paths)}
    sample = paths[:LOOP_DECODE_SAMPLE]  # slow on Avg and Paeth rows
    t0 = time.perf_counter()
    for path, want in zip(sample, frames):
        if (png.imread_png(path) != want).any():
            raise AssertionError("{}: data/png.py and read_frame decode "
                                 "other pixels".format(path))
    ms["png.py"] = (time.perf_counter() - t0) * 1e3 / len(sample)
    log("[loop] PNG decode of a {}x{} frame on the host: read_frame ({}) "
        "{:.3f} ms/image over {} frames, data/png.py {:.3f} ms/image over "
        "{}; the frames' rows by filter none/Sub/Up/Avg/Paeth: {}; on the "
        "host of {}".format(
            frames[0].shape[1], frames[0].shape[0],
            "data/png.py" if _opencv() is None else "OpenCV", ms["read_frame"],
            len(paths), ms["png.py"], len(sample), mix.tolist(), card))
    return ms


def phase_train_loop(card):
    """The train CLI on the card: a 30-step run with checkpoints, a
    resume to step 40, and a --device_dataset run.  Returns the forwards
    and steps it ran, which the caller holds the launch counts to."""
    import contextlib
    import io
    import re
    import shutil

    import numpy as np
    import torch

    from squeezedet_torch import train as cli
    from squeezedet_torch import trainer
    from squeezedet_torch.data.imdb import Imdb, _opencv
    from squeezedet_torch.data.kitti import Kitti
    from squeezedet_torch.data.synth import write_kitti_fixture
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.summary import SummaryWriter

    work = os.path.join(HERE, ".chipscratch", "train_loop")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    t0 = time.perf_counter()
    indices = write_kitti_fixture(root, LOOP_IMAGES, LOOP_FRAME)
    log("[loop] fixture: {} PNGs of {}x{} in {:.1f} s".format(
        LOOP_IMAGES, LOOP_FRAME[1], LOOP_FRAME[0], time.perf_counter() - t0))
    decode_ms = png_decode_ms(root, indices, card)
    probe = SummaryWriter(os.path.join(work, "probe"))
    writer_on = probe.enabled
    probe.close()
    # the detection images of summary steps (one forward each) need cv2
    images_on = writer_on and _opencv() is not None

    # the step functions record when each step is called, and every
    # BatchPlan drawn is kept, to hold the resumed stream to a straight one
    calls, plans = [], []
    real_make, real_draw = trainer.make_train_step_device, \
        Imdb.draw_batch_plan

    def timed_make(*args, **kwargs):
        fn = real_make(*args, **kwargs)

        def step(*a, **k):
            calls.append(time.perf_counter())
            return fn(*a, **k)
        return step

    def recording_draw(self, shuffle=True):
        plan = real_draw(self, shuffle)
        plans.append(plan)
        return plan

    def run(name, train_dir, max_steps, *extra):
        calls.clear()
        plans.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches = ff.LAUNCHES, fg.LAUNCHES
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                state = cli.main(LOOP_ARGV + [
                    "--data_path", root, "--train_dir", train_dir,
                    "--max_steps", str(max_steps)] + list(extra))
        finally:
            log(buf.getvalue().rstrip())
        torch.cuda.synchronize()
        out = buf.getvalue()
        logged = {int(s): float(v) for s, v in re.findall(
            r"step (\d+), loss = (\S+) \(", out)}
        first = max_steps - len(calls)
        viz = sum(1 for s in range(first, max_steps)
                  if images_on and s % LOOP_EVERY == 0)
        k1, k2 = ff.LAUNCHES - launches[0], fg.LAUNCHES - launches[1]
        # the interval between step calls: each step's upload waits for
        # the step before it, so this is the loop's rate
        timed = np.asarray(calls[LOOP_TIMED_FROM:])
        gaps = np.diff(timed) * 1e3
        batch = state.det.cfg.batch_size
        log("[loop] smoke reading, not a benchmark: {} (train CLI, B={} "
            "{}x{} {}{}): steps {}..{}, {:.3f} ms/step (median interval "
            "{:.3f}), {:.1f} img/s over the last {} step intervals, peak "
            "{:.2f} GiB; logged loss {}; K1 {} launches for {} forwards, K2 "
            "{} for {} steps; summary writer enabled: {}, detection images: "
            "{}; on {}".format(
                name, batch, state.det.cfg.image_width,
                state.det.cfg.image_height, state.det.cfg.compute_dtype,
                "".join(" " + e for e in extra), first, max_steps - 1,
                gaps.mean(), float(np.median(gaps)),
                batch * 1e3 / gaps.mean(), len(gaps),
                torch.cuda.max_memory_allocated() / 2**30,
                json.dumps(logged), k1, len(calls) + viz, k2, len(calls),
                writer_on, images_on, card))
        if state.step != max_steps:
            raise AssertionError("{} ended at step {}".format(name,
                                                              state.step))
        if not logged or not all(np.isfinite(v) for v in logged.values()):
            raise AssertionError("{}: logged loss {}".format(name, logged))
        if k1 != len(calls) + viz or \
                k2 != K2_PER_STEP["1x1"] * len(calls):
            raise AssertionError(
                "{}: K1 launches {} for {} forwards, K2 launches {} for {} "
                "steps".format(name, k1, len(calls) + viz, k2, len(calls)))
        kept = sorted(n for n in os.listdir(train_dir)
                      if n.startswith(("model.ckpt", "sampler.ckpt")))
        return (out, logged, kept, len(calls) + viz,
                sorted(plans, key=lambda p: p.seq))

    def names(steps):
        return sorted(["model.ckpt-{}".format(s) for s in steps] +
                      ["sampler.ckpt-{}.npz".format(s) for s in steps])

    def newest(first, stop):
        return [s for s in range(first, stop)
                if s % LOOP_EVERY == 0 or s == stop - 1][-LOOP_KEEP:]

    trainer.make_train_step_device = timed_make
    Imdb.draw_batch_plan = recording_draw
    try:
        straight_dir = os.path.join(work, "train")
        _, logged, kept, forwards, _ = run("run", straight_dir, LOOP_STEPS)
        steps = LOOP_STEPS
        if logged[max(logged)] >= logged[0]:
            raise AssertionError("loss did not fall: {}".format(logged))
        if kept != names(newest(0, LOOP_STEPS)):
            raise AssertionError("kept {}, expected {}".format(
                kept, names(newest(0, LOOP_STEPS))))

        out, logged, kept, n, resumed = run("resume", straight_dir,
                                            LOOP_RESUME_TO)
        steps, forwards = steps + LOOP_RESUME_TO - LOOP_STEPS, forwards + n
        if "Resumed from step {}".format(LOOP_STEPS) not in out or \
                min(logged) != LOOP_STEPS:
            raise AssertionError("the resume did not start at step "
                                 "{}".format(LOOP_STEPS))
        if kept != names(newest(LOOP_STEPS, LOOP_RESUME_TO)):
            raise AssertionError("kept {}, expected {}".format(
                kept, names(newest(LOOP_STEPS, LOOP_RESUME_TO))))
        cfg = cli.config_from_args(cli.build_arg_parser().parse_args(
            LOOP_ARGV))
        ref = Kitti("train", root, cfg, rng=np.random.RandomState(0))
        straight = [real_draw(ref) for _ in range(LOOP_RESUME_TO)]
        for i, (got, want) in enumerate(zip(
                resumed[:LOOP_RESUME_TO - LOOP_STEPS],
                straight[LOOP_STEPS:])):
            if got.batch_idx != want.batch_idx or \
                    got.augment != want.augment:
                raise AssertionError("resumed step {} drew {}, a straight "
                                     "run {}".format(LOOP_STEPS + i,
                                                     got.batch_idx,
                                                     want.batch_idx))
        log("[loop] the resume drew the images and augment draws of a "
            "straight run's steps {}..{}".format(LOOP_STEPS,
                                                 LOOP_RESUME_TO - 1))

        out, _, _, n, _ = run("device_dataset", os.path.join(work, "dataset"),
                              LOOP_DATASET_STEPS, "--device_dataset")
        steps, forwards = steps + LOOP_DATASET_STEPS, forwards + n
        if "Device-resident dataset: {} images".format(LOOP_IMAGES) \
                not in out:
            raise AssertionError("--device_dataset did not upload the "
                                 "split")
    finally:
        trainer.make_train_step_device = real_make
        Imdb.draw_batch_plan = real_draw
        shutil.rmtree(work, ignore_errors=True)
    return {"steps": steps, "forwards": forwards, "decode_ms": decode_ms,
            "writer": writer_on}


def _logged(fn, *args):
    """Run ``fn(*args)`` with its standard output captured; log it and
    return (result, output)."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = fn(*args)
    finally:
        log(buf.getvalue().rstrip())
    return result, buf.getvalue()


def _gt_detections(db, jitter=0.0, seed=0):
    """The split's GT boxes as all_boxes rows: score 1 and exact corners;
    or, with seeded noise of ``jitter`` times each box's size, seeded
    scores, a sixth of the boxes missed and one background box an image,
    so that the precision/recall curve is not flat."""
    import numpy as np
    rs = np.random.RandomState(seed)
    boxes = [[[] for _ in db.image_idx] for _ in range(db.num_classes)]
    for i, idx in enumerate(db.image_idx):
        for cx, cy, w, h, c in db._rois[idx]:
            if jitter and rs.rand() < 1 / 6:
                continue
            j = rs.randn(4) * jitter * np.array([w, h, w, h])
            score = float(rs.uniform(0.05, 0.99)) if jitter else 1.0
            boxes[int(c)][i].append([cx - w / 2 + j[0], cy - h / 2 + j[1],
                                     cx + w / 2 - 1 + j[2],
                                     cy + h / 2 - 1 + j[3], score])
        if jitter:
            x, y = rs.uniform(0, 900), rs.uniform(0, 200)
            boxes[rs.randint(db.num_classes)][i].append(
                [x, y, x + 150.0, y + 120.0, float(rs.uniform(0.05, 0.99))])
    return boxes


def compare_scorers(root, data_dir, work, name):
    """Score the det files of ``data_dir`` with the native evaluator and
    with data/kitti_ap.py; their stats files must agree."""
    import shutil

    import numpy as np

    from squeezedet_torch import native
    from squeezedet_torch.data import kitti_ap
    binary = native.build_kitti_eval()
    image_set = os.path.join(root, "ImageSets", "val.txt")
    res = {}
    for scorer in ("native", "python"):
        res[scorer] = os.path.join(work, "{}_{}".format(name, scorer))
        shutil.copytree(data_dir, os.path.join(res[scorer], "data"))
    subprocess.run([binary, os.path.join(root, "training"), image_set,
                    res["native"], str(EVAL_IMAGES)], check=True,
                   capture_output=True, timeout=120)
    kitti_ap.evaluate(res["python"], image_set,
                      os.path.join(root, "training", "label_2"), EVAL_IMAGES)
    aps = {}
    for cls in kitti_ap.CLASS_NAMES:
        path = {s: os.path.join(r, "stats_{}_ap.txt".format(cls))
                for s, r in res.items()}
        if os.path.exists(path["native"]) != os.path.exists(path["python"]):
            raise AssertionError("{}: only one scorer wrote {}".format(
                name, path["native"]))
        if not os.path.exists(path["native"]):
            continue
        got = [[float(line.split("=")[1]) for line in open(p)]
               for p in (path["native"], path["python"])]
        np.testing.assert_allclose(got[0], got[1], rtol=SCORER_AP_RTOL,
                                   err_msg="{} {}".format(name, cls))
        for rel in ("stats_{}_detection.txt".format(cls),
                    os.path.join("plot", "{}_detection.txt".format(cls))):
            np.testing.assert_allclose(
                np.loadtxt(os.path.join(res["native"], rel)),
                np.loadtxt(os.path.join(res["python"], rel)),
                atol=SCORER_ROW_ATOL, err_msg="{} {}".format(name, rel))
        aps[cls] = got[0]
    if not aps:
        raise AssertionError("{}: no stats file to compare".format(name))
    log("[eval] {}: the native and Python scorers agree: APs {}".format(
        name, json.dumps(aps)))


def _write_video(path, frames):
    """An MJPG video of 1920x1080 frames, each holding a fixture frame
    where the demo's crop [500:-205, 239:-439] takes it."""
    import cv2
    import numpy as np
    h, w = VIDEO_FRAME
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (w, h))
    if not writer.isOpened():
        raise AssertionError("cv2 cannot write an MJPG video")
    rs = np.random.RandomState(0)
    for frame in frames:
        big = rs.randint(0, 60, (h, w, 3)).astype(np.uint8)
        big[500:h - 205, 239:w - 439] = frame
        writer.write(big)
    writer.release()


def phase_eval_demo(card):
    """Phase 8: the eval CLI and the demo on the card from one port
    checkpoint.  Returns the forwards it ran on the card."""
    import re
    import shutil

    import numpy as np
    import torch

    from squeezedet_torch import demo
    from squeezedet_torch import eval as eval_cli
    from squeezedet_torch.checkpoint.manager import CheckpointManager
    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.data.imdb import read_frame
    from squeezedet_torch.data.kitti import NATIVE, Kitti
    from squeezedet_torch.data.synth import write_kitti_fixture
    from squeezedet_torch.models import Detector, get_model

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # f32 convs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.join(HERE, ".chipscratch", "eval_demo")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    indices = write_kitti_fixture(root, EVAL_IMAGES, LOOP_FRAME, seed=1,
                                  image_set="val", boxes=EVAL_BOXES)
    cfg = kitti_squeezedet_config()
    # seeded weights with the head rescaled as in the serving phase, made
    # on the CPU (no launch), saved as a port checkpoint
    cpu = get_model("squeezeDet", cfg, device="cpu")
    with torch.no_grad():
        u8 = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (1, cfg.image_height, cfg.image_width, 3), np.uint8))
        spread = cpu.predict_raw(u8).pred_box_delta.std().item()
        cpu.backbone.conv12.weight.mul_(HEAD_SPREAD / spread)
    ckpt_dir = os.path.join(work, "train")
    CheckpointManager(ckpt_dir).save(EVAL_STEP,
                                     {"params": cpu.backbone.state_dict()})
    log("[eval] fixture: {} PNGs of {}x{} and a checkpoint in {:.1f} "
        "s".format(EVAL_IMAGES, LOOP_FRAME[1], LOOP_FRAME[0],
                   time.perf_counter() - t_phase))

    # (a) the scorer: the ground truth as detections scores AP 1 with the
    # native evaluator; the two scorers agree on jittered detections
    db = Kitti("val", root, cfg)
    gt = _gt_detections(db)
    n_gt = [sum(len(rows) for rows in per_class) for per_class in gt]
    if min(n_gt) < FULL_AP_GT:
        raise AssertionError("GT per class {}: fewer than {}".format(
            n_gt, FULL_AP_GT))
    t0 = time.perf_counter()
    (aps, _), _ = _logged(db.evaluate_detections,
                          os.path.join(work, "gt_eval"), 0, gt)
    if db.scorer_used != NATIVE or aps != [1.0] * 9:
        raise AssertionError("GT as detections: scorer {}, APs {}".format(
            db.scorer_used, aps))
    log("[eval] GT as detections ({} per class): the {} scorer gives AP 1.0 "
        "at all 9 class x difficulty points in {:.3f} s, its build "
        "included".format(n_gt, db.scorer_used, time.perf_counter() - t0))
    jittered = os.path.join(work, "jittered", "data")
    db.write_detection_files(jittered, _gt_detections(db, 0.08, seed=1))
    compare_scorers(root, jittered, work, "jittered GT")

    # (b) the eval CLI on the card, once per mode; each run's detections
    # and APs are recorded, and the f32 B=1 run's first two raw forwards
    real_detect_all, real_eval = eval_cli.detect_all, eval_cli.eval_checkpoint
    real_forward = Detector.forward
    runs, raw = {}, []

    def recording_detect_all(*a, **k):
        runs[mode]["detect"] = real_detect_all(*a, **k)
        return runs[mode]["detect"]

    def recording_eval(*a, **k):
        runs[mode]["aps"] = real_eval(*a, **k)
        return runs[mode]["aps"]

    def recording_forward(self, images, **k):
        out = real_forward(self, images, **k)
        if mode == EVAL_MODES[0][0] and len(raw) < 2:
            raw.append((images.detach().cpu(), out.detach().cpu()))
        return out

    eval_cli.detect_all, eval_cli.eval_checkpoint = (recording_detect_all,
                                                     recording_eval)
    Detector.forward = recording_forward
    try:
        for mode, extra in EVAL_MODES:
            runs[mode] = {"dir": os.path.join(work, "eval_{}".format(
                len(runs)))}
            t0 = time.perf_counter()
            _logged(eval_cli.main, [
                "--device", "cuda", "--data_path", root, "--image_set",
                "val", "--checkpoint_path", ckpt_dir, "--eval_dir",
                runs[mode]["dir"], "--run_once"] + extra)
            runs[mode]["s"] = time.perf_counter() - t0
    finally:
        eval_cli.detect_all, eval_cli.eval_checkpoint = (real_detect_all,
                                                         real_eval)
        Detector.forward = real_forward

    forwards = 0
    for mode, _ in EVAL_MODES:
        all_boxes, n_det, timers = runs[mode]["detect"]
        aps, names, mAP = runs[mode]["aps"]
        forwards += timers["im_detect"].calls
        data = os.path.join(runs[mode]["dir"], "detection_files_{}".format(
            EVAL_STEP), "data")
        if sorted(os.listdir(data)) != [i + ".txt" for i in indices] or \
                len(aps) != 9 or not np.isfinite(aps).all():
            raise AssertionError("{}: det files {}, APs {}".format(
                mode, len(os.listdir(data)), aps))
        per = {k: t.total_time * 1e3 / EVAL_IMAGES for k, t in timers.items()}
        log("[eval] smoke reading, not a benchmark: {} at {}x{}: im_read "
            "{:.3f}, im_detect {:.3f}, misc {:.3f} ms/image over {} images "
            "in {} batches; {:.2f} detections/image; mAP {:.6f}; {:.1f} s "
            "for the CLI run; on {}".format(
                mode, cfg.image_width, cfg.image_height, per["im_read"],
                per["im_detect"], per["misc"], EVAL_IMAGES,
                timers["im_detect"].calls, n_det / EVAL_IMAGES, mAP,
                runs[mode]["s"], card))

    host, dev = (runs[m]["detect"][0] for m, _ in EVAL_MODES[:2])
    for c in range(db.num_classes):
        for i in range(EVAL_IMAGES):
            a = np.asarray(sorted(map(tuple, host[c][i])))
            b = np.asarray(sorted(map(tuple, dev[c][i])))
            if a.shape != b.shape:
                raise AssertionError("class {} image {}: {} detections on "
                                     "the host path, {} on the device "
                                     "path".format(c, i, len(a), len(b)))
            if a.size:
                np.testing.assert_allclose(b, a, rtol=EVAL_BOX_RTOL,
                                           atol=EVAL_BOX_ATOL)
    if runs[EVAL_MODES[0][0]]["aps"][0] != runs[EVAL_MODES[1][0]]["aps"][0]:
        raise AssertionError("the f32 modes' APs differ")
    log("[eval] the f32 host and device postprocess runs give the same "
        "detections image by image and the same APs")
    if len(raw) != 2:
        raise AssertionError("{} raw forwards recorded".format(len(raw)))
    with torch.inference_mode():
        for images, preds in raw:
            torch.testing.assert_close(preds, cpu(images), rtol=PRED_RTOL,
                                       atol=PRED_ATOL)
    log("[eval] the first two frames' raw predictions of the f32 B=1 run "
        "match the CPU's")
    compare_scorers(root, os.path.join(
        runs[EVAL_MODES[0][0]]["dir"], "detection_files_{}".format(
            EVAL_STEP), "data"), work, "model detections")

    # (c) the demo, in image and video mode
    demo_argv = ["--device", "cuda", "--checkpoint", ckpt_dir]
    out_img = os.path.join(work, "demo_images")
    _logged(demo.main, demo_argv + [
        "--input_path", os.path.join(root, "training", "image_2",
                                     "00000[0-{}].png".format(
                                         DEMO_IMAGES - 1)),
        "--out_dir", out_img])
    if len(os.listdir(out_img)) != DEMO_IMAGES:
        raise AssertionError("image demo wrote {}".format(
            os.listdir(out_img)))
    video = os.path.join(work, "drive.avi")
    _write_video(video, [read_frame(os.path.join(
        root, "training", "image_2", idx + ".png"))
        for idx in indices[:DEMO_VIDEO_FRAMES]])
    out_vid = os.path.join(work, "demo_video")
    _, out = _logged(demo.main, demo_argv + [
        "--mode", "video", "--input_path", video, "--out_dir", out_vid])
    frames = sorted(os.listdir(out_vid))
    times = np.asarray(re.findall(
        r"Total time: (\S+), detection time: (\S+), filter time: (\S+)",
        out), np.float64) * 1e3
    if len(frames) != DEMO_VIDEO_FRAMES or len(times) != DEMO_VIDEO_FRAMES:
        raise AssertionError("video demo: {} frames written, {} timed".format(
            len(frames), len(times)))
    shape = read_frame(os.path.join(out_vid, frames[0])).shape
    if shape != LOOP_FRAME + (3,):
        raise AssertionError("video demo frame {}".format(shape))
    forwards += DEMO_IMAGES + DEMO_VIDEO_FRAMES
    log("[demo] smoke reading, not a benchmark: video mode, {} cropped "
        "{}x{} frames, f32: per frame total {}, detect {}, filter {} ms "
        "(median {:.3f} / {:.3f} / {:.3f} over frames 2..); on {}".format(
            DEMO_VIDEO_FRAMES, shape[1], shape[0],
            *(json.dumps([round(float(t), 3) for t in col])
              for col in times.T), *np.median(times[1:], axis=0), card))
    log("[eval] phase 8 took {:.1f} s".format(time.perf_counter() - t_phase))
    # phase 10 takes the fixture and the checkpoint, then removes them
    return forwards, cpu.backbone.state_dict()


def probe_eval_shapes(card, weights):
    """After phase 8, outside its counted window: K1 at the shapes of the
    eval and demo forwards beside its plain version and bound, and the
    f32 B=1 eval forward's host time (forward, copy of the outputs to the
    host) against its kernels' device time (torch.profiler)."""
    import numpy as np
    import torch

    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.models import get_model
    from squeezedet_torch.ops import fused_frontend as ff
    with torch.inference_mode():
        for b, h, w, dtype, what in (
                (1, 384, 1248, torch.float32, "eval f32 B=1"),
                (8, 384, 1248, torch.bfloat16, "eval bf16 B=8"),
                (1, 375, 1242, torch.float32, "video demo f32")):
            x, k, bias = k1_inputs(b, h, w, dtype, 5)
            fns = {"kernel": lambda: ff.conv1_pool1(x, k, bias),
                   "plain": lambda: ff.conv1_pool1_reference(x, k, bias)}
            runs = {"kernel": [], "plain": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                runs[name].append(cuda_ms(fns[name], iters=20))
            ms = {n: sum(v) / len(v) for n, v in runs.items()}
            bound_ms, bound_by = k1_bound(b, h, w, dtype == torch.float32)
            log("[eval] K1 at the {} shape, {}x{}x{} {}: kernel {:.4f} ms, "
                "plain {:.4f} ms, bound {:.4f} ms ({}); on {}".format(
                    what, b, h, w, str(dtype).replace("torch.", ""),
                    ms["kernel"], ms["plain"], bound_ms, bound_by, card))

    cfg = kitti_squeezedet_config()
    det = get_model("squeezeDet", cfg, device="cuda")
    det.backbone.load_state_dict(weights)
    x = torch.from_numpy(np.random.RandomState(6).randn(
        1, cfg.image_height, cfg.image_width, 3).astype(np.float32) * 40)
    x = x.cuda()

    def forward():  # eval's im_detect span at B=1 on the host path
        interp = det.predict(x)
        return [o.cpu() for o in (interp.det_boxes, interp.det_probs,
                                  interp.det_class)]

    iters = 20
    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        forward()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            forward()
        torch.cuda.synchronize()
    device_ms = sum(ev.time_range.elapsed_us() for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    ) / 1e3 / iters
    log("[eval] f32 B=1 eval forward and copy to the host at 1248x384: "
        "{:.3f} ms on the host clock, {} of device time in kernels and "
        "copies (torch.profiler): device busy {}; on {}".format(
            wall, "{:.3f} ms".format(device_ms) if device_ms else
            "not measured (no device events)",
            "{:.1f} %".format(100 * device_ms / wall) if device_ms else
            "not measured", card))


def phase_k2_backbones(card):
    """K2 against its plain version at every conv shape the other
    backbones route to it (f32 with TF32 off, and bf16; two launches
    bitwise equal), then K2 and cuDNN's weight gradient timed in bf16
    beside the bound.  Outside the counted windows.  Returns (max abs
    err, per-shape rows)."""
    import torch

    from squeezedet_torch.config import config_for_net
    gen = torch.Generator(device="cuda").manual_seed(9)
    max_err, rows = 0.0, []
    for net in BACKBONES:
        batch = config_for_net(net).batch_size
        for dtype in (torch.float32, torch.bfloat16):
            for _, kh, c, o, h, w in K2_BACKBONE_SHAPES[net]:
                max_err = max(max_err, check_k2(batch, kh, kh, h, w, c, o,
                                                dtype, gen))
        _, net_rows = time_k2(card, batch, torch.bfloat16, gen, False,
                              K2_BACKBONE_SHAPES[net], net)
        rows += [dict(r, net=net) for r in net_rows]
        torch.cuda.empty_cache()
    return max_err, rows


def _recorded(module, name, sink):
    """Patch ``module.name`` with a wrapper that appends each result to
    ``sink``; returns the original, for the caller to restore."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        sink.append(real(*a, **k))
        return sink[-1]
    setattr(module, name, wrapper)
    return real


def backbone_clis(net, root, work, card):
    """The train CLI on ``net`` (bf16, config batch and resolution,
    --device_assign --uint8_ingest --device_augment --pallas_grads),
    then the eval CLI on its checkpoint, then (squeezeDet+) the demo.
    Returns the train steps run."""
    import re

    import numpy as np

    from squeezedet_torch import demo
    from squeezedet_torch import eval as eval_cli
    from squeezedet_torch import train as cli
    from squeezedet_torch.config import config_for_net
    cfg = config_for_net(net)
    train_dir = os.path.join(work, net + "_train")
    t0 = time.perf_counter()
    state, out = _logged(cli.main, [
        "--net", net, "--device", "cuda", "--data_path", root, "--train_dir",
        train_dir, "--batch_size", str(cfg.batch_size), "--compute_dtype",
        "bfloat16", "--learning_rate", "0.001", "--device_assign",
        "--uint8_ingest", "--device_augment", "--pallas_grads",
        "--max_steps", str(BACKBONE_CLI_STEPS), "--checkpoint_step", "1000",
        "--summary_step", "0"])
    seconds = time.perf_counter() - t0
    logged = [float(v) for v in re.findall(r"loss = (\S+) \(", out)]
    ckpt = "model.ckpt-{}".format(BACKBONE_CLI_STEPS - 1)
    if state.step != BACKBONE_CLI_STEPS or not logged or \
            not np.isfinite(logged).all() or \
            ckpt not in os.listdir(train_dir):
        raise AssertionError("{} train CLI: step {}, logged loss {}, "
                             "files {}".format(net, state.step, logged,
                                               os.listdir(train_dir)))
    del state
    log("[backbones] {} train CLI: {} bf16 steps at B={} {}x{} in {:.1f} s "
        "(the run, its start-up included); logged loss {}; {} written; on "
        "{}".format(net, BACKBONE_CLI_STEPS, cfg.batch_size, cfg.image_width,
                    cfg.image_height, seconds, logged, ckpt, card))

    aps = []  # eval_checkpoint's (APs, names, mAP)
    real = _recorded(eval_cli, "eval_checkpoint", aps)
    eval_dir = os.path.join(work, net + "_eval")
    t0 = time.perf_counter()
    try:
        _logged(eval_cli.main, [
            "--net", net, "--device", "cuda", "--data_path", root,
            "--image_set", "train", "--checkpoint_path", train_dir,
            "--eval_dir", eval_dir, "--run_once", "--eval_batch_size", "8"])
    finally:
        eval_cli.eval_checkpoint = real
    data = os.path.join(eval_dir, "detection_files_{}".format(
        BACKBONE_CLI_STEPS - 1), "data")
    if len(aps) != 1 or len(aps[0][0]) != 9 or \
            not np.isfinite(aps[0][0]).all() or \
            len(os.listdir(data)) != BACKBONE_IMAGES:
        raise AssertionError("{} eval CLI: APs {}, {} det files".format(
            net, aps, len(os.listdir(data))))
    log("[backbones] {} eval CLI: {} images scored in {:.1f} s, f32 B=8, "
        "finite APs, mAP {:.6f}".format(net, BACKBONE_IMAGES,
                                        time.perf_counter() - t0,
                                        aps[0][2]))
    if net == "squeezeDet+":
        out_dir = os.path.join(work, "demo")
        _logged(demo.main, [
            "--demo_net", net, "--device", "cuda", "--checkpoint", train_dir,
            "--input_path", os.path.join(root, "training", "image_2",
                                         "00000[0-{}].png".format(
                                             BACKBONE_DEMO_FRAMES - 1)),
            "--out_dir", out_dir])
        if len(os.listdir(out_dir)) != BACKBONE_DEMO_FRAMES:
            raise AssertionError("demo wrote {}".format(os.listdir(out_dir)))
        log("[backbones] demo --demo_net squeezeDet+: {} frames "
            "drawn".format(BACKBONE_DEMO_FRAMES))
    return BACKBONE_CLI_STEPS


def phase_backbones(card):
    """Phase 9: squeezeDet+, VGG16 and ResNet50 at their published
    configurations with seeded weights: serving (f32 card against CPU,
    then a bf16 reading at the config batch), the f32 train step (card
    against CPU in mode True, then one step per filter-grad mode), and
    the train, eval and demo CLIs.  Returns the K2 launches the path
    must have made."""
    import shutil

    import numpy as np
    import torch

    from squeezedet_torch.config import config_for_net
    from squeezedet_torch.data.synth import write_kitti_fixture
    from squeezedet_torch.models import get_model
    from squeezedet_torch.models import layers as L
    t_phase = time.perf_counter()
    work = os.path.join(HERE, ".chipscratch", "backbones")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    write_kitti_fixture(root, BACKBONE_IMAGES, LOOP_FRAME, seed=3)
    k2 = 0
    try:
        for net in BACKBONES:
            t_net = time.perf_counter()
            cfg = config_for_net(net)
            serve_cfg = cfg.replace(batch_size=1 if net == "vgg16" else 2)
            u8 = torch.from_numpy(np.random.RandomState(0).randint(
                0, 256, (serve_cfg.batch_size, cfg.image_height,
                         cfg.image_width, 3), dtype=np.uint8))
            det = rescaled_detector(net, serve_cfg, u8)
            serving_check(det, "backbones", BACKBONE_BOX_RTOL)
            det16 = get_model(net, cfg.replace(compute_dtype="bfloat16"),
                              device="cuda")
            det16.load_state_dict(det.state_dict())
            serving_reading(det16, cfg.batch_size, 2, 5, card, "backbones")
            del det, det16

            weights = get_model(net, cfg, device="cpu").backbone.state_dict()
            per_step = {False: 0, "1x1": 0, True: sum(
                s[0] for s in K2_BACKBONE_SHAPES[net])}
            phase_train_check(weights, cfg)
            phase_train_modes(weights, cfg, BACKBONE_MODE_BATCH, per_step)
            L.set_filter_grad(False)
            k2 += 2 * per_step[True]
            torch.cuda.empty_cache()
            backbone_clis(net, root, work, card)
            torch.cuda.empty_cache()
            log("[backbones] {} took {:.1f} s".format(
                net, time.perf_counter() - t_net))
    finally:
        L.set_filter_grad(False)
        shutil.rmtree(work, ignore_errors=True)
    log("[backbones] phase 9 took {:.1f} s".format(
        time.perf_counter() - t_phase))
    return k2


def int8_card_vs_cpu(det, calib, tag, start=""):
    """Calibrate ``det`` (on the card) on the uint8 batches ``calib`` and
    quantize it; build the int8 detector of the same scales on the CPU,
    which must hold the same tree; then hold the card's int8 activation
    tape and raw preds at B=INT8_CHECK_BATCH to the CPU's, bit for bit.
    ResNet50 keeps a float conv1 before its int8 blocks: the card's and
    the CPU's f32 convs differ in their last bits, which the int8
    boundary would turn into whole-step flips, so its conv1 is held to
    PRED_RTOL/PRED_ATOL and the CPU's int8 blocks take the card's conv1
    output.  Returns the card's int8 detector and its scales."""
    import numpy as np
    import torch

    from squeezedet_torch import quant
    from squeezedet_torch.models import get_model
    from squeezedet_torch.models import layers as L
    t0 = time.perf_counter()
    scales = quant.calibrate(det, calib)
    qdet = quant.quantize_detector(det, scales, start=start)
    cpu = get_model(det.net, det.cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    qcpu = quant.quantize_detector(cpu, scales, start=start)
    qstate = qdet.state_dict()
    for k, v in qcpu.state_dict().items():
        if not torch.equal(v, qstate[k].cpu()):
            raise AssertionError("{} int8 {}: the CPU's tree differs at "
                                 "{}".format(tag, det.net, k))
    cfg = det.cfg
    u8 = torch.from_numpy(np.random.RandomState(11).randint(
        0, 256, (INT8_CHECK_BATCH, cfg.image_height, cfg.image_width, 3),
        dtype=np.uint8))
    tape_card, tape_cpu = {}, {}
    with torch.inference_mode():
        qdet.backbone(qdet.quant_input(u8.cuda()), tape=tape_card)
    float_conv1 = isinstance(getattr(qcpu.backbone, "conv1", None),
                             L.ConvBN)
    real = L.conv_bn
    if float_conv1:
        with torch.inference_mode():
            own = real(qcpu.backbone.conv1, qcpu.quant_input(u8), 2,
                       eps=cfg.batch_norm_epsilon)
        torch.testing.assert_close(tape_card["conv1"].cpu(), own,
                                   rtol=PRED_RTOL, atol=PRED_ATOL)

        def card_conv1(layer, x, *a, **k):
            if layer is qcpu.backbone.conv1:
                return tape_card["conv1"].cpu()
            return real(layer, x, *a, **k)
        L.conv_bn = card_conv1
    try:
        with torch.inference_mode():
            qcpu.backbone(qcpu.quant_input(u8), tape=tape_cpu)
    finally:
        L.conv_bn = real
    bad = [k for k in tape_cpu if not torch.equal(tape_card[k].cpu(),
                                                  tape_cpu[k])]
    if bad:
        raise AssertionError("{} int8 {}: {} differ from the CPU's".format(
            tag, det.net, bad))
    log("[int8] {} {} int8 (start {}) B={} at {}x{}: calibrated on {} uint8 "
        "batches; all {} taped activations (int8, and the f32 head) equal "
        "the CPU's bit for bit{}; {:.1f} s".format(
            tag, det.net, start or quant.DEFAULT_START[det.net],
            INT8_CHECK_BATCH, cfg.image_height, cfg.image_width, len(calib),
            len(tape_cpu), ", the float conv1 within the f32 tolerance and "
            "the int8 blocks fed the card's conv1" if float_conv1 else "",
            time.perf_counter() - t0))
    return qdet, scales


def int8_reading(qdet, det16, card):
    """uint8 -> detections at B=INT8_BIG_BATCH, int8 and bf16 in turns
    (int8, bf16, bf16, int8) on the host clock over synchronised batches,
    with the int8 program's peak memory; a smoke reading.  Returns the
    bf16 forwards run (each launches K1)."""
    import numpy as np
    import torch
    cfg = qdet.cfg
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (INT8_BIG_BATCH, cfg.image_height, cfg.image_width, 3),
        dtype=np.uint8)).cuda()
    runs = {"int8": qdet.predict_quant_postprocessed,
            "bf16": det16.predict_raw_postprocessed}
    ms, peak, bf16_forwards = {"int8": [], "bf16": []}, 0.0, 0
    for name in ("int8", "bf16", "bf16", "int8"):
        fn = runs[name]
        fn(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn(x)
        kept = int(out[3].sum().item())
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / 3 * 1e3)
        if name == "int8":
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
        else:
            bf16_forwards += 4
        if out[0].shape != (INT8_BIG_BATCH, 64, 4) or \
                not torch.isfinite(out[1]).all():
            raise AssertionError("bad {} outputs".format(name))
    log("[int8] smoke reading, not a benchmark: squeezeDet uint8->detections "
        "B={} {}x{}: int8 {} ms/batch, bf16 {} ms/batch (two turns each, 3 "
        "batches a turn); int8 peak {:.2f} GiB; {} kept; on {}".format(
            INT8_BIG_BATCH, cfg.image_height, cfg.image_width,
            json.dumps([round(t, 3) for t in ms["int8"]]),
            json.dumps([round(t, 3) for t in ms["bf16"]]), peak, kept, card))
    return bf16_forwards


def one_frame_latency(det, x1, out_dir, card):
    """A B=1 bf16 artifact of ``det`` (a serving camera's one frame):
    equal to the direct program, and both timed by CUDA events over
    synchronised calls (host-bound at B=1).  Returns its K1 launches."""
    import torch

    from squeezedet_torch.serving import export_model, load_exported
    export_model(det, out_dir, batch_size=1)
    fn, _ = load_exported(out_dir)
    program = det.predict_raw_postprocessed
    if not all(torch.equal(g, w) for g, w in zip(fn(x1), program(x1))):
        raise AssertionError("B=1 artifact differs from the direct program")
    ms, ms_direct = [], []
    for _ in range(2):  # in turns
        ms.append(cuda_ms(lambda: fn(x1), 20))
        ms_direct.append(cuda_ms(lambda: program(x1), 20))
    log("[export] bf16 artifact B=1: equal to the direct program bit for "
        "bit; smoke reading {} ms a frame (direct {}) by CUDA events, two "
        "turns of 20 calls; on {}".format(
            json.dumps([round(t, 3) for t in ms]),
            json.dumps([round(t, 3) for t in ms_direct]), card))
    return 2 + 4 * 22


def export_and_serve(ckpt_dir, calib_glob, work, card):
    """``squeezedet_torch.export.main`` at B=EXPORT_BATCH, bf16 and int8,
    on cuda; each reloaded artifact against the direct program of the
    same checkpoint (and calibration frames), bit for bit, with K1's
    launches per artifact call; then the server on the bf16 artifact.
    Returns the K1 launches it expects."""
    import numpy as np
    import torch

    from squeezedet_torch import export, serve
    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.demo import load_params
    from squeezedet_torch.models import get_model
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.quant import calib_batch_from_images
    from squeezedet_torch.serving import load_exported
    cfg = kitti_squeezedet_config().replace(batch_size=EXPORT_BATCH,
                                            compute_dtype="bfloat16")
    direct = load_params(get_model("squeezeDet", cfg, device="cuda"),
                         ckpt_dir)
    x = torch.from_numpy(np.random.RandomState(12).randint(
        0, 256, (EXPORT_BATCH, cfg.image_height, cfg.image_width, 3),
        dtype=np.uint8)).cuda()
    k1, arts = 0, {}
    for name, extra in (("bf16", []), ("int8", ["--quantize", "int8",
                                                "--calib_images",
                                                calib_glob])):
        out_dir = os.path.join(work, "artifact_" + name)
        t0 = time.perf_counter()
        _logged(export.main, ["--device", "cuda", "--checkpoint", ckpt_dir,
                              "--out_dir", out_dir, "--batch_size",
                              str(EXPORT_BATCH)] + extra)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn, meta = load_exported(out_dir)
        t_load = time.perf_counter() - t0
        if name == "int8":
            model = direct.quantize([calib_batch_from_images(
                calib_glob, cfg.image_width, cfg.image_height)])
            program = model.predict_quant_postprocessed
        else:
            program = direct.predict_raw_postprocessed
        before = ff.LAUNCHES
        got = fn(x)
        per_call = ff.LAUNCHES - before
        want = program(x)
        k1 += per_call + (name == "bf16")
        if per_call != (1 if name == "bf16" else 0):
            raise AssertionError("{} artifact: {} K1 launches a call".format(
                name, per_call))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("{} artifact differs from the direct "
                                 "program".format(name))
        ms = cuda_ms(lambda: fn(x), 5)
        ms_direct = cuda_ms(lambda: program(x), 5)
        if name == "bf16":
            k1 += 14  # 7 timed calls of each
            k1 += one_frame_latency(direct, x[:1].contiguous(),
                                    os.path.join(work, "artifact_b1"),
                                    card)
        arts[name] = out_dir
        log("[export] {} artifact B={}: exported in {:.1f} s ({:.1f} MB), "
            "reloaded in {:.1f} s; equal to the direct program bit for bit; "
            "K1 launches per call {}; quantized {}; smoke reading {:.3f} "
            "ms/batch (direct {:.3f}) by CUDA events; on {}".format(
                name, EXPORT_BATCH, t_export,
                os.path.getsize(os.path.join(out_dir, "model.pt2")) / 1e6,
                t_load, per_call, meta["quantized"], ms, ms_direct, card))

    args = serve.build_arg_parser().parse_args(
        ["--artifact", arts["bf16"], "--max_batch", str(EXPORT_BATCH),
         "--port", "0", "--device", "cuda"])
    server, batcher = serve.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:{}/healthz".format(server.server_address[1])
        with urllib.request.urlopen(url, timeout=30) as r:
            if r.status != 200 or r.read() != b"ok":
                raise AssertionError("/healthz did not answer 200 ok")
        frames = np.random.RandomState(13).randint(
            0, 256, (16, cfg.image_height, cfg.image_width, 3),
            dtype=np.uint8)
        with ThreadPoolExecutor(16) as pool:
            replies = list(pool.map(batcher.submit, frames))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    for boxes, probs, classes, keep in replies:
        if boxes.shape != (1, 64, 4) or keep.shape != (1, 64) or \
                not np.isfinite(probs).all():
            raise AssertionError("bad artifact reply")
    if len(replies) != 16 or batcher.batches_run < 2:
        raise AssertionError("{} replies in {} batches".format(
            len(replies), batcher.batches_run))
    log("[export] serve --artifact --max_batch {}: /healthz 200; 16 requests "
        "in {} batches".format(EXPORT_BATCH, batcher.batches_run))
    return k1 + 1 + batcher.batches_run


def int8_eval_demo(root, ckpt_dir, work):
    """The eval CLI with --quantize int8 --run_once on phase 8's fixture,
    and the demo with --quantize int8 on 4 of its frames (whole-net int8:
    no K1)."""
    import glob

    import numpy as np

    from squeezedet_torch import demo
    from squeezedet_torch import eval as eval_cli
    t0 = time.perf_counter()
    scored = []
    real = _recorded(eval_cli, "eval_checkpoint", scored)
    try:
        _logged(eval_cli.main, [
            "--device", "cuda", "--data_path", root, "--image_set", "val",
            "--checkpoint_path", ckpt_dir, "--eval_dir",
            os.path.join(work, "eval_int8"), "--run_once",
            "--eval_batch_size", "8", "--quantize", "int8",
            "--calib_batches", str(INT8_EVAL_CALIB)])
    finally:
        eval_cli.eval_checkpoint = real
    aps, _, mAP = scored[0]
    data = os.path.join(work, "eval_int8", "detection_files_{}".format(
        EVAL_STEP), "data")
    if len(os.listdir(data)) != EVAL_IMAGES or len(aps) != 9 or \
            not np.isfinite(aps).all():
        raise AssertionError("int8 eval: {} det files, APs {}".format(
            len(os.listdir(data)), aps))
    log("[int8] eval --quantize int8 --run_once (f32 B=8, calibrated on {} "
        "batches): {} images scored, mAP {:.6f}, {:.1f} s".format(
            INT8_EVAL_CALIB, EVAL_IMAGES, mAP, time.perf_counter() - t0))
    out = os.path.join(work, "demo_int8")
    _logged(demo.main, [
        "--device", "cuda", "--checkpoint", ckpt_dir, "--quantize", "int8",
        "--input_path", os.path.join(root, "training", "image_2",
                                     "00000[0-{}].png".format(
                                         DEMO_IMAGES - 1)),
        "--out_dir", out])
    if len(glob.glob(os.path.join(out, "out_*.png"))) != DEMO_IMAGES:
        raise AssertionError("int8 demo wrote {}".format(os.listdir(out)))
    log("[int8] demo --quantize int8: {} frames drawn".format(DEMO_IMAGES))


def int8_layer_table(qdet, det16, card):
    """Not counted: each int8 conv of squeezeDet's uint8 -> detections
    program at B=INT8_BIG_BATCH (im2col + torch._int_mm + epilogue, on the
    inputs the program gives it) timed by CUDA events beside the bf16
    cuDNN conv of the same layer (conv + bias + ReLU, or the two halves
    of a virtual concat) on inputs of the same shape."""
    import numpy as np
    import torch

    from squeezedet_torch.models import layers as L
    cfg = qdet.cfg
    calls = []
    real = L.qconv

    def recording(conv, xs, stride, padding="SAME", relu=True):
        calls.append((conv, xs, stride, padding, relu))
        return real(conv, xs, stride, padding, relu)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (INT8_BIG_BATCH, cfg.image_height, cfg.image_width, 3),
        dtype=np.uint8)).cuda()
    L.qconv = recording
    try:
        qdet.predict_quant(x)
    finally:
        L.qconv = real
    names = {id(m): n for n, m in qdet.backbone.named_modules()}
    floats = dict(det16.backbone.named_modules())
    rows, total = [], [0.0, 0.0]
    for conv, xs, stride, padding, relu in calls:
        name = names[id(conv)]
        fconv = floats[name]
        xb = [torch.randn(t.shape, device=t.device).to(torch.bfloat16)
              for t in xs]
        t_int8 = cuda_ms(lambda: real(conv, xs, stride, padding, relu), 3,
                         warmup=1)
        if len(xb) == 1:
            t_bf16 = cuda_ms(lambda: L.conv2d(fconv, xb[0], stride, padding,
                                              relu), 3, warmup=1)
        else:
            t_bf16 = cuda_ms(lambda: L.conv2d_pair(fconv, xb[0], xb[1],
                                                   stride, relu), 3,
                             warmup=1)
        o, c, kh, kw = conv.weight.shape
        rows.append({"layer": name, "in": [list(t.shape) for t in xs],
                     "kernel": [kh, kw, c, o], "int8_ms": round(t_int8, 4),
                     "bf16_cudnn_ms": round(t_bf16, 4)})
        total[0] += t_int8
        total[1] += t_bf16
        del xb
    for r in rows:
        log("[int8] conv {layer}: in {in}, kernel {kernel}: int8 {int8_ms} ms, "
            "bf16 cuDNN {bf16_cudnn_ms} ms".format(**r))
    log("[int8] the {} convs at B={}: int8 {:.3f} ms, bf16 cuDNN {:.3f} ms "
        "({:.2f}x); on {}".format(len(rows), INT8_BIG_BATCH, total[0],
                                  total[1], total[0] / total[1], card))
    return rows


def phase_int8_export(card, weights):
    """Phase 10: int8 and the exported artifact on phase 8's checkpoint
    (``weights``) and fixture.  Returns the K1 launches the counted part
    must show; the per-layer timing table runs after it, uncounted, from
    :func:`main`."""
    import shutil

    import numpy as np
    import torch

    from squeezedet_torch.config import config_for_net, \
        kitti_squeezedet_config
    from squeezedet_torch.models import get_model
    from squeezedet_torch.ops import fused_frontend as ff
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.join(HERE, ".chipscratch", "eval_demo")
    root, ckpt_dir = os.path.join(work, "kitti"), os.path.join(work, "train")
    cfg = kitti_squeezedet_config().replace(batch_size=INT8_CHECK_BATCH)
    det = get_model("squeezeDet", cfg, device="cuda")
    det.backbone.load_state_dict(weights)
    rs = np.random.RandomState(10)
    calib = [rs.randint(0, 256, (INT8_CHECK_BATCH, cfg.image_height,
                                 cfg.image_width, 3), dtype=np.uint8)
             for _ in range(INT8_CALIB_BATCHES)]
    qdet, scales = int8_card_vs_cpu(det, calib, "main")
    if ff.LAUNCHES != 0:
        raise AssertionError("calibration or whole-net int8 launched K1")

    det16 = get_model("squeezeDet", cfg.replace(compute_dtype="bfloat16"),
                      device="cuda")
    det16.backbone.load_state_dict(weights)
    k1 = int8_reading(qdet, det16, card)
    from squeezedet_torch import quant
    hybrid = quant.quantize_detector(det, scales, start=INT8_HYBRID_START)
    before = ff.LAUNCHES
    out = hybrid.predict_quant_postprocessed(torch.from_numpy(calib[0]).cuda())
    if ff.LAUNCHES - before != 1 or not torch.isfinite(out[1]).all():
        raise AssertionError("hybrid int8 forward: {} K1 launches".format(
            ff.LAUNCHES - before))
    k1 += 1
    log("[int8] hybrid int8 from {}: K1 launches once a forward".format(
        INT8_HYBRID_START))

    for net in BACKBONES:
        bcfg = config_for_net(net).replace(batch_size=INT8_CHECK_BATCH)
        bdet = get_model(net, bcfg, device="cuda")
        rsb = np.random.RandomState(14)
        int8_card_vs_cpu(bdet, [rsb.randint(
            0, 256, (INT8_CHECK_BATCH, bcfg.image_height, bcfg.image_width,
                     3), dtype=np.uint8)], "backbones")
        del bdet
    torch.cuda.empty_cache()

    calib_glob = os.path.join(root, "training", "image_2", "*.png")
    k1 += export_and_serve(ckpt_dir, calib_glob, work, card)
    int8_eval_demo(root, ckpt_dir, work)
    log("[int8] phase 10 took {:.1f} s".format(time.perf_counter() - t_phase))
    shutil.rmtree(work, ignore_errors=True)
    return k1, qdet, det16


def _rank_rows(out):
    """The per-rank report the train CLI's rank 0 prints."""
    line = [ln for ln in out.splitlines()
            if ln.startswith("data-parallel ranks ")]
    if len(line) != 1:
        raise AssertionError("{} per-rank reports".format(len(line)))
    return json.loads(line[0].split(" ", 2)[2])


def _collective_ms(trace_dir, steps):
    """ms per traced step of the collectives in a StepTracer trace: the
    host ops (gloo, c10d) and the NCCL device kernels, by name."""
    import glob
    (path,) = glob.glob(os.path.join(trace_dir, "trace_steps_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    per = {}
    for e in events:
        name = str(e.get("name", ""))
        low = name.lower()
        if e.get("ph") == "X" and ("allreduce" in low or "all_reduce" in low
                                   or "nccl" in low):
            per[name[:60]] = per.get(name[:60], 0.0) + e.get("dur", 0) / 1e3
    return {k: round(v / steps, 3) for k, v in sorted(per.items())}


def dp_train_cli(root, train_dir, extra, card, env=None,
                 steps=DP_CLI_STEPS):
    """The train CLI in a new process (``--num_devices`` spawns its
    ranks; ``env`` may hold a launcher's rank environment instead) at
    B=20, 1248x384, bf16, with the on-device ingest, matcher and augment,
    ``steps`` steps, a checkpoint at the last step and the detection
    images of step 0 (none at K > 1); returns its per-rank report after
    checking the run's files and logged loss."""
    import re

    import numpy as np
    argv = ["--device", "cuda", "--image_width", "1248", "--image_height",
            "384", "--batch_size", "20", "--compute_dtype", "bfloat16",
            "--learning_rate", "0.001", "--device_assign", "--uint8_ingest",
            "--device_augment", "--data_path", root, "--train_dir",
            train_dir, "--max_steps", str(steps), "--checkpoint_step",
            str(steps), "--summary_step", str(steps)] + extra
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "squeezedet_torch.train"]
                          + argv, cwd=HERE, capture_output=True, text=True,
                          timeout=900, env=env)
    seconds = time.perf_counter() - t0
    keep = [ln for ln in proc.stdout.splitlines()
            if "torch.distributed" in ln or "loss =" in ln
            or "Device-resident" in ln or "WARNING" in ln]
    for ln in keep:
        log("[dp]   " + ln)
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-8000:])
        raise AssertionError("train CLI {} exited {}".format(
            extra, proc.returncode))
    losses = [float(v) for v in re.findall(r"loss = (\S+) \(", proc.stdout)]
    rows = _rank_rows(proc.stdout)
    world = len(rows)
    files = sorted(os.listdir(train_dir))
    want_sampler = ["sampler.ckpt-{}{}.npz".format(
        steps - 1, ".p{}".format(r) if world > 1 else "")
        for r in range(world)]
    events = [f for f in files if f.startswith("events.out.tfevents")]
    if not losses or not np.isfinite(losses).all() or len(events) != 1 or \
            "model_metrics.txt" not in files or \
            "model.ckpt-{}".format(steps - 1) not in files or \
            [f for f in files if f.startswith("sampler.ckpt-{}.".format(
                steps - 1))] != want_sampler:
        raise AssertionError("train CLI {}: logged loss {}, files {}".format(
            extra, losses, files))
    for r, row in enumerate(rows):
        if row["steps"] != steps or row["k1"] != row["forwards"]:
            raise AssertionError("rank {}: {}".format(r, row))
        log("[dp] smoke reading of {} rank(s) sharing one card, not a "
            "scaling figure: rank {} {}: {:.3f} ms/step (median after 2), "
            "{:.1f} img/s of the global batch of 20, peak {} MiB; K1 {} for "
            "{} forwards, K2 {} for {} steps; on {}".format(
                world, r, " ".join(extra), row["step_us"] / 1e3,
                20e6 / max(row["step_us"], 1), row["peak_mib"], row["k1"],
                row["forwards"], row["k2"], row["steps"], card))
    log("[dp] train CLI {}: {} rank(s), logged loss {}, {} events file, "
        "{} in {:.1f} s".format(" ".join(extra), world, losses, len(events),
                                want_sampler, seconds))
    return rows


def gloo_scan_check(work, cfg, weights, k, steps, seed, tag, card,
                    spatial=1):
    """Two gloo ranks sharing the card (``parallel/dryrun.py``) each run
    ``steps`` stacked steps of ``cfg``'s global batch (uint8 frames at
    1248x384, seeded GT, dropout on) twice from one start: one at a time,
    and in K-step dispatches (the first eager, the second captured as a
    chain of CUDA graphs split at the rank's host all-reduces and
    replayed, the rest replayed), over ``spatial`` height tiles a
    forward.  Each rank's two runs must be equal bit for bit (loss
    terms, parameters, momentum, the dropout generator's state), under
    ``trainer.deterministic`` as the train loop runs them, with K1 once
    per tile of each forward in both, replays counted, and K2 0.
    Returns the ranks' K1 launches."""
    import numpy as np
    import torch

    from squeezedet_torch.models import get_model
    from squeezedet_torch.parallel import dryrun
    rs = np.random.RandomState(seed)
    b = cfg.batch_size
    det = get_model("squeezeDet", cfg, device="cpu")
    det.backbone.load_state_dict(weights)
    gts = [gt_batch(rs, b, cfg) for _ in range(steps)]
    frames = rs.randint(0, 256, (steps, b, cfg.image_height,
                                 cfg.image_width, 3), dtype=np.uint8)
    path = os.path.join(work, "gloo_scan.pt")
    dryrun.write_case(path, det, [frames] + [
        np.stack([g[i].numpy() for g in gts]) for i in range(3)],
        seed=seed, device="cuda", spatial=spatial, ks=(1, k))
    del frames
    results = dryrun.step_on_ranks(path, os.path.join(work, "gloo_scan"),
                                   DP_RANKS)
    os.remove(path)
    k1 = 0
    for r, by_k in enumerate(results):
        eager, graph = by_k[1], by_k[k]
        worst = {key: max(float((graph[key][n].float() - t.float()).abs()
                                .max()) for n, t in eager[key].items())
                 for key in ("params", "momentum")}
        loss = float((graph["loss"] - eager["loss"]).abs().max())
        same_gen = torch.equal(graph["generator"], eager["generator"])
        log("[{}] {} global B={} over {} tile(s) a rank, dropout {}, rank "
            "{} of {} ({}): {} steps in K={} dispatches (eager, graph chain "
            "captured and replayed, replayed) against the steps one at a "
            "time: loss terms max abs diff {:.3e}, params {:.3e}, momentum "
            "{:.3e}, generator states {}; K1 {} / {}, K2 {} / {} (one at a "
            "time / dispatches); {:.2f} s / {:.2f} s; on {}".format(
                tag, cfg.compute_dtype, b, spatial, cfg.keep_prob, r,
                DP_RANKS, graph["backend"], steps,
                k, loss, worst["params"], worst["momentum"],
                "equal" if same_gen else "DIFFER", eager["k1"], graph["k1"],
                eager["k2"], graph["k2"], eager["seconds"],
                graph["seconds"], card))
        want_k1 = spatial * steps
        if loss or worst["params"] or worst["momentum"] or not same_gen or \
                graph["step"] != eager["step"] or \
                graph["backend"] != "gloo" or \
                (eager["k1"], graph["k1"]) != (want_k1, want_k1) or \
                eager["k2"] or graph["k2"]:
            raise AssertionError("{}: gloo rank {}'s captured dispatches "
                                 "differ from its steps one at a time"
                                 .format(tag, r))
        k1 += eager["k1"] + graph["k1"]
    return k1


def _assert_same_detections(got, want, what):
    import numpy as np
    worst, n = 0.0, 0
    for c in range(len(want)):
        for i in range(len(want[c])):
            a = np.asarray(sorted(map(tuple, want[c][i])))
            b = np.asarray(sorted(map(tuple, got[c][i])))
            if a.shape != b.shape:
                raise AssertionError("{}: class {} image {}: {} detections, "
                                     "one replica {}".format(
                                         what, c, i, len(b), len(a)))
            if a.size:
                np.testing.assert_allclose(b, a, rtol=EVAL_BOX_RTOL,
                                           atol=EVAL_BOX_ATOL)
                worst = max(worst, float(np.abs(b - a).max()))
                n += len(a)
    return n, worst


def _serve_replies(args, frames):
    from squeezedet_torch import serve
    server, batcher = serve.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with ThreadPoolExecutor(len(frames)) as pool:
            replies = list(pool.map(batcher.submit, frames))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return replies, batcher.batches_run


def phase_data_parallel(card, weights):
    """Phase 11 (see the docstring).  Returns the K1 launches this process
    must have made and the K1 and K2 launches its ranks reported."""
    import shutil

    import numpy as np
    import torch

    from squeezedet_torch.checkpoint.manager import CheckpointManager
    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.data.kitti import Kitti
    from squeezedet_torch.data.synth import write_kitti_fixture
    from squeezedet_torch.eval import detect_all
    from squeezedet_torch.models import get_model
    from squeezedet_torch.parallel import dryrun
    from squeezedet_torch.parallel.distributed import free_port
    from squeezedet_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    work = os.path.join(HERE, ".chipscratch", "data_parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tf32 = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    k1 = 0
    child = {"k1": 0, "k2": 0}
    try:
        # (a) the f32 step: two gloo ranks on the card, one NCCL rank
        cfg = kitti_squeezedet_config().replace(batch_size=DP_STEP_BATCH)
        det = get_model("squeezeDet", cfg, device="cpu")
        det.backbone.load_state_dict(weights)
        rs = np.random.RandomState(11)
        u8 = rs.randint(0, 256, (DP_STEP_BATCH, cfg.image_height,
                                 cfg.image_width, 3), dtype=np.uint8)
        case_path = os.path.join(work, "case.pt")
        dryrun.write_case(case_path, det, [u8] + [
            t.numpy() for t in gt_batch(rs, DP_STEP_BATCH, cfg)],
            seed=5, device="cuda")
        want = dryrun.one_step(dryrun.load_case(case_path))
        k1 += 1
        zeros = {n: torch.zeros_like(t) for n, t in want["momentum"].items()}
        for world, backend in ((DP_RANKS, "gloo"), (1, "nccl")):
            results = dryrun.step_on_ranks(
                case_path, os.path.join(work, "out{}".format(world)), world)
            for r, got in enumerate(results):
                torch.testing.assert_close(got["loss"], want["loss"],
                                           rtol=LOSS_RTOL, atol=0)
                params = worst_step_ratio(got["params"], want["params"],
                                          weights)
                momentum = worst_step_ratio(got["momentum"],
                                            want["momentum"], zeros)
                log("[dp] f32 B={} step, rank {} of {} ({}) vs one process: "
                    "loss {} vs {}; worst leaf ||diff||/||update||: params "
                    "{:.3e} ({}), momentum {:.3e} ({}); K1 {}, K2 {}".format(
                        DP_STEP_BATCH, r, world, got["backend"],
                        [round(float(v), 6) for v in got["loss"]],
                        [round(float(v), 6) for v in want["loss"]],
                        *params, *momentum, got["k1"], got["k2"]))
                if params[0] > DP_STEP_TOL or momentum[0] > DP_STEP_TOL or \
                        got["backend"] != backend or got["k1"] != 1 or \
                        got["k2"] != 0:
                    raise AssertionError("data-parallel step disagrees")
                child["k1"] += got["k1"]
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32

        # (b) the train CLI: two gloo ranks, then sharded --device_dataset,
        # then one NCCL rank under a launcher's environment
        root = os.path.join(work, "kitti")
        write_kitti_fixture(root, DP_IMAGES, LOOP_FRAME, seed=4)
        rows = dp_train_cli(root, os.path.join(work, "tr"),
                            ["--num_devices", str(DP_RANKS)], card)
        dd_dir = os.path.join(work, "tr_dd")
        rows += dp_train_cli(root, dd_dir, [
            "--num_devices", str(DP_RANKS), "--device_dataset",
            "--profile_steps", DP_PROFILE_STEPS], card)
        traced = int(DP_PROFILE_STEPS.split(":")[1]) - \
            int(DP_PROFILE_STEPS.split(":")[0])
        log("[dp] rank 0's collectives, 2 gloo ranks on one card, ms per "
            "step (torch.profiler over {} steps): {}".format(
                traced, _collective_ms(os.path.join(dd_dir, "profile"),
                                       traced)))
        # the same ranks at K steps per dispatch: each rank's K steps a
        # chain of graphs split at its host all-reduces
        scan = dp_train_cli(root, os.path.join(work, "tr_scan"), [
            "--num_devices", str(DP_RANKS), "--device_dataset",
            "--steps_per_dispatch", str(DP_SCAN_K)], card,
            steps=DP_SCAN_STEPS)
        log("[dp] smoke reading of 2 gloo ranks sharing one card, not a "
            "benchmark: train CLI B=20 bf16 --device_dataset, K=1 {} "
            "ms/step, K={} {} ms/step (per rank, medians after 2 "
            "dispatches); peak {} / {} MiB; on {}".format(
                [r["step_us"] / 1e3 for r in rows[DP_RANKS:]], DP_SCAN_K,
                [r["step_us"] / 1e3 for r in scan],
                [r["peak_mib"] for r in rows[DP_RANKS:]],
                [r["peak_mib"] for r in scan], card))
        rows += scan
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()))
        nccl_dir = os.path.join(work, "tr_nccl")
        nccl = dp_train_cli(root, nccl_dir, [
            "--pallas_grads", "--profile_steps", DP_PROFILE_STEPS], card,
            env=env)
        log("[dp] the NCCL rank's collectives, ms per step (torch.profiler "
            "over {} steps): {}".format(traced, _collective_ms(
                os.path.join(nccl_dir, "profile"), traced)))
        if any(r["k2"] for r in rows) or \
                nccl[0]["k2"] != K2_PER_STEP["1x1"] * DP_CLI_STEPS:
            raise AssertionError("K2 launches: gloo ranks {}, NCCL rank "
                                 "{}".format([r["k2"] for r in rows],
                                             nccl[0]["k2"]))
        for row in rows + nccl:
            child["k1"] += row["k1"]
            child["k2"] += row["k2"]

        # (c) eval over two replicas on the card against one replica
        val = os.path.join(work, "val")
        write_kitti_fixture(val, DP_IMAGES, LOOP_FRAME, seed=6,
                            image_set="val", boxes=(5, 9))
        ecfg = kitti_squeezedet_config().replace(batch_size=DP_EVAL_BATCH)
        det = rescaled_detector("squeezeDet", ecfg, torch.from_numpy(
            u8[:2]))
        k1 += 1
        det16 = get_model("squeezeDet", ecfg.replace(
            compute_dtype="bfloat16"), device="cuda")
        det16.load_state_dict(det.state_dict())
        mesh = make_mesh(DP_RANKS, "cuda")
        for tag, d, dd in (("f32 B=8", det, False),
                           ("bf16 B=8 --device_dataset", det16, True)):
            runs = []
            for m in (None, mesh):
                t0 = time.perf_counter()
                boxes, n_det, timers = detect_all(
                    d, Kitti("val", val, d.cfg), DP_EVAL_BATCH,
                    device_postprocess=True, device_dataset=dd, mesh=m)
                runs.append((boxes, time.perf_counter() - t0))
                k1 += timers["im_detect"].calls * (1 if m is None
                                                   else DP_RANKS)
            n, worst = _assert_same_detections(runs[1][0], runs[0][0], tag)
            log("[dp] eval {} over {} replicas on {}: {} detections equal to "
                "one replica's (max difference {:.3e}); {:.2f} s vs {:.2f} s "
                "for the scan, on {}".format(
                    tag, DP_RANKS, ", ".join(str(x) for x in mesh), n, worst,
                    runs[1][1], runs[0][1], card))

        # (d) the server over two replicas against one, on a checkpoint
        # of the rescaled weights
        ckpt = os.path.join(work, "ckpt")
        CheckpointManager(ckpt).save(1, {"params": det.backbone.state_dict()})
        from squeezedet_torch import serve
        flags = ["--max_batch", "8", "--port", "0", "--device", "cuda",
                 "--compute_dtype", "float32", "--checkpoint", ckpt]
        frames = np.random.RandomState(12).randint(
            0, 256, (16, 384, 1248, 3), dtype=np.uint8)
        one, b1 = _serve_replies(serve.build_arg_parser().parse_args(flags),
                                 frames)
        two, b2 = _serve_replies(serve.build_arg_parser().parse_args(
            flags + ["--num_devices", str(DP_RANKS)]), frames)
        k1 += 1 + b1 + DP_RANKS * (1 + b2)
        worst = 0.0
        for i, (a, b) in enumerate(zip(one, two)):
            if not (np.array_equal(a[3], b[3]) and
                    np.array_equal(a[2][a[3]], b[2][b[3]])):
                raise AssertionError("frame {}: kept detections or classes "
                                     "differ".format(i))
            keep = a[3]
            np.testing.assert_allclose(b[0][keep], a[0][keep],
                                       rtol=EVAL_BOX_RTOL, atol=BOX_ATOL)
            np.testing.assert_allclose(b[1][keep], a[1][keep], rtol=0,
                                       atol=PROB_ATOL)
            worst = max(worst, float(np.abs(b[0][keep] - a[0][keep]).max()
                                     if keep.any() else 0.0))
        log("[dp] server over {} replicas (--max_batch 8, f32): 16 "
            "concurrent frames in {} batches get the one-replica server's "
            "replies ({} batches; boxes within {:.3e} px)".format(
                DP_RANKS, b2, b1, worst))
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
        shutil.rmtree(work, ignore_errors=True)
    log("[dp] phase 11 took {:.1f} s".format(time.perf_counter() - t_phase))
    return k1, child


def _kernel_rows(prof, wall_ms):
    """{kernel name: launches} of a profile's device rows, the sum of
    their times (ms) and the device's idle share of ``wall_ms``."""
    import torch
    rows, busy = {}, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.name] = rows.get(e.name, 0) + 1
            busy += (e.time_range.end - e.time_range.start) / 1e3
    return rows, busy, max(0.0, 1.0 - busy / wall_ms)


def _rows_named(rows, part):
    return sum(n for name, n in rows.items() if part in name)


def phase_graph_step(card, weights):
    """Phase 12 (a): K steps per dispatch captured in one CUDA graph
    against the same K steps run eagerly, from the same weights and
    generator, over GRAPH_DISPATCHES dispatches of --device_dataset-style
    inputs (bf16, dropout on, mode "1x1"); then the same over two gloo
    ranks, each rank's K steps a chain of graphs split at its host
    all-reduces (``gloo_scan_check``).  Returns the steps run in this
    process (each launches K1 once and K2 ten times) and the ranks' K1
    launches."""
    import numpy as np
    import torch

    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.models import layers as L
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.trainer import (make_train_step_device,
                                          make_train_step_device_scan)
    k, b = GRAPH_K, GRAPH_BATCH
    cfg = kitti_squeezedet_config().replace(
        compute_dtype="bfloat16", learning_rate=1e-3,
        lr_warmup_steps=GRAPH_WARMUP)
    h0, w0 = LOOP_FRAME
    rs = np.random.RandomState(12)
    dataset = torch.from_numpy(rs.randint(
        0, 256, (GRAPH_CANVASES, h0, w0, 3), dtype=np.uint8)).cuda()

    def dispatch_inputs():
        dx = rs.randint(-cfg.drift_x, cfg.drift_x + 1, (k, b))
        dy = rs.randint(-cfg.drift_y, cfg.drift_y + 1, (k, b))
        aug = np.stack([dx, dy, rs.randint(0, 2, (k, b)), w0 - dx, h0 - dy],
                       axis=-1).astype(np.float32)
        pos = rs.randint(0, GRAPH_CANVASES, (k, b))
        gts = [gt_batch(rs, b, cfg) for _ in range(k)]
        return [torch.from_numpy(pos), torch.from_numpy(aug)] + [
            torch.stack([g[i] for g in gts]) for i in range(3)]

    inputs = [dispatch_inputs() for _ in range(GRAPH_DISPATCHES)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    L.set_filter_grad("1x1")
    try:
        runs = {}
        for kind in ("eager", "graph"):
            state = fresh_state(cfg, "cuda", weights)
            gen = torch.Generator(device="cuda").manual_seed(5)
            if kind == "eager":
                one = make_train_step_device(state, uint8_ingest=True,
                                             device_augment=True,
                                             device_dataset=True)

                def dispatch(*d):
                    lbs = [one(dataset, *(x[i].cuda() for x in d),
                               generator=gen) for i in range(k)]
                    return torch.stack([torch.stack(list(lb))
                                        for lb in lbs])
            else:
                scan = make_train_step_device_scan(
                    state, k, uint8_ingest=True, device_augment=True,
                    device_dataset=True)

                def dispatch(*d):
                    return torch.stack(list(scan(dataset, *d,
                                                 generator=gen)), dim=1)
            losses, ms, counts = [], [], []
            for j, d in enumerate(inputs):
                before = ff.LAUNCHES, fg.LAUNCHES
                last = j == GRAPH_DISPATCHES - 1
                prof = torch.profiler.profile(activities=acts) if last \
                    else None
                torch.cuda.synchronize()
                if prof is not None:
                    prof.start()
                t0 = time.perf_counter()
                losses.append(dispatch(*d))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if prof is not None:
                    prof.stop()
                counts.append((ff.LAUNCHES - before[0],
                               fg.LAUNCHES - before[1]))
            rows, busy, idle = _kernel_rows(prof, ms[-1])
            runs[kind] = dict(state=state, gen=gen, losses=torch.stack(
                losses).cpu(), ms=ms, counts=counts, rows=rows, busy=busy,
                idle=idle)
            log("[graph] {} K={} dispatches, bf16 B={} --device_dataset "
                "dropout {} mode '1x1': ms per dispatch {} (the last "
                "traced: {} device rows, {:.3f} ms of kernels, device idle "
                "{:.1%}); K1/K2 launches per dispatch {}; K1 rows {}, K2 "
                "rows {} in the traced dispatch; on {}".format(
                    kind, k, b, cfg.keep_prob,
                    [round(t, 3) for t in ms], sum(rows.values()), busy,
                    idle, counts, _rows_named(rows, "conv1_pool1"),
                    _rows_named(rows, "filter_grad_tc_partial"), card))
        eager, graph = runs["eager"], runs["graph"]
        for kind in ("eager", "graph"):
            run = runs[kind]
            want = [(k, K2_PER_STEP["1x1"] * k)] * GRAPH_DISPATCHES
            k1_rows = _rows_named(run["rows"], "conv1_pool1")
            k2_rows = _rows_named(run["rows"], "filter_grad_tc_partial")
            if run["counts"] != want or \
                    (k1_rows, k2_rows) != run["counts"][-1]:
                raise AssertionError(
                    "{}: launches per dispatch {} (expected {}), profiler "
                    "rows K1 {} K2 {} in the last".format(
                        kind, run["counts"], want, k1_rows, k2_rows))
        if not torch.equal(eager["gen"].get_state(), graph["gen"].get_state()):
            raise AssertionError("the dropout generator's state after the "
                                 "replays differs from the eager steps'")
        if graph["state"].step != eager["state"].step:
            raise AssertionError("optimizer steps {} vs {}".format(
                graph["state"].step, eager["state"].step))
        torch.testing.assert_close(graph["losses"], eager["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        params = worst_step_ratio(graph["state"].det.backbone.state_dict(),
                                  eager["state"].det.backbone.state_dict(),
                                  weights)
        momentum = worst_step_ratio(
            graph["state"].opt.trace, eager["state"].opt.trace,
            {n: torch.zeros_like(t)
             for n, t in eager["state"].opt.trace.items()})
        log("[graph] captured vs eager over {} steps: loss terms max abs "
            "diff {:.3e}; worst leaf ||diff||/||update||: params {:.3e} "
            "({}), momentum {:.3e} ({}); generator states equal".format(
                k * GRAPH_DISPATCHES,
                float((graph["losses"] - eager["losses"]).abs().max()),
                *params, *momentum))
        if params[0] > DP_STEP_TOL or momentum[0] > DP_STEP_TOL:
            raise AssertionError("captured and eager steps disagree")
        log("[graph] smoke reading, not a benchmark: a replayed dispatch "
            "{:.3f} ms ({:.3f} ms/step, device idle {:.1%}) against {} "
            "eager steps {:.3f} ms ({:.3f} ms/step, idle {:.1%}); on "
            "{}".format(graph["ms"][-1], graph["ms"][-1] / k, graph["idle"],
                        k, eager["ms"][-1], eager["ms"][-1] / k,
                        eager["idle"], card))
    finally:
        L.set_filter_grad(False)
    del runs, dataset
    torch.cuda.empty_cache()
    # the same dispatches over two gloo ranks (K2 is not routed over
    # ranks): a chain of graphs split at the host all-reduces
    import shutil
    work = os.path.join(HERE, ".chipscratch", "graph_gloo")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        ranks_k1 = gloo_scan_check(work, cfg.replace(batch_size=b), weights,
                                   k, k * GRAPH_DISPATCHES, 13, "graph",
                                   card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 2 * k * GRAPH_DISPATCHES, ranks_k1


def phase_graph_cli(card):
    """Phase 12 (b) and (c): the train CLI at K=GRAPH_CLI_K against K=1,
    a checkpointed K run with an odd tail and its resume, an NCCL rank at
    K=NCCL_SCAN_K, and an --activation_summary run.  Returns the forwards
    (one K1 launch each) and backwards (ten K2 launches each) in this
    process, and the NCCL rank's report."""
    import contextlib
    import io
    import re
    import shutil

    import numpy as np
    import torch

    from squeezedet_torch import summary, trainer
    from squeezedet_torch import train as cli
    from squeezedet_torch.data.imdb import Imdb, _opencv
    from squeezedet_torch.data.kitti import Kitti
    from squeezedet_torch.data.synth import write_kitti_fixture
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.parallel.distributed import free_port
    t_phase = time.perf_counter()
    work = os.path.join(HERE, ".chipscratch", "graph")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    write_kitti_fixture(root, LOOP_IMAGES, LOOP_FRAME, seed=12)
    argv = LOOP_ARGV + ["--data_path", root, "--device_dataset",
                        "--summary_step", "1000"]
    calls, plans = [], []
    real_make, real_scan, real_draw = trainer.make_train_step_device, \
        trainer.make_train_step_device_scan, Imdb.draw_batch_plan

    def timed(fn):
        def call(*a, **k):
            calls.append(time.perf_counter())
            return fn(*a, **k)
        return call

    def recording_draw(self, shuffle=True):
        plans.append(real_draw(self, shuffle))
        return plans[-1]

    def run(name, extra, patch):
        calls.clear()
        plans.clear()
        setattr(trainer, patch.__name__, lambda *a, **k: timed(
            patch(*a, **k)))
        launches = ff.LAUNCHES, fg.LAUNCHES
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            with contextlib.redirect_stdout(buf):
                state = cli.main(argv + extra)
        finally:
            setattr(trainer, patch.__name__, patch)
            log(buf.getvalue().rstrip())
        out = buf.getvalue()
        logged = {int(s): float(v) for s, v in re.findall(
            r"step (\d+), loss = (\S+) \(", out)}
        if not logged or not all(np.isfinite(v) for v in logged.values()):
            raise AssertionError("{}: logged loss {}".format(name, logged))
        return (state, out, ff.LAUNCHES - launches[0],
                fg.LAUNCHES - launches[1], list(calls),
                sorted(plans, key=lambda p: p.seq))

    Imdb.draw_batch_plan = recording_draw
    forwards = steps = 0
    try:
        # (b) ms per step at K=1 and at K, the same flags, in turns
        st1, _, k1, k2, calls1, _ = run("K=1", [
            "--train_dir", os.path.join(work, "k1"), "--max_steps",
            str(GRAPH_K1_STEPS), "--checkpoint_step", "1000"], real_make)
        probe = summary.SummaryWriter(os.path.join(work, "probe"))
        viz = int(_opencv() is not None and probe.enabled)
        probe.close()
        if (k1, k2) != (GRAPH_K1_STEPS + viz,
                        K2_PER_STEP["1x1"] * GRAPH_K1_STEPS):
            raise AssertionError("K=1 run: K1 {} K2 {}".format(k1, k2))
        forwards, steps = forwards + k1, steps + GRAPH_K1_STEPS
        stk, _, k1, k2, callsk, _ = run("K={}".format(GRAPH_CLI_K), [
            "--train_dir", os.path.join(work, "k8"), "--max_steps",
            str(GRAPH_STEPS), "--checkpoint_step", "1000",
            "--steps_per_dispatch", str(GRAPH_CLI_K)], real_scan)
        if (k1, k2) != (GRAPH_STEPS, K2_PER_STEP["1x1"] * GRAPH_STEPS) or \
                stk.step != GRAPH_STEPS:
            raise AssertionError("K={} run: step {}, K1 {} K2 {}".format(
                GRAPH_CLI_K, stk.step, k1, k2))
        forwards, steps = forwards + k1, steps + GRAPH_STEPS
        gaps1 = np.diff(calls1[LOOP_TIMED_FROM:]) * 1e3
        # the replayed dispatches: the first runs eagerly, the second
        # captures; the tail's single steps are not counted
        gapsk = np.diff(callsk[2:]) * 1e3 / GRAPH_CLI_K
        log("[graph] smoke reading, not a benchmark: train CLI B=20 bf16 "
            "--device_dataset --pallas_grads, K=1 {:.3f} ms/step (median "
            "{:.3f}, {} intervals), K={} {:.3f} ms/step (median {:.3f}, "
            "{} replayed dispatches); peak {:.2f} GiB; on {}".format(
                gaps1.mean(), float(np.median(gaps1)), len(gaps1),
                GRAPH_CLI_K, gapsk.mean(), float(np.median(gapsk)),
                len(gapsk), torch.cuda.max_memory_allocated() / 2**30, card))
        del st1, stk

        # checkpoints at dispatch boundaries, an odd tail, and a resume
        ck_dir = os.path.join(work, "ckpt")
        ck = ["--train_dir", ck_dir, "--checkpoint_step", str(GRAPH_EVERY),
              "--steps_per_dispatch", str(GRAPH_CLI_K)]
        _, _, k1, k2, _, _ = run("checkpointed", ck + [
            "--max_steps", str(GRAPH_CKPT_TO)], real_scan)
        if (k1, k2) != (GRAPH_CKPT_TO, K2_PER_STEP["1x1"] * GRAPH_CKPT_TO):
            raise AssertionError("checkpointed run: K1 {} K2 {}".format(k1,
                                                                      k2))
        forwards, steps = forwards + k1, steps + GRAPH_CKPT_TO
        kept = sorted(n for n in os.listdir(ck_dir)
                      if n.startswith("model.ckpt"))
        want = ["model.ckpt-{}".format(s) for s in (16, 20)]
        if kept != want or not os.path.exists(os.path.join(
                ck_dir, "sampler.ckpt-20.npz")):
            raise AssertionError("kept {}, expected {} with their sampler "
                                 "files".format(kept, want))
        state, out, k1, k2, _, resumed = run("resume", ck + [
            "--max_steps", str(GRAPH_RESUME_TO)], real_scan)
        n = GRAPH_RESUME_TO - GRAPH_CKPT_TO
        if (k1, k2) != (n, K2_PER_STEP["1x1"] * n):
            raise AssertionError("resume: K1 {} K2 {}".format(k1, k2))
        forwards, steps = forwards + k1, steps + n
        if "Resumed from step {}".format(GRAPH_CKPT_TO) not in out or \
                state.step != GRAPH_RESUME_TO:
            raise AssertionError("the resume did not run steps {}..{}".format(
                GRAPH_CKPT_TO, GRAPH_RESUME_TO - 1))
        cfg = cli.config_from_args(cli.build_arg_parser().parse_args(argv))
        ref = Kitti("train", root, cfg, rng=np.random.RandomState(0))
        straight = [real_draw(ref) for _ in range(GRAPH_RESUME_TO)]
        for got, want in zip(resumed, straight[GRAPH_CKPT_TO:]):
            if got.batch_idx != want.batch_idx or got.augment != want.augment:
                raise AssertionError("the resumed K={} run drew {}, a "
                                     "straight run {}".format(
                                         GRAPH_CLI_K, got.batch_idx,
                                         want.batch_idx))
        log("[graph] K={} checkpoints kept {}; the resume from step {} "
            "drew a straight run's batches to step {}".format(
                GRAPH_CLI_K, kept, GRAPH_CKPT_TO, GRAPH_RESUME_TO - 1))
        del state

        # (c) activation summaries at the histogram steps
        tags, tape_k1 = [], []
        real_hist, real_scalar = summary.SummaryWriter.histogram, \
            summary.SummaryWriter.scalar
        real_act = trainer.write_activation_summaries

        def hist(self, tag, *a, **k):
            tags.append(tag)
            return real_hist(self, tag, *a, **k)

        def scalar(self, tag, *a, **k):
            tags.append(tag)
            return real_scalar(self, tag, *a, **k)

        def act(*a, **k):
            before = ff.LAUNCHES
            real_act(*a, **k)
            tape_k1.append(ff.LAUNCHES - before)
        summary.SummaryWriter.histogram, summary.SummaryWriter.scalar = \
            hist, scalar
        trainer.write_activation_summaries = act
        try:
            _, _, k1, k2, _, _ = run("activation_summary", [
                "--train_dir", os.path.join(work, "act"), "--max_steps",
                str(ACT_STEPS), "--histogram_step", str(ACT_HIST_EVERY),
                "--activation_summary"], real_make)
        finally:
            summary.SummaryWriter.histogram, summary.SummaryWriter.scalar = \
                real_hist, real_scalar
            trainer.write_activation_summaries = real_act
        hist_steps = len(range(0, ACT_STEPS, ACT_HIST_EVERY))
        need = ["activations/conv1", "activations/fire2",
                "activations/det_boxes/cx"] + [
            "activation_summary/conv1/" + s
            for s in ("sparsity", "mean", "max", "min")]
        if tape_k1 != [0] * hist_steps or any(t not in tags for t in need) \
                or k1 != ACT_STEPS + hist_steps + viz or \
                k2 != K2_PER_STEP["1x1"] * (ACT_STEPS + hist_steps):
            raise AssertionError("--activation_summary: K1 launches {} in "
                                 "the tape forwards, {} in all, K2 {}; tags "
                                 "{}".format(tape_k1, k1, k2,
                                             sorted(set(tags))))
        # the histogram steps' gradients run a backward each
        forwards, steps = forwards + k1, steps + ACT_STEPS + hist_steps
        log("[graph] --activation_summary: {} histogram steps wrote {} "
            "activations/ histograms and {} activation_summary/ scalars; "
            "K1 launched 0 times in the tape forwards".format(
                hist_steps, sum(t.startswith("activations/") for t in tags),
                sum(t.startswith("activation_summary/") for t in tags)))

        # an NCCL rank (a launcher's environment): its all-reduces and
        # K2 are captured with the steps
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()))
        (row,) = dp_train_cli(root, os.path.join(work, "nccl"), [
            "--pallas_grads", "--steps_per_dispatch", str(NCCL_SCAN_K)],
            card, env=env)
        if row["k2"] != K2_PER_STEP["1x1"] * DP_CLI_STEPS:
            raise AssertionError("NCCL rank at K={}: {}".format(NCCL_SCAN_K,
                                                                row))
    finally:
        Imdb.draw_batch_plan = real_draw
        shutil.rmtree(work, ignore_errors=True)
    log("[graph] (b) and (c) took {:.1f} s".format(
        time.perf_counter() - t_phase))
    return forwards, steps, row


def phase_learning(card):
    """Phase 12 (d): the recipe's large arm at seed 0 through the train
    CLI (K=8, --device_dataset), then the eval CLI on its last
    checkpoint.  Returns the steps trained (one K1 launch each) and the
    eval batches (one each)."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from squeezedet_torch import eval as eval_cli
    from squeezedet_torch import train as cli
    from squeezedet_torch.data.synth import make_synth_kitti
    t_phase = time.perf_counter()
    work = os.path.join(HERE, ".chipscratch", "learn")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "kitti")
    h, w = LEARN_FRAME
    try:
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(lambda a: make_synth_kitti(
                data, num_images=a[0], width=w, height=h, image_set=a[1],
                seed=a[2], start_index=a[3]),
                [(LEARN_TRAIN, "train", 1, 0), (LEARN_VAL, "val", 7, 1000)]))
        t_gen = time.perf_counter() - t_phase
        train_dir = os.path.join(work, "train")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, out = _logged(cli.main, ["--device", "cuda", "--data_path",
                                        data, "--train_dir", train_dir]
                             + LEARN_ARGV)
        t_train = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        if state.step != LEARN_STEPS:
            raise AssertionError("the recipe run ended at step {}".format(
                state.step))
        del state
        torch.cuda.empty_cache()
        scored = []
        real = _recorded(eval_cli, "eval_checkpoint", scored)
        t0 = time.perf_counter()
        try:
            _logged(eval_cli.main, [
                "--device", "cuda", "--data_path", data, "--image_set",
                "val", "--eval_dir", os.path.join(work, "eval"),
                "--checkpoint_path", train_dir, "--run_once",
                "--eval_batch_size", "25", "--image_width", str(w),
                "--image_height", str(h), "--compute_dtype", "bfloat16"])
        finally:
            eval_cli.eval_checkpoint = real
        aps, names, mAP = scored[0]
        log("[learn] the recipe's large arm, seed 0, K=8 --device_dataset: "
            "{} steps at B=128 in {:.1f} s (fixture {:.1f} s, eval {:.1f} s), "
            "peak {:.2f} GiB; val mAP {:.4f}; APs {}; on {}".format(
                LEARN_STEPS, t_train, t_gen, time.perf_counter() - t0, peak,
                mAP, json.dumps({n: round(float(a), 4)
                                 for n, a in zip(names, aps)}), card))
        if not np.isfinite(mAP) or mAP < LEARN_MIN_MAP:
            raise AssertionError("val mAP {:.4f} < {}".format(mAP,
                                                              LEARN_MIN_MAP))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("[learn] phase 12 (d) took {:.1f} s".format(
        time.perf_counter() - t_phase))
    return LEARN_STEPS, -(-LEARN_VAL // 25)


def _tiling(grid, device="cuda"):
    from squeezedet_torch.parallel.mesh import make_mesh_spatial
    return make_mesh_spatial(*grid, device=device).tiling()


def spatial_forward(det, u8, grid):
    """uint8 -> (raw preds, interpretation, detections) of ``det`` on the
    card over the tiles of ``grid`` (None: unsharded), with the K1
    launches, halo copies and bytes of the forward and its tile trace."""
    import torch

    from squeezedet_torch.data.device_pipeline import normalize_images
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.models import halo
    tiling = None if grid is None else _tiling(grid)
    before = ff.LAUNCHES, halo.COPIES, halo.BYTES
    with torch.inference_mode(), halo.trace() as ops:
        preds = det.run_backbone(normalize_images(
            u8, det.cfg.bgr_means, det.compute_dtype), spatial=tiling)
        interp = det.interpret(preds.float())
        out = det.postprocess_device(interp)
    torch.cuda.synchronize()
    return (preds.float(), interp, out, ff.LAUNCHES - before[0],
            halo.COPIES - before[1], halo.BYTES - before[2], ops)


def _check_tiles_kept(ops, grid, tag):
    """Every tiled op's tiles hold fewer rows than the frame (no tile of
    a height split ever holds the whole frame before the head), and each
    tile's extent is its bounds'."""
    for op in ops:
        heights = [h for row in op["heights"] for h in row]
        want = [op["rows"][i + 1] - op["rows"][i]
                for i in range(len(op["rows"]) - 1)
                for _ in range(len(op["cols"]) - 1)]
        if heights != want or (grid[0] > 1 and
                               max(heights) >= op["rows"][-1]):
            raise AssertionError("{} {}: tile heights {} at {} of bounds "
                                 "{}".format(tag, grid, heights, op["op"],
                                             op["rows"]))


def _assert_same_outputs(got, want, tag, box_rtol=SPATIAL_BOX_TOL,
                         box_atol=SPATIAL_BOX_TOL,
                         prob_atol=SPATIAL_PROB_ATOL):
    """The raw interpretation and the detections of ``got`` against
    ``want`` (spatial_forward's), tests/test_spatial.py's tolerances."""
    import torch
    gi, wi = got[1], want[1]
    torch.testing.assert_close(gi.det_boxes, wi.det_boxes, rtol=box_rtol,
                               atol=box_atol, msg=tag)
    torch.testing.assert_close(gi.det_probs, wi.det_probs,
                               rtol=SPATIAL_BOX_TOL, atol=prob_atol, msg=tag)
    if not torch.equal(gi.det_class, wi.det_class):
        raise AssertionError("{}: classes differ".format(tag))
    boxes, probs, classes, keep = got[2]
    torch.testing.assert_close(boxes, want[2][0], rtol=box_rtol,
                               atol=box_atol, msg=tag)
    torch.testing.assert_close(probs, want[2][1], rtol=SPATIAL_BOX_TOL,
                               atol=prob_atol, msg=tag)
    if not (torch.equal(classes, want[2][2]) and
            torch.equal(keep, want[2][3])):
        raise AssertionError("{}: post-NMS classes or keep differ".format(
            tag))


def _separated_frame(det, shape):
    """The first seeded uint8 frame (on the card) whose unsharded f32
    output keeps its top-65 scores MIN_GAP apart and its same-class
    IoUs MIN_IOU_MARGIN from nms_thresh, and that output."""
    import numpy as np
    import torch
    for seed in range(1, 65):
        u8 = torch.from_numpy(np.random.RandomState(seed).randint(
            0, 256, shape, dtype=np.uint8)).cuda()
        want = spatial_forward(det, u8, None)
        iou = _same_class_iou(want[2][0].cpu(), want[2][2].cpu())
        margin = (iou - det.cfg.nms_thresh).abs().min().item() \
            if iou.numel() else 1.0
        if _top_gap(want[1].det_probs) >= MIN_GAP and \
                margin >= MIN_IOU_MARGIN:
            return seed, u8, want
    raise AssertionError("no seeded frame with separated top-64 ranks")


def phase_spatial_forward(card, weights):
    """Phase 13 (a)-(c): squeezeDet's float and bf16 tile grids, the
    other nets' and the int8 grid, each against the unsharded forward on
    the card.  Returns the K1 launches made."""
    import torch

    from squeezedet_torch.config import (config_for_net,
                                         kitti_squeezedet_config)
    from squeezedet_torch.models import get_model
    from squeezedet_torch.parallel.mesh import spatial_factors
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = kitti_squeezedet_config().replace(batch_size=1)
    shape = (1, cfg.image_height, cfg.image_width, 3)
    det = get_model("squeezeDet", cfg, device="cuda")
    det.backbone.load_state_dict(weights)
    det = rescaled_detector_from(det, shape)
    k1 = 1
    seed, u8, want = _separated_frame(det, shape)
    k1 += seed
    for grid in SPATIAL_GRIDS:
        got = spatial_forward(det, u8, grid)
        k1 += got[3]
        _assert_same_outputs(got, want, "f32 {}".format(grid))
        _check_tiles_kept(got[6], grid, "f32")
        tiles = grid[0] * grid[1]
        if got[3] != tiles or got[4] == 0:
            raise AssertionError("f32 {}: K1 launches {} for {} tiles, {} "
                                 "halo copies".format(grid, got[3], tiles,
                                                      got[4]))
        log("[spatial] squeezeDet f32 B=1 {}x{} over {}x{} tiles on the "
            "card (input seed {}): preds, detections and NMS choices equal "
            "the unsharded forward's (max |box diff| {:.3e} px, max |prob "
            "diff| {:.3e}); K1 {} launches; {} halo copies, {} bytes a "
            "forward; {} tiled ops".format(
                cfg.image_width, cfg.image_height, *grid, seed,
                float((got[1].det_boxes - want[1].det_boxes).abs().max()),
                float((got[1].det_probs - want[1].det_probs).abs().max()),
                got[3], got[4], got[5], len(got[6])))

    det16 = get_model("squeezeDet", cfg.replace(compute_dtype="bfloat16"),
                      device="cuda")
    det16.load_state_dict(det.state_dict())
    whole16 = spatial_forward(det16, u8, None)
    tiles16 = spatial_forward(det16, u8, SPATIAL_BF16_GRID)
    k1 += whole16[3] + tiles16[3]
    bf16_noise = float((whole16[0] - want[0]).abs().max())
    tile_err = (tiles16[0] - whole16[0]).abs()
    tile_ulps = float((tile_err / bf16_ulp(whole16[0])).nan_to_num(
        posinf=float("inf")).max())
    log("[spatial] squeezeDet bf16 B=1 over {}x{} tiles: max |raw pred "
        "diff| to the bf16 frame {:.3e} ({:.3g} bf16 ulps of the frame's "
        "value at most; limit {}), the bf16 frame's to the f32 frame "
        "{:.3e}; K1 {} launches".format(
            *SPATIAL_BF16_GRID, float(tile_err.max()), tile_ulps,
            SPATIAL_BF16_ULPS, bf16_noise, tiles16[3]))
    if tile_ulps > SPATIAL_BF16_ULPS or tiles16[3] != \
            SPATIAL_BF16_GRID[0] * SPATIAL_BF16_GRID[1] or \
            not torch.isfinite(tiles16[0]).all():
        raise AssertionError("bf16 tiles disagree with the bf16 frame")

    # (b) the other nets at their published configurations, B=1
    for net in BACKBONES:
        ncfg = config_for_net(net).replace(batch_size=1)
        nshape = (1, ncfg.image_height, ncfg.image_width, 3)
        ndet = rescaled_detector_from(get_model(net, ncfg, device="cuda"),
                                      nshape)
        nseed, nu8, nwant = _separated_frame(ndet, nshape)
        for grid in SPATIAL_BACKBONE_GRIDS:
            got = spatial_forward(ndet, nu8, grid)
            torch.testing.assert_close(got[0], nwant[0], rtol=PRED_RTOL,
                                       atol=PRED_ATOL)
            _assert_same_outputs(got, nwant, "{} {}".format(net, grid),
                                 box_rtol=BACKBONE_BOX_RTOL,
                                 box_atol=BOX_ATOL, prob_atol=PROB_ATOL)
            _check_tiles_kept(got[6], grid, net)
            if got[3] != 0 or got[4] == 0:
                raise AssertionError("{} {}: K1 {}, {} halo copies".format(
                    net, grid, got[3], got[4]))
            log("[spatial] {} f32 B=1 {}x{} over {}x{} tiles (input seed "
                "{}): preds within phase 9's tolerances of the unsharded "
                "forward (max |pred diff| {:.3e}, max |box diff| {:.3e} px); "
                "{} halo copies, {} bytes".format(
                    net, ncfg.image_width, ncfg.image_height, *grid, nseed,
                    float((got[0] - nwant[0]).abs().max()),
                    float((got[1].det_boxes - nwant[1].det_boxes)
                          .abs().max()), got[4], got[5]))
        del ndet
        torch.cuda.empty_cache()

    # (c) whole-net int8 over the int8 eval's grid of SPATIAL_DEVICES
    import numpy as np
    rs = np.random.RandomState(13)
    calib = [torch.from_numpy(rs.randint(0, 256, (2,) + shape[1:],
                                         dtype=np.uint8)).cuda()
             for _ in range(INT8_CALIB_BATCHES)]
    qdet = det.quantize(calib)
    grid = spatial_factors(SPATIAL_DEVICES, cfg.image_height,
                           cfg.image_width)
    xq = qdet.quant_input(u8)
    want_tape, tape = {}, {}
    with torch.inference_mode():
        want_q = qdet.run_backbone(xq, tape=want_tape)
        got_q = qdet.run_backbone(xq, spatial=_tiling(grid), tape=tape)
    same = torch.equal(got_q, want_q) and set(tape) == set(want_tape) and \
        all(torch.equal(tape[n], want_tape[n]) for n in want_tape)
    log("[spatial] whole-net int8 B=1 over spatial_factors({}, {}, {}) = "
        "{}x{} tiles: raw preds and the {}-entry int8 tape {} the unsharded "
        "int8 forward's bit for bit".format(
            SPATIAL_DEVICES, cfg.image_height, cfg.image_width, *grid,
            len(tape), "equal" if same else "DIFFER FROM"))
    if not same:
        raise AssertionError("int8 tiles differ from the int8 frame")
    log("[spatial] (a)-(c) in {:.1f} s on {}".format(
        time.perf_counter() - t_phase, card))
    return k1


def rescaled_detector_from(det, shape):
    """``det`` with its head rescaled as :func:`rescaled_detector` does,
    from one seeded uint8 batch of ``shape`` (one forward on the card)."""
    import numpy as np
    import torch
    u8 = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, shape, dtype=np.uint8)).cuda()
    with torch.no_grad():
        spread = det.predict_raw(u8).pred_box_delta.std().item()
        det.layers()[-1].weight.mul_(HEAD_SPREAD / spread)
    return det


def phase_spatial_eval(card, weights):
    """Phase 13 (d): the eval CLI at batch 1 over SPATIAL_DEVICES tiles
    of the one card, f32 and int8, against --num_devices 1.  Returns the
    K1 launches made."""
    import shutil

    import numpy as np
    import torch

    from squeezedet_torch import eval as eval_cli
    from squeezedet_torch.checkpoint.manager import CheckpointManager
    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.data.synth import write_kitti_fixture
    from squeezedet_torch.models import get_model
    from squeezedet_torch.ops import fused_frontend as ff
    t_phase = time.perf_counter()
    work = os.path.join(HERE, ".chipscratch", "spatial_eval")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    write_kitti_fixture(root, SPATIAL_EVAL_IMAGES, LOOP_FRAME, seed=7,
                        image_set="val", boxes=EVAL_BOXES)
    cfg = kitti_squeezedet_config()
    cpu = get_model("squeezeDet", cfg, device="cpu")
    cpu.backbone.load_state_dict(weights)
    with torch.no_grad():
        u8 = torch.from_numpy(np.random.RandomState(0).randint(
            0, 256, (1, cfg.image_height, cfg.image_width, 3), np.uint8))
        spread = cpu.predict_raw(u8).pred_box_delta.std().item()
        cpu.backbone.conv12.weight.mul_(HEAD_SPREAD / spread)
    ckpt_dir = os.path.join(work, "train")
    CheckpointManager(ckpt_dir).save(EVAL_STEP,
                                     {"params": cpu.backbone.state_dict()})
    real_detect_all, real_eval = eval_cli.detect_all, eval_cli.eval_checkpoint
    runs = {}

    def recording_detect_all(*a, **k):
        runs[key]["detect"] = real_detect_all(*a, **k)
        return runs[key]["detect"]

    def recording_eval(*a, **k):
        runs[key]["aps"] = real_eval(*a, **k)
        return runs[key]["aps"]

    k1 = 0
    eval_cli.detect_all, eval_cli.eval_checkpoint = (recording_detect_all,
                                                     recording_eval)
    try:
        for quant in ("", "int8"):
            for n in (SPATIAL_DEVICES, 1):
                key = (quant, n)
                runs[key] = {}
                before = ff.LAUNCHES
                t0 = time.perf_counter()
                _, out = _logged(eval_cli.main, [
                    "--device", "cuda", "--data_path", root, "--image_set",
                    "val", "--checkpoint_path", ckpt_dir, "--eval_dir",
                    os.path.join(work, "eval_{}_{}".format(quant or "f32",
                                                            n)),
                    "--run_once", "--eval_batch_size", "1", "--num_devices",
                    str(n)] + (["--quantize", "int8", "--calib_batches",
                                str(INT8_EVAL_CALIB)] if quant else []))
                runs[key].update(s=time.perf_counter() - t0, out=out,
                                 k1=ff.LAUNCHES - before)
                k1 += runs[key]["k1"]
    finally:
        eval_cli.detect_all, eval_cli.eval_checkpoint = (real_detect_all,
                                                         real_eval)
    for quant in ("", "int8"):
        tiled, one = runs[(quant, SPATIAL_DEVICES)], runs[(quant, 1)]
        banner = "Evaluating spatially over {} devices".format(
            SPATIAL_DEVICES)
        want_k1 = 0 if quant else SPATIAL_EVAL_IMAGES
        if banner not in tiled["out"] or "spatially" in one["out"] or \
                tiled["k1"] != SPATIAL_DEVICES * want_k1 or \
                one["k1"] != want_k1:
            raise AssertionError("{} eval: banner {}, K1 {} and {}".format(
                quant or "f32", banner in tiled["out"], tiled["k1"],
                one["k1"]))
        got, want = tiled["detect"][0], one["detect"][0]
        for c in range(len(want)):
            for i in range(SPATIAL_EVAL_IMAGES):
                a = np.asarray(sorted(map(tuple, want[c][i])))
                b = np.asarray(sorted(map(tuple, got[c][i])))
                if a.shape != b.shape:
                    raise AssertionError("{} class {} image {}: {} "
                                         "detections tiled, {} on one "
                                         "device".format(quant or "f32", c,
                                                         i, len(b), len(a)))
                if a.size:
                    np.testing.assert_allclose(b, a, rtol=EVAL_BOX_RTOL,
                                               atol=EVAL_BOX_ATOL)
        if tiled["aps"][0] != one["aps"][0]:
            raise AssertionError("{} eval APs {} tiled, {} on one "
                                 "device".format(quant or "f32",
                                                 tiled["aps"][0],
                                                 one["aps"][0]))
        log("[spatial] eval CLI {} B=1 --num_devices {}: '{}', the same "
            "detections image by image and the same APs (mAP {:.6f}) as "
            "--num_devices 1; K1 {} and {}; {:.1f} s and {:.1f} s".format(
                quant or "f32", SPATIAL_DEVICES, banner, tiled["aps"][2],
                tiled["k1"], one["k1"], tiled["s"], one["s"]))
    shutil.rmtree(work, ignore_errors=True)
    log("[spatial] (d) in {:.1f} s on {}".format(
        time.perf_counter() - t_phase, card))
    return k1


def phase_spatial_train(card, weights):
    """Phase 13 (e): the f32 step over (1, SPATIAL_TILES) tiles, the data
    x spatial step over two gloo ranks, and a captured K-step dispatch
    over the tiles, against unsharded steps; then K-step dispatches of
    the data x spatial step over two gloo ranks against their steps one
    at a time.  Returns the K1 launches in this process and the K1 and
    K2 launches the ranks reported."""
    import shutil

    import numpy as np
    import torch

    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.models import get_model
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.parallel import dryrun
    from squeezedet_torch.parallel.mesh import make_mesh_2d
    from squeezedet_torch.trainer import (deterministic,
                                          make_train_step_device,
                                          make_train_step_device_scan)
    t_phase = time.perf_counter()
    work = os.path.join(HERE, ".chipscratch", "spatial_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    k1 = 0
    child = {"k1": 0, "k2": 0}

    def check(got, want, tag, ranks=None):
        torch.testing.assert_close(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL, atol=0)
        zeros = {n: torch.zeros_like(t) for n, t in want["momentum"].items()}
        params = worst_step_ratio(got["params"], want["params"], weights)
        momentum = worst_step_ratio(got["momentum"], want["momentum"],
                                    zeros)
        tiles = SPATIAL_TILES
        log("[spatial] {} vs the unsharded one-process step: loss {} vs "
            "{}; worst leaf ||diff||/||update||: params {:.3e} ({}), "
            "momentum {:.3e} ({}); K1 {}, K2 {}".format(
                tag, [round(float(v), 6) for v in got["loss"]],
                [round(float(v), 6) for v in want["loss"]], *params,
                *momentum, got["k1"], got["k2"]))
        if params[0] > DP_STEP_TOL or momentum[0] > DP_STEP_TOL or \
                got["k1"] != tiles or got["k2"] != 0:
            raise AssertionError("{} disagrees".format(tag))

    for batch, world in ((SPATIAL_STEP_BATCH, 1), (SPATIAL_DP_BATCH, 2)):
        cfg = kitti_squeezedet_config().replace(batch_size=batch)
        det = get_model("squeezeDet", cfg, device="cpu")
        det.backbone.load_state_dict(weights)
        rs = np.random.RandomState(21 + batch)
        u8 = rs.randint(0, 256, (batch, cfg.image_height, cfg.image_width,
                                 3), dtype=np.uint8)
        path = os.path.join(work, "case{}.pt".format(batch))
        dryrun.write_case(path, det, [u8] + [
            t.numpy() for t in gt_batch(rs, batch, cfg)], seed=5,
            device="cuda", spatial=SPATIAL_TILES)
        case = dryrun.load_case(path)
        want = dryrun.one_step(dict(case, spatial=1))
        k1 += want["k1"]
        if world == 1:
            got = dryrun.one_step(case)
            k1 += got["k1"]
            check(got, want, "f32 B={} step over (1, {}) tiles".format(
                batch, SPATIAL_TILES))
            continue
        results = dryrun.step_on_ranks(path, os.path.join(work, "out"),
                                       world)
        for r, got in enumerate(results):
            check(got, want, "f32 global B={} data x spatial step, rank {} "
                  "of {} ({}) over {} tiles".format(
                      batch, r, world, got["backend"], SPATIAL_TILES))
            child["k1"] += got["k1"]
            child["k2"] += got["k2"]

    # a captured K-step dispatch over the tiles against its eager steps
    k = SPATIAL_SCAN_K
    cfg = kitti_squeezedet_config().replace(batch_size=SPATIAL_STEP_BATCH)
    rs = np.random.RandomState(31)
    inputs = []
    for _ in range(SPATIAL_DISPATCHES):
        gts = [gt_batch(rs, SPATIAL_STEP_BATCH, cfg) for _ in range(k)]
        inputs.append([torch.from_numpy(rs.randint(
            0, 256, (k, SPATIAL_STEP_BATCH, cfg.image_height,
                     cfg.image_width, 3), dtype=np.uint8))] +
            [torch.stack([g[i] for g in gts]) for i in range(3)])
    tiling = make_mesh_2d(1, SPATIAL_TILES, "cuda").tiling()
    runs = {}
    with deterministic():  # as the train loop runs its steps
        for kind in ("eager", "graph"):
            state = fresh_state(cfg, "cuda", weights)
            gen = torch.Generator(device="cuda").manual_seed(6)
            before = ff.LAUNCHES, fg.LAUNCHES
            t0 = time.perf_counter()
            if kind == "eager":
                one = make_train_step_device(state, uint8_ingest=True,
                                             spatial=tiling)
                losses = [torch.stack([torch.stack(list(one(
                    *(x[i].cuda() for x in d), generator=gen)))
                    for i in range(k)]) for d in inputs]
            else:
                scan = make_train_step_device_scan(
                    state, k, uint8_ingest=True, spatial=tiling)
                losses = [torch.stack(list(scan(*d, generator=gen)), dim=1)
                          for d in inputs]
            torch.cuda.synchronize()
            runs[kind] = dict(state=state, gen=gen,
                              losses=torch.stack(losses).cpu(),
                              s=time.perf_counter() - t0,
                              k1=ff.LAUNCHES - before[0],
                              k2=fg.LAUNCHES - before[1])
            k1 += runs[kind]["k1"]
    eager, graph = runs["eager"], runs["graph"]
    torch.testing.assert_close(graph["losses"], eager["losses"],
                               rtol=LOSS_RTOL, atol=0)
    params = worst_step_ratio(graph["state"].det.backbone.state_dict(),
                              eager["state"].det.backbone.state_dict(),
                              weights)
    momentum = worst_step_ratio(
        graph["state"].opt.trace, eager["state"].opt.trace,
        {n: torch.zeros_like(t) for n, t in eager["state"].opt.trace.items()})
    steps = k * SPATIAL_DISPATCHES
    log("[spatial] K={} captured dispatches over (1, {}) tiles, f32 B={} "
        "dropout {}, trainer.deterministic: {} steps against the same steps "
        "run eagerly: loss "
        "terms max abs diff {:.3e}; worst leaf ||diff||/||update||: params "
        "{:.3e} ({}), momentum {:.3e} ({}); K1 {} / {}, K2 {} / {} "
        "(eager / captured); {:.2f} s / {:.2f} s".format(
            k, SPATIAL_TILES, SPATIAL_STEP_BATCH, cfg.keep_prob, steps,
            float((graph["losses"] - eager["losses"]).abs().max()),
            *params, *momentum, eager["k1"], graph["k1"], eager["k2"],
            graph["k2"], eager["s"], graph["s"]))
    if params[0] > DP_STEP_TOL or momentum[0] > DP_STEP_TOL or \
            not torch.equal(eager["gen"].get_state(),
                            graph["gen"].get_state()) or \
            eager["k1"] != SPATIAL_TILES * steps or \
            graph["k1"] != SPATIAL_TILES * steps or eager["k2"] or \
            graph["k2"]:
        raise AssertionError("captured dispatches over tiles disagree with "
                             "their eager steps")
    del runs
    torch.cuda.empty_cache()
    # the data x spatial dispatches: two gloo ranks of SPATIAL_TILES tiles
    # each, a chain of graphs split at the host all-reduces
    try:
        child["k1"] += gloo_scan_check(
            work, kitti_squeezedet_config().replace(
                batch_size=SPATIAL_DP_BATCH), weights, k, steps, 32,
            "spatial", card, spatial=SPATIAL_TILES)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("[spatial] (e) in {:.1f} s on {}".format(
        time.perf_counter() - t_phase, card))
    return k1, child


def check_k1_tiles(card):
    """Phase 13 (f): K1 against its plain version on every tile window
    of the SPATIAL_K1_GRIDS tilings at 1248x384 (the pool bounds the
    model's tiled K1 gives each tile), in f32 (TF32 off) and bf16.
    Returns the max abs error; its launches are not counted."""
    import torch

    from squeezedet_torch.models import halo
    from squeezedet_torch.ops import fused_frontend as ff
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = 384, 1248
    hc, wc, hp, wp = ff.geometry(h, w)[:4]
    err, checked = 0.0, 0
    with torch.inference_mode():
        for n_h, n_w in SPATIAL_K1_GRIDS:
            rows = halo.next_bounds(halo.next_bounds(
                halo.image_bounds(h, h // 16, n_h), 2, hc), 2, hp)
            cols = halo.next_bounds(halo.next_bounds(
                halo.image_bounds(w, w // 16, n_w), 2, wc), 2, wp)
            for q in zip(rows, rows[1:]):
                for p in zip(cols, cols[1:]):
                    win, geo = ff.tile_geometry(h, w, q, p)
                    for seed, dtype in ((31, torch.float32),
                                        (32, torch.bfloat16)):
                        err = max(err, check_k1(1, h, w, dtype, seed,
                                                window=win, geo=list(geo)))
                        checked += 1
    log("[spatial] K1 on {} tile windows of {} at {}x{}: within the K1 "
        "check's tolerances of its plain version, max abs err {:.3e}; on "
        "{}".format(checked, SPATIAL_K1_GRIDS, w, h, err, card))
    return err


def spatial_readings(card, weights):
    """Phase 13 (f), not counted and not held to a limit: B=1 forward ms
    at SPATIAL_READ_TILES height tiles on the one card (CUDA events; the
    tiles share the card, so not a scaling figure), each forward's halo
    copies and bytes, and K1 at the tile shapes beside its bound."""
    import numpy as np
    import torch

    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.models import get_model
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.models import halo
    cfg = kitti_squeezedet_config().replace(batch_size=1)
    rs = np.random.RandomState(41)
    u8 = torch.from_numpy(rs.randint(0, 256, (1, cfg.image_height,
                                              cfg.image_width, 3),
                                     dtype=np.uint8)).cuda()
    rows = []
    for dtype in ("float32", "bfloat16"):
        det = get_model("squeezeDet", cfg.replace(compute_dtype=dtype),
                        device="cuda")
        det.backbone.load_state_dict(weights)
        for n in SPATIAL_READ_TILES:
            tiling = _tiling((n, 1)) if n > 1 else None
            copies, nbytes = halo.COPIES, halo.BYTES
            det.predict_raw(u8, tiling)
            copies, nbytes = halo.COPIES - copies, halo.BYTES - nbytes
            ms = cuda_ms(lambda: det.predict_raw(u8, tiling), 20, warmup=3)
            rows.append({"dtype": dtype, "tiles": n, "ms": ms,
                         "halo_copies": copies, "halo_bytes": nbytes})
            log("[spatial] reading, tiles sharing one card (not a scaling "
                "figure): squeezeDet {} B=1 uint8 -> interpretation over "
                "{}x1 tiles: {:.4f} ms a forward; {} halo copies, {} bytes "
                "a forward; on {}".format(dtype, n, ms, copies, nbytes,
                                          card))
    k = torch.from_numpy(rs.randn(3, 3, 3, 64).astype(np.float32)).cuda()
    b = torch.from_numpy(rs.randn(64).astype(np.float32)).cuda()
    hp = ff.geometry(cfg.image_height, cfg.image_width)[2]
    for n in SPATIAL_READ_TILES[1:]:
        q = (hp // n, 2 * hp // n)  # tile 1's pool rows
        p = (0, ff.geometry(cfg.image_height, cfg.image_width)[3])
        (r, c), geo = ff.tile_geometry(cfg.image_height, cfg.image_width,
                                       q, p)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rs.randn(1, r[1] - r[0], c[1] - c[0], 3)
                                 .astype(np.float32)).cuda().to(dtype)
            ms = cuda_ms(lambda: ff.conv1_pool1(x, k, b, list(geo)), 20)
            plain = cuda_ms(lambda: ff.conv1_pool1_reference(
                x, k, b, list(geo)), 20)
            bound_ms, by = k1_bound(1, x.shape[1], x.shape[2],
                                    f32=dtype == torch.float32, geo=geo)
            log("[spatial] K1 on tile 1 of {}x1 ({}x{} input "
                "window -> {}x{} pooled) {}: {:.4f} ms, plain {:.4f} ms, "
                "bound {:.4f} ms ({}); on {}".format(
                    n, x.shape[1], x.shape[2], geo[2], geo[3],
                    str(dtype).split(".")[1], ms, plain, bound_ms, by, card))
    return rows


def probe_header(header):
    """Whether g++ finds ``header`` on its include path."""
    import shutil
    import tempfile
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return False
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "probe.cc")
        with open(src, "w") as f:
            f.write("#include <{}>\n".format(header))
        return subprocess.run([cxx, "-fsyntax-only", src],
                              capture_output=True).returncode == 0


def _final_state(train_dir):
    """(params, momentum) of a train dir's newest checkpoint."""
    from squeezedet_torch.checkpoint.manager import (CheckpointManager,
                                                     latest_step)
    tree = CheckpointManager(train_dir)._load(latest_step(train_dir))
    return tree["params"], tree["opt_state"]["momentum"]


def _cli(argv, echo=False):
    """``squeezedet_torch.train.main(argv)`` with its output captured
    (logged when ``echo``); returns (state, output, K1, K2 launches)."""
    import contextlib
    import io

    from squeezedet_torch import train as cli
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.ops import fused_frontend as ff
    launches = ff.LAUNCHES, fg.LAUNCHES
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            state = cli.main(argv)
    except BaseException:
        log(buf.getvalue().rstrip())
        raise
    if echo:
        log(buf.getvalue().rstrip())
    return (state, buf.getvalue(), ff.LAUNCHES - launches[0],
            fg.LAUNCHES - launches[1])


def phase_determinism(card, root, work):
    """Phase 14 (a): the train CLI straight for DET_STEPS steps against
    DET_SPLIT steps plus a resume, in each DET_MODES mode at each
    DET_KS steps per dispatch: params and momentum bit for bit.  Returns
    the forwards (one K1 launch each) and K2 launches it ran."""
    import torch
    forwards = k2_total = 0
    for k in DET_KS:
        for name, extra in DET_MODES:
            argv = DET_ARGV + ["--data_path", root, "--steps_per_dispatch",
                               str(k)] + extra
            runs, k1, k2, t0 = {}, 0, 0, time.perf_counter()
            for tag, steps in (("straight", [DET_STEPS]),
                               ("resumed", [DET_SPLIT, DET_STEPS])):
                train_dir = os.path.join(work, "det_{}_{}_{}".format(
                    k, name.split()[0], tag))
                for stop in steps:
                    state, out, a, b = _cli(argv + [
                        "--train_dir", train_dir, "--max_steps", str(stop)])
                    k1, k2 = k1 + a, k2 + b
                    if state.step != stop:
                        raise AssertionError("{} K={} {} ended at step "
                                             "{}".format(name, k, tag,
                                                         state.step))
                if tag == "resumed" and \
                        "Resumed from step {}".format(DET_SPLIT) not in out:
                    raise AssertionError("{} K={}: no resume".format(name,
                                                                     k))
                runs[tag] = _final_state(train_dir)
            differ = [n for want, got in zip(runs["straight"],
                                             runs["resumed"])
                      for n in want if not torch.equal(want[n], got[n])]
            steps = 2 * DET_STEPS
            per_step = K2_PER_STEP["1x1"] if "--pallas_grads" in extra \
                else 0
            log("[determinism] train CLI B={} 1248x384 {} K={}: {} steps "
                "straight vs {} + a resume to {}: params and momentum "
                "{}; K1 {} launches for {} forwards, K2 {} ({} a step); "
                "{:.1f} s on {}".format(
                    DET_BATCH, name, k, DET_STEPS, DET_SPLIT, DET_STEPS,
                    "equal bit for bit" if not differ else
                    "DIFFER in {} leaves ({})".format(len(differ),
                                                      differ[:4]),
                    k1, steps, k2, per_step, time.perf_counter() - t0, card))
            if differ or k1 != steps or k2 != per_step * steps:
                raise AssertionError("{} K={}: resumed run differs or "
                                     "launches miscounted".format(name, k))
            forwards, k2_total = forwards + steps, k2_total + k2
    return forwards, k2_total


def phase_native_loader(card, root, work):
    """Phase 14 (b): the native loader's build and the header probe, a
    train CLI run that it feeds, its batches against the Python reader's,
    host ms a batch for both, and the eval CLI through it.  Returns the
    forwards (K1) and K2 launches of its runs."""
    import re
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from squeezedet_torch import eval as eval_cli
    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.data import imdb as imdb_mod
    from squeezedet_torch.data.kitti import Kitti
    from squeezedet_torch.native import dataloader
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.ops import fused_frontend as ff
    probe = {h: probe_header(h) for h in ("opencv2/imgcodecs.hpp", "png.h",
                                          "zlib.h")}
    t0 = time.perf_counter()
    dataloader.load()
    log("[native] headers on this host: {}; loader built as the zlib PNG "
        "decoder (no OpenCV) by g++ {} {} in {:.1f} s -> {}".format(
            probe, " ".join(dataloader.CXX_FLAGS),
            " ".join(dataloader.LIBS), time.perf_counter() - t0,
            dataloader.library_path().name))

    # the train CLI: the --device_assign f32 feed, read by the library
    decodes = []
    real_read = imdb_mod.read_frame

    def counted(path):
        decodes.append(path)
        return real_read(path)
    imdb_mod.read_frame = counted
    before = dataloader.BATCHES
    train_dir = os.path.join(work, "native_train")
    try:
        state, out, k1, k2 = _cli(NATIVE_ARGV + [
            "--data_path", root, "--train_dir", train_dir], echo=True)
    finally:
        imdb_mod.read_frame = real_read
    batches = dataloader.BATCHES - before
    steps = state.step
    log("[native] train CLI --native_loader --device_assign --pallas_grads "
        "B={} bf16: {} steps, the loader loaded {} batches ({} prefetched "
        "beyond the last step), the Python decoder {} frames; K1 {} "
        "launches for {} forwards, K2 {} ({} a step)".format(
            DET_BATCH, steps, batches, batches - steps, len(decodes), k1,
            steps, k2, K2_PER_STEP["1x1"]))
    if decodes or batches < steps or k1 != steps or \
            k2 != K2_PER_STEP["1x1"] * steps:
        raise AssertionError("the native loader did not feed every batch")

    # a native batch against the Python reader's on the same frames
    cfg = kitti_squeezedet_config().replace(batch_size=DET_BATCH)
    py = Kitti("train", root, cfg, rng=np.random.RandomState(3))
    nat = Kitti("train", root, cfg.replace(use_native_loader=True),
                rng=np.random.RandomState(3))
    worst = 0.0
    for _ in range(2):  # augmented train batches
        p = py.read_batch_raw_targets(max_gt=MAX_GT)
        n = nat.read_batch_raw_targets(max_gt=MAX_GT)
        if not all(np.array_equal(a, b) for a, b in zip(p[2:], n[2:])) or \
                not np.allclose(p[1], n[1], rtol=1e-5, atol=1e-4):
            raise AssertionError("native and Python GT targets differ")
        worst = max(worst, float(np.abs(p[0] - n[0]).max()))
    p_img, p_sc = py.read_image_batch(shuffle=False)
    n_img, n_sc = nat.read_image_batch(shuffle=False)
    worst = max(worst, max(float(np.abs(a - b).max())
                           for a, b in zip(p_img, n_img)))
    scale_err = float(np.abs(np.asarray(n_sc) / np.asarray(p_sc) - 1).max())
    log("[native] B={} batches of 1242x375 PNGs at 1248x384, native vs the "
        "Python reader (OpenCV): pixels max |diff| {:.3e} (tolerance "
        "{:.0e}), scales max rel diff {:.3e} (1e-6), GT equal".format(
            DET_BATCH, worst, NATIVE_PIXEL_ATOL, scale_err))
    if worst > NATIVE_PIXEL_ATOL or scale_err > 1e-6:
        raise AssertionError("native pixels or scales off the Python "
                             "reader's")

    # host ms a batch: one batch alone, and 4 readers in parallel (the
    # prefetch loader's workers)
    def per_batch(db, threads, n):
        t = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda _: db.read_batch_raw_targets(
                max_gt=MAX_GT), range(n)))
        return (time.perf_counter() - t) * 1e3 / n
    ms = {}
    for name, db in (("python", py), ("native", nat), ("native", nat),
                     ("python", py)):
        ms.setdefault(name, []).append((per_batch(db, 1, 2),
                                        per_batch(db, 4, 8)))
    log("[native] host ms a B={} 1242x375 -> 1248x384 f32 augmented batch "
        "(python, native, native, python turns): Python reader (OpenCV) "
        "{} alone / {} with 4 readers; native loader (4 threads a batch) "
        "{} alone / {} with 4 readers; on the host of {}".format(
            DET_BATCH, [round(a, 3) for a, _ in ms["python"]],
            [round(b, 3) for _, b in ms["python"]],
            [round(a, 3) for a, _ in ms["native"]],
            [round(b, 3) for _, b in ms["native"]], card))

    # the eval CLI at B=8, native against the Python reader
    forwards, reads = steps, {}
    for name, extra in (("python", []), ("native", ["--native_loader"])):
        launches = ff.LAUNCHES, fg.LAUNCHES
        _, eval_out = _logged(eval_cli.main, [
            "--device", "cuda", "--data_path", root, "--image_set",
            "train", "--checkpoint_path", train_dir, "--eval_dir",
            os.path.join(work, "eval_" + name), "--run_once",
            "--eval_batch_size", str(NATIVE_EVAL_BATCH), "--skip_analysis",
            "--image_width", "1248", "--image_height", "384"] + extra)
        batches = -(-DET_IMAGES // NATIVE_EVAL_BATCH)
        reads[name] = float(re.findall(r"im_read: (\S+)s", eval_out)[-1])
        k1 = ff.LAUNCHES - launches[0]
        mean_ap = float(re.findall(r"Mean average precision: (\S+)",
                                   eval_out)[-1])
        if k1 != batches or fg.LAUNCHES != launches[1] or \
                not np.isfinite(mean_ap):
            raise AssertionError("eval {}: K1 {} for {} batches, mAP "
                                 "{}".format(name, k1, batches, mean_ap))
        forwards += batches
    log("[native] eval CLI B={} on {} frames: im_read {:.3f} ms a batch "
        "with --native_loader against {:.3f} with the Python reader; K1 "
        "once a batch".format(NATIVE_EVAL_BATCH, DET_IMAGES,
                              reads["native"] * 1e3, reads["python"] * 1e3))
    return forwards, k2


def phase_import(card, work):
    """Phase 14 (c): a caffe pickle of seeded weights through
    ``squeezedet-torch-import`` into a port checkpoint; the card's forward
    from it against the forward from the same weights in memory.  Returns
    the forwards (K1 launches)."""
    import pickle

    import numpy as np
    import torch

    from squeezedet_torch import trainer
    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.demo import load_params
    from squeezedet_torch.models import get_model
    from squeezedet_torch.ops import fused_frontend as ff
    from squeezedet_torch.tools import import_checkpoint
    from squeezedet_torch.weights import pickle_from_jax_params, to_jax_params
    cfg = kitti_squeezedet_config()
    weights = get_model("squeezeDet", cfg, device="cpu",
                        generator=torch.Generator().manual_seed(14)
                        ).backbone.state_dict()
    pkl = os.path.join(work, "weights.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(pickle_from_jax_params(to_jax_params(weights)), f)
    ckpt = os.path.join(work, "imported")
    _logged(import_checkpoint.main, ["--checkpoint", pkl, "--out_dir", ckpt,
                                     "--step", "87000"])
    u8 = torch.from_numpy(np.random.RandomState(14).randint(
        0, 256, (2, cfg.image_height, cfg.image_width, 3),
        dtype=np.uint8)).cuda()
    memory = get_model("squeezeDet", cfg, device="cuda")
    memory.backbone.load_state_dict(weights)
    imported, _ = _logged(load_params, get_model("squeezeDet", cfg,
                                                 device="cuda"), ckpt)
    before = ff.LAUNCHES
    with trainer.deterministic():
        got, want = imported.predict_raw(u8), memory.predict_raw(u8)
    torch.cuda.synchronize()
    k1 = ff.LAUNCHES - before
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log("[import] caffe pickle -> squeezedet-torch-import -> {}: the f32 "
        "B=2 1248x384 forward on the card from it {} the in-memory "
        "weights' forward; K1 {} launches for 2 forwards".format(
            os.path.basename(ckpt) + "/model.ckpt-87000",
            "equals" if same else "DIFFERS from", k1))
    if not same or k1 != 2:
        raise AssertionError("the imported checkpoint's forward differs")
    return 2


def determinism_cost(card, root, work):
    """Phase 14 (d), not counted: the cost of deterministic mode, in turns
    over COST_VARIANTS (off; on; on without the NaN fill of new tensors,
    ``torch.utils.deterministic.fill_uninitialized_memory``): the B=20
    bf16 step at K=1 and the train CLI at K=8 --device_dataset
    --pallas_grads.  Returns {variant: [ms/step]} of each."""
    import contextlib

    import numpy as np
    import torch
    import torch.utils.deterministic as det_mode

    from squeezedet_torch import trainer
    from squeezedet_torch.config import kitti_squeezedet_config
    from squeezedet_torch.models import get_model
    from squeezedet_torch.models import layers as L
    decorated = trainer.train

    @contextlib.contextmanager
    def variant(name):
        """The variant's mode around a step, and the loop the CLI runs."""
        fill = det_mode.fill_uninitialized_memory
        det_mode.fill_uninitialized_memory = name == "on"
        trainer.train = decorated.__wrapped__ if name == "off" else decorated
        try:
            with contextlib.nullcontext() if name == "off" else \
                    trainer.deterministic():
                yield
        finally:
            det_mode.fill_uninitialized_memory = fill
            trainer.train = decorated

    cfg = kitti_squeezedet_config().replace(compute_dtype="bfloat16",
                                            learning_rate=1e-3)
    weights = get_model("squeezeDet", cfg, device="cpu").backbone.state_dict()
    rs = np.random.RandomState(15)
    batches = [[torch.from_numpy(rs.randint(
        0, 256, (DET_BATCH, 384, 1248, 3), dtype=np.uint8)).cuda()] +
        [t.cuda() for t in gt_batch(rs, DET_BATCH, cfg)]
        for _ in range(COST_STEPS)]
    turns = COST_VARIANTS + COST_VARIANTS[::-1]
    step_ms = {name: [] for name in COST_VARIANTS}
    L.set_filter_grad("1x1")
    try:
        for name in turns:
            state = fresh_state(cfg, "cuda", weights)
            step = trainer.make_train_step_device(state, uint8_ingest=True)
            gen = torch.Generator(device="cuda").manual_seed(1)
            with variant(name):
                for b in batches[:COST_WARMUP]:
                    step(*b, generator=gen)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches[COST_WARMUP:]:
                    step(*b, generator=gen)
                torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3 /
                                 (COST_STEPS - COST_WARMUP))
    finally:
        L.set_filter_grad(False)
    log("[cost] B={} bf16 step at K=1 (make_train_step_device, uint8 "
        "ingest, mode 1x1, dropout on), ms/step over {} steps, in turns "
        "{}: {}; on {}".format(
            DET_BATCH, COST_STEPS - COST_WARMUP, turns,
            {n: [round(v, 3) for v in ms] for n, ms in step_ms.items()},
            card))

    # the train CLI at K=8, its dispatches timed
    calls = []
    real_scan = trainer.make_train_step_device_scan

    def timed_scan(*a, **k):
        fn = real_scan(*a, **k)

        def call(*x, **y):
            calls.append(time.perf_counter())
            return fn(*x, **y)
        return call
    cli_ms = {name: [] for name in COST_VARIANTS}
    trainer.make_train_step_device_scan = timed_scan
    try:
        for i, name in enumerate(turns):
            calls.clear()
            with variant(name):
                _cli(COST_CLI_ARGV + ["--data_path", root, "--train_dir",
                                      os.path.join(work, "cost{}".format(i))])
            gaps = np.diff(calls[2:]) * 1e3 / COST_CLI_K
            cli_ms[name].append(float(gaps.mean()))
    finally:
        trainer.make_train_step_device_scan = real_scan
    log("[cost] train CLI B={} bf16 --device_dataset --pallas_grads at "
        "K={}, ms/step over the dispatches after the capture, in turns "
        "{}: {}; on {}".format(
            DET_BATCH, COST_CLI_K, turns,
            {n: [round(v, 3) for v in ms] for n, ms in cli_ms.items()},
            card))
    return step_ms, cli_ms


def phase_host_paths(card):
    """Phase 14: deterministic training, the native loader and the
    checkpoint import, on one fixture.  Returns (forwards, K2 launches)
    of the counted runs; the cost readings follow, not counted."""
    import shutil

    from squeezedet_torch.data.synth import write_kitti_fixture
    t_phase = time.perf_counter()
    work = os.path.join(HERE, ".chipscratch", "host_paths")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    write_kitti_fixture(root, DET_IMAGES, LOOP_FRAME, seed=14)
    try:
        forwards, k2 = phase_determinism(card, root, work)
        f, k = phase_native_loader(card, root, work)
        forwards, k2 = forwards + f, k2 + k
        forwards += phase_import(card, work)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    log("[host] phase 14 (a)-(c) in {:.1f} s on {}".format(
        time.perf_counter() - t_phase, card))
    return forwards, k2, work, root


def main():
    # cuBLAS' deterministic workspace, before anything touches CUDA (the
    # train paths run under trainer.deterministic, as the train CLI sets)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import_port()
    import torch
    card = phase_device()
    tc = phase_build()
    k1 = phase_k1(card)
    k2 = phase_k2(card)

    from squeezedet_torch.models import get_model
    from squeezedet_torch.models import layers as L
    from squeezedet_torch.ops import filter_grad as fg
    from squeezedet_torch.ops import fused_frontend as ff

    # serving path: counts from 0 just before it, read just after
    ff.LAUNCHES = fg.LAUNCHES = 0
    forwards = phase_main_path(card)
    forwards += phase_server()
    serve = {"k1": ff.LAUNCHES, "k2": fg.LAUNCHES}
    if serve["k1"] == 0 or serve["k1"] != forwards or serve["k2"] != 0:
        raise AssertionError("serving path: K1 launches {k1}, K2 launches "
                             "{k2}, {0} forwards".format(forwards, **serve))

    # train path, from one set of seeded weights
    from squeezedet_torch.config import kitti_squeezedet_config
    weights = get_model("squeezeDet", kitti_squeezedet_config(),
                        device="cpu").backbone.state_dict()
    cfg = kitti_squeezedet_config()
    ff.LAUNCHES = fg.LAUNCHES = 0
    steps = phase_train_check(weights, cfg)
    steps += phase_train_modes(weights, cfg, 20, K2_PER_STEP)
    run_steps, run_k2 = phase_train_run(card, weights)
    L.set_filter_grad(False)
    train = {"k1": ff.LAUNCHES, "k2": fg.LAUNCHES}
    want_k2 = K2_PER_STEP[True] + sum(K2_PER_STEP.values()) + run_k2
    steps += run_steps
    if train["k1"] != steps or train["k2"] == 0 or train["k2"] != want_k2:
        raise AssertionError("train path: K1 launches {k1} for {0} steps, "
                             "K2 launches {k2}, expected {1}".format(
                                 steps, want_k2, **train))
    log("[train] path: {} steps, K1 launches {}, K2 launches {}".format(
        steps, train["k1"], train["k2"]))

    # train loop through the CLI: counts from 0 just before it
    ff.LAUNCHES = fg.LAUNCHES = 0
    loop_run = phase_train_loop(card)
    loop = {"k1": ff.LAUNCHES, "k2": fg.LAUNCHES}
    if loop["k1"] != loop_run["forwards"] or \
            loop["k2"] != K2_PER_STEP["1x1"] * loop_run["steps"]:
        raise AssertionError("train loop: K1 launches {k1} for {0} forwards, "
                             "K2 launches {k2} for {1} steps".format(
                                 loop_run["forwards"], loop_run["steps"],
                                 **loop))
    log("[loop] path: {} steps, K1 launches {}, K2 launches {}".format(
        loop_run["steps"], loop["k1"], loop["k2"]))

    # eval and demo from a checkpoint: counts from 0 just before them
    ff.LAUNCHES = fg.LAUNCHES = 0
    forwards, eval_weights = phase_eval_demo(card)
    evald = {"k1": ff.LAUNCHES, "k2": fg.LAUNCHES}
    if evald["k1"] != forwards or evald["k2"] != 0:
        raise AssertionError("eval and demo: K1 launches {k1} for {0} "
                             "forwards, K2 launches {k2}".format(forwards,
                                                                 **evald))
    log("[eval] path: {} forwards (eval batches and demo frames), K1 "
        "launches {}, K2 launches {}".format(forwards, evald["k1"],
                                             evald["k2"]))
    probe_eval_shapes(card, eval_weights)

    # the other backbones: K2 at their shapes (not counted), then the
    # paths, with the counts from 0 just before them
    k2_err, k2_rows = phase_k2_backbones(card)
    ff.LAUNCHES = fg.LAUNCHES = 0
    want_k2 = phase_backbones(card)
    backbones = {"k1": ff.LAUNCHES, "k2": fg.LAUNCHES}
    if backbones["k1"] != 0 or backbones["k2"] != want_k2:
        raise AssertionError("other backbones: K1 launches {k1}, K2 launches "
                             "{k2}, expected 0 and {0}".format(
                                 want_k2, **backbones))
    log("[backbones] path: K1 launches {}, K2 launches {}".format(
        backbones["k1"], backbones["k2"]))

    # int8 and the exported artifact: counts from 0 just before them
    ff.LAUNCHES = fg.LAUNCHES = 0
    want_k1, qdet, det16 = phase_int8_export(card, eval_weights)
    int8 = {"k1": ff.LAUNCHES, "k2": fg.LAUNCHES}
    if int8["k1"] != want_k1 or int8["k2"] != 0:
        raise AssertionError("int8 and export: K1 launches {k1}, expected "
                             "{0}; K2 launches {k2}".format(want_k1, **int8))
    log("[int8] path: K1 launches {}, K2 launches {}".format(
        int8["k1"], int8["k2"]))
    int8_layer_table(qdet, det16, card)
    del qdet, det16
    torch.cuda.empty_cache()

    # data parallelism: counts from 0 just before it; the ranks, in their
    # own processes, report theirs
    ff.LAUNCHES = fg.LAUNCHES = 0
    want_k1, ranks = phase_data_parallel(card, weights)
    if ff.LAUNCHES != want_k1 or fg.LAUNCHES != 0:
        raise AssertionError("data parallelism: K1 launches {}, expected {}; "
                             "K2 launches {}".format(ff.LAUNCHES, want_k1,
                                                     fg.LAUNCHES))
    dp = {"k1": ff.LAUNCHES + ranks["k1"], "k2": fg.LAUNCHES + ranks["k2"]}
    log("[dp] path: K1 launches {} ({} in this process, {} on the ranks), "
        "K2 launches {} (on the ranks)".format(dp["k1"], ff.LAUNCHES,
                                               ranks["k1"], dp["k2"]))

    # K steps per dispatch as captured CUDA graphs: counts from 0 just
    # before it; the NCCL rank, in its own process, reports its own
    ff.LAUNCHES = fg.LAUNCHES = 0
    steps, gloo_k1 = phase_graph_step(card, weights)
    forwards, backwards, nccl = phase_graph_cli(card)
    learn_steps, eval_batches = phase_learning(card)
    want_k1 = steps + forwards + learn_steps + eval_batches
    want_k2 = K2_PER_STEP["1x1"] * (steps + backwards)
    if ff.LAUNCHES != want_k1 or fg.LAUNCHES != want_k2:
        raise AssertionError("captured dispatches: K1 launches {}, expected "
                             "{}; K2 launches {}, expected {}".format(
                                 ff.LAUNCHES, want_k1, fg.LAUNCHES, want_k2))
    graph = {"k1": ff.LAUNCHES + nccl["k1"] + gloo_k1,
             "k2": fg.LAUNCHES + nccl["k2"]}
    log("[graph] path: K1 launches {} ({} on the NCCL rank, {} on the gloo "
        "ranks), K2 launches {} ({} on the NCCL rank)".format(
            graph["k1"], nccl["k1"], gloo_k1, graph["k2"], nccl["k2"]))

    # spatial partitioning, every tile on the card: counts from 0 just
    # before it; the gloo ranks, in their own processes, report theirs
    ff.LAUNCHES = fg.LAUNCHES = 0
    want_k1 = phase_spatial_forward(card, weights)
    want_k1 += phase_spatial_eval(card, weights)
    step_k1, ranks = phase_spatial_train(card, weights)
    want_k1 += step_k1
    if ff.LAUNCHES != want_k1 or fg.LAUNCHES != 0 or ranks["k2"] != 0:
        raise AssertionError("spatial partitioning: K1 launches {}, expected "
                             "{}; K2 launches {} here, {} on the "
                             "ranks".format(ff.LAUNCHES, want_k1,
                                            fg.LAUNCHES, ranks["k2"]))
    spatial = {"k1": ff.LAUNCHES + ranks["k1"], "k2": fg.LAUNCHES}
    log("[spatial] path: K1 launches {} ({} on the gloo ranks), K2 "
        "launches {}".format(spatial["k1"], ranks["k1"], spatial["k2"]))
    k1_tile_err = check_k1_tiles(card)
    spatial_readings(card, weights)

    # the host paths (deterministic resume, native loader, import):
    # counts from 0 just before them; the cost readings after, uncounted
    import shutil
    ff.LAUNCHES = fg.LAUNCHES = 0
    forwards, want_k2, work, root = phase_host_paths(card)
    host = {"k1": ff.LAUNCHES, "k2": fg.LAUNCHES}
    if host["k1"] != forwards or host["k2"] != want_k2:
        raise AssertionError("host paths: K1 launches {k1} for {0} "
                             "forwards, K2 launches {k2}, expected {1}".format(
                                 forwards, want_k2, **host))
    log("[host] path: K1 launches {}, K2 launches {}".format(host["k1"],
                                                             host["k2"]))
    try:
        determinism_cost(card, root, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(json.dumps({"kernels": [{
        "name": "conv1_pool1",
        "route": "cuda",
        "source": "squeezedet_torch/csrc/conv1_pool1.cu",
        "replaces": "squeezedet_tpu/ops/fused_frontend.py:161",
        "launches": serve["k1"] + train["k1"] + loop["k1"] + evald["k1"]
        + backbones["k1"] + int8["k1"] + dp["k1"] + graph["k1"]
        + spatial["k1"] + host["k1"],
        "tensor_core_instructions": tc["conv1_pool1"],
        **dict(k1, max_abs_err=max(k1["max_abs_err"], k1_tile_err)),
    }, {
        "name": "filter_grad",
        "route": "cuda",
        "source": "squeezedet_torch/csrc/filter_grad.cu",
        "replaces": "squeezedet_tpu/ops/filter_grad.py:113",
        "launches": train["k2"] + loop["k2"] + backbones["k2"] + dp["k2"]
        + graph["k2"] + spatial["k2"] + host["k2"],
        "tensor_core_instructions": tc["filter_grad"],
        **dict(k2, max_abs_err=max(k2["max_abs_err"], k2_err)),
        "backbone_shapes": k2_rows,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
