#!/usr/bin/env python3
"""Smoke test of basedet_tpu_torch on one NVIDIA GPU:

    python3 chip_smoke.py [--profile DIR]

Run from the root of the repository. Phases, each of which raises on failure:
  1. device: require CUDA, print the card's name and power limit. The script
     sets no precision: the port's models and train step run in IEEE f32
     (TF32 off) by themselves, or under the bf16 policy where a phase's
     config asks for it, and phases 7, 8, 9c, 12, 12b, 17 and 22 hold them
     to the CPU;
  2. build the kernels afresh, in parallel: basedet_tpu_torch/csrc/nms.cu,
     csrc/matching.cu, csrc/roi_align.cu (RoIAlign's forward and backward
     in one library), csrc/fused_bn.cu (the fused 1x1-GEMM + BN-statistics
     forward and backward), csrc/scatter_rows.cu (the DCN row scatter) and
     csrc/iou.cu (pairwise IoU), with their ptxas reports;
  3. hold the NMS kernel to its plain PyTorch version on the card, exactly,
     on random batches at the YOLOX eval shape, at Faster R-CNN's three
     shapes (the RPN's at eval, K = 4819, and at training, B = 2 and
     K = 8819, and the final class-aware NMS, K = 2000), at RetinaNet's
     final NMS (K = 5000) and on edge cases (among them the word-blocked
     sweep's: K = 63, 64, 65 and 4097, invalid boxes on word edges,
     interleaved and filling a word, nothing suppressed, a chain of
     suppressions); time both, with the
     mask and sweep launches apart (profiler);
  4. the same for the SimOTA matching kernel, at the train slice's shape
     (8, 100, 8400) and on edge cases and one 832x832 case;
  4b. hold the RoIAlign kernel to its plain version within 1e-5 of
     max(1, max|F|), at Faster R-CNN's eval shape (B = 1 and 2, R = 1000,
     C = 256, the levels of an 800x1344 input), on edge cases (C = 256, 100
     and 6) and on channels-last features; time both, and split the call's
     device time (profiler) into the kernel's and anything else's, which
     must be nothing (the kernel reads the FPN's NCHW levels in place);
  4c. hold the RoIAlign backward kernel to its plain version within 2e-5 of
     max(1, max|dF|) (ROI_BWD_RTOL says why not 1e-5), at Faster R-CNN's train shape (B = 2, R = 512, C = 256)
     on proposal-like RoIs, on edge cases and on 512 identical RoIs (the most
     contended atomics); time both;
  5. drive training through its entry point: det_train on full-width YOLOX-S
     (random weights from a seed, spread as for eval), batch 8 of 640x640
     with the multiscale resize live (832x832 on these steps), 4 steps; check
     the matching kernel ran once per step and its plain version never, the
     losses are finite and the checkpoints written; then hold the kernel to
     its plain version on the cost and ious of the run's first step;
  6. drive the eval slice through its entry point: det_test on det_train's
     dumped weights over 8 requests of one 640x640 image, checking the NMS
     kernel ran, the plain version did not, and NMS suppressed;
  7. hold the card's inference to a CPU run of the same weights and image;
  8. hold one train step on the card to one on the CPU, same weights and
     batch of 2 at 640x640: losses, foreground anchors, gradient norm, BN
     statistics;
  9. time YOLOX-S f32 inference at batch 1 and batch 32, and one f32 train
     step at batch 8 of 640x640 split into its parts, with peak memory;
  9a. hold the fused 1x1-GEMM + BN-statistics kernels, forward and backward,
     to their plain versions on the 36 fused calls of a bf16 YOLOX-S train
     forward at batch 8 of 640x640 (every distinct shape, real activations)
     and on edge cases (ragged M, 1-4 raw inputs, act + raw, K = N = 512,
     K and N not multiples of 64, ds = dss = 0, and a raw term of 7 and of 13
     inputs at YOLOX-M's and YOLOX-X's depths; the strip kernels' M = 1, 127
     and 129 and N = K = 8; YOLOX-M, -L and -X's dark5 conv3, N = 768-1280,
     and 16 raw inputs at N = 640, where the backward streams w), within
     FUSED_SUM_RTOL, and two runs of each kernel bit-equal on every case;
     time the backward where it streams w; time each shape, kernel (the forward
     called as training calls it: inputs needing gradients, gradients on),
     plain version and the yardsticks (torch.matmul + column sums for the
     forward, two torch.matmul a term for the backward), and sum them over a
     step; replay the step's 36 forward calls in order: events time,
     fwd_kernel's device time (profiler) and host time per call, then events
     and host time with gradients off; replay its 36 backward calls in one
     torch.autograd.grad pass, as a train step's backward runs them: events
     time, the device time of everything they run and operations per call
     (profiler), host time per call, and the yardstick's events and device
     time on the same calls in order;
  9b. det_train --amp TRAINER.AMP.FUSED_BN True on full-width YOLOX-S, 4
     steps of 8 images (832x832 after the multiscale resize): 36 forward and
     36 backward fused launches per step, the matching kernel once, plain
     versions never; then the kernels held to their plain versions, within
     FUSED_SUM_RTOL, on the first backward call of each distinct 832x832
     shape, with the inputs and cotangents the step gave it; then det_test
     on its dumped_model.pt, in f32;
  9c. one bf16 train step with the fused chain, batch of 2, on the card with
     the kernels, on the card with their plain versions in their place, and
     on the CPU (plain versions): the kernels held to their plain versions on
     each of the card step's 36 calls (FUSED_SUM_RTOL); foreground agreement,
     then on the CPU's assignment the card's losses, gradient and BN
     statistics against both other steps (AMP_*: the gradient may turn no
     further than bf16 turns it from an f32 step on the CPU);
  9d. time the bf16 train step at batch 8 of 640x640 with the fused chain off
     and on, beside the f32 step, with the fused kernels' share and peak
     memory;
 10. with --profile DIR only: a torch.profiler pass over YOLOX-S inference
     at both batch sizes and over the train step of phases 9 and 9d (f32,
     bf16 with the fused chain off and on), kernel tables written to DIR,
     busy time and idle share;
 11. Faster R-CNN R50-FPN (full width, random weights from a seed with the
     frozen BN statistics, affine and biases spread) through det_train:
     batch 2 of 800x1333, 4 steps; check that per step the RoIAlign forward
     kernel, its backward kernel and the NMS kernel each ran once and the
     plain versions never, that the losses are finite and that the sampled
     RoIs landed on every level P2-P5; then det_test on its dumped weights
     over 8 requests of one 800x1333 image: the RoIAlign kernel 8 times, the
     NMS kernel 16, their plain versions never, proposals on every level;
 12. hold its card inference to a CPU run of the same weights and image:
     proposals and detections slot by slot;
 12b. hold one train step on the card to one on the CPU, same weights, batch
     and sampling noise (drawn once, copied): the RPN labels and losses
     directly, and the R-CNN stages, the total's gradient norm included, on
     the CPU run's proposals (a few proposal slots differ between the
     devices, after which the two would sample other RoIs);
 13. time its inference at batch 1 and batch 8, split into backbone+FPN,
     RPN+proposals, RoIAlign, box head and post-process, with peak memory;
     and one train step at batch 2, split by the module's stage methods,
     with the RoIAlign backward's own time, images/s and peak memory;
 14. CenterNet R50-DCNv2 (full width, random weights from a seed with BN,
     biases and the DCN offset branches spread) through det_train: batch 16
     of 512x512, 4 steps; check that the scatter kernel ran three times per
     step (once per DCN stage, in the backward) and its plain version never,
     the losses are finite and the checkpoints written; keep the first
     step's three scatter calls;
 15. hold the scatter kernel to its plain version within SCATTER_RTOL of the
     sum of |values| per element on those three calls (the step's own row
     ids and cotangents, f32 and cast to bf16) and on edge cases (all
     entries on one row, empty rows, out-of-range indices, N and D off the
     tile, D = 12, B = 1), two kernel runs bit-equal each time; time each
     stage's call, its sort glue, the plain version and index_add_;
 16. det_test on its dumped weights over 8 requests of one 512x512 image;
 17. card against CPU on a batch of 2 at full width: eval head outputs and
     detections, then one train forward and backward: losses, gradient
     norm, new BN running statistics;
 18. time its train step at batch 16, split into backbone, the three
     deconvolution stages, heads, targets + losses, backward (with the
     scatter calls' share) and SGD, with peak memory; with --profile, a
     profiler pass over that step;
 19. RetinaNet R50-FPN (full width, random weights from a seed with the
     frozen BN statistics and affine and the biases spread, the class biases
     by 2 around the prior) through det_train: batch 2 of 800x1333, 4 steps;
     check that the IoU kernel ran once per step (the anchor assignment, 100
     padded gts x 201,600 anchors per image) and its plain version never,
     the losses are finite, every step has foreground and ignored anchors
     and the run low-quality matches; keep the IoU calls' arguments;
 20. hold the IoU kernel to its plain version, max |diff| 0, on the first
     step's own gts and anchors, at Faster R-CNN's RPN shape (2, 100,
     268569), SimOTA's (8, 100, 8400), the 2-D (300, 130) and on edge cases
     (zero-area, inverted, identical, touching and disjoint boxes,
     coordinates up to 1e4, M = 1, N off the block); time both at the four
     shapes beside the bound;
 21. det_test on its dumped weights over 8 requests of one 800x1333 image:
     the NMS kernel 8 times at K = 5000, its plain version never, NMS
     suppressing, detections on every request;
 22. card against CPU, f32: det_test's first request
     stage by stage (res3-res5, P3-P7, per-level logits and offsets) and its
     detections; one train forward and backward at batch 2: anchor labels,
     losses, gradient norm;
 23. time its train step at batch 2, split into backbone+FPN, head, the IoU
     kernel alone, the assignment, the losses, backward and SGD, with peak
     memory; after the other models' timing, its inference at batch 1 and
     8 (network, per-level top-1000 + decode, NMS + rescale); with
     --profile, a profiler pass over the train step;
 24. print the kernel report (eight kernels in six sources), the card, and
     the result line.
"""
import argparse
import concurrent.futures
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
CONFIG = "basedet_tpu_torch/playground/yolox_s/config.py"
FRCNN_CONFIG = "basedet_tpu_torch/playground/faster_rcnn_r50_1x/config.py"
FRCNN_IMAGE = (800, 1333)  # padded to 800x1344: P2 200x336 ... P6 13x21
FRCNN_RPN_K, FRCNN_RPN_T = 1000 * 4 + 13 * 21 * 3, 0.7  # 4 levels x top-1000 + all of P6
FRCNN_FINAL_K, FRCNN_FINAL_T = 2000, 0.5
FRCNN_TRAIN_B, FRCNN_TRAIN_R = 2, 512  # MODEL.BATCHSIZE, RCNN.NUM_ROIS
FRCNN_TRAIN_RPN_K = 2000 * 4 + 13 * 21 * 3  # 4 levels x TRAIN_PREV_NMS_TOPK + all of P6
FRCNN_ANCHORS = 3 * (200 * 336 + 100 * 168 + 50 * 84 + 25 * 42 + 13 * 21)  # 268,569 at 800x1344
FRCNN_CANDIDATES = 1000 + 100  # TRAIN_POST_NMS_TOPK proposals + MAX_INSTANCES gt rows
RPN_LABEL_AGREE = 0.999
# RoIAlign backward against its plain version, as a share of max(1, max|dF|). 1e-5 holds where a
# pixel sums a few hundred terms; the proposal-like case's 102 zero-area padding RoIs all land on
# P2's corner pixel, which sums ~5,000 terms to |dF| ~ 195: there the kernel measured 5.4e-6 off the
# plain version and 2.3e-6 off its own second run (the atomics' order), too close to 1e-5 to hold
# on every run (NVIDIA H100 80GB HBM3, 700.00 W)
ROI_BWD_RTOL = 2e-5
ROI_R, ROI_C, ROI_STRIDES = 1000, 256, (4, 8, 16, 32)
ROI_LEVELS = [(200, 336), (100, 168), (50, 84), (25, 42)]
FRCNN_ATOL, FRCNN_AGREE = 1e-3, 0.95
# NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores, dense bf16 tensor cores
PEAK_BYTES_PER_S, PEAK_F32_PER_S, PEAK_BF16_PER_S = 3.35e12, 67e12, 989e12
SLICE_B, SLICE_K, SLICE_T = 8, 3000, 0.65  # YOLOX-S eval: 3 levels x top-1000, IoU 0.65
HEAD_ATOL = 1e-3
MATCH_B, MATCH_K, MATCH_M = 8, 100, 8400  # YOLOX-S train: batch 8, MAX_INSTANCES 100, 640x640
MATCH_M_832 = 104 * 104 + 52 * 52 + 26 * 26  # anchors at 832x832
LOSS_RTOL, FG_AGREE, GRAD_NORM_RTOL, STATS_RTOL = 1e-3, 0.999, 1e-3, 1e-4
RETINA_CONFIG = "basedet_tpu_torch/playground/retinanet_r50_1x/config.py"
RETINA_B = 2  # MODEL.BATCHSIZE
RETINA_LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]  # P3-P7 at 800x1344
RETINA_ANCHORS = 9 * sum(h * w for h, w in RETINA_LEVELS)  # 201,600
RETINA_FINAL_K, RETINA_FINAL_T = 5 * 1000, 0.5  # top-1000 per level, TEST.IOU_THRESHOLD
LABEL_AGREE = 0.999
CNET_CONFIG = "basedet_tpu_torch/playground/centernet_r50/config.py"
CNET_B, CNET_IMAGE, CNET_PARITY_B = 16, (512, 512), 2  # the config's batch; maps of 128x128
# Kernel #9 against its plain version: both add each row's entries in f32 in the original n order (bf16
# values convert exactly), so they should agree bit for bit; each output element is held to 4 f32 ulps of
# the sum of the |values| that land on it
SCATTER_RTOL = 4 * 2.0 ** -23
# The fused kernels against their plain versions: every output is an f32 sum taken in another
# order (tensor-core tiles and partial rows against cuBLAS and PyTorch's reductions), so each is
# held to FUSED_SUM_RTOL of the sum of the magnitudes of its terms, propagated through the
# prologue and epilogue, plus one ulp of its own dtype where it is rounded to bf16
FUSED_SUM_RTOL = 2.0 ** -17
# One bf16 train step with the fused chain (batch 2 of 640x640), card against CPU and kernels against their
# plain versions on the card. Train-mode YOLOX-S with random weights amplifies a perturbation ~300 times into
# the gradient (f32 card vs CPU: 2e-5 of the norm from ~6e-8 rounding), and bf16 rounds every element: the
# CPU's bf16 gradient lies 1.11 of its norm from its f32 one on one assignment, cosine 0.43. Any difference of
# rounding therefore spreads to that size: the kernels' step lies 0.685 of the norm from its plain-version
# step though every one of its calls lies within FUSED_SUM_RTOL of its plain version, cuDNN's against
# oneDNN's 0.70 (NVIDIA H100 80GB HBM3, 700.00 W). So the gradient is held to turn less than bf16 itself
# turns it (its cosine at least the CPU's bf16-vs-f32 cosine; measured 0.75 and 0.73), the losses to
# AMP_LOSS_RTOL (measured 5.9e-3 and 6.1e-3) and the new BN running statistics to AMP_STATS_RTOL (6.1e-4 and
# 5.2e-4 of max(|value|, 1)); foreground agreement on each device's own assignment (SimOTA's near-ties)
AMP_LOSS_RTOL, AMP_FG_AGREE, AMP_STATS_RTOL = 3e-2, 0.995, 1e-2


def log(msg=""):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, iters, warmup=2, attempts=3, names=()):
    """Every device operation fn runs, from torch.profiler: (device ms per
    call of fn, operations (kernels, memsets, copies) per call, {name: device
    ms per call}). A profiler pass now and then reports no kernels at all (its
    records arrive after the pass): a pass that reports nothing, or none of
    the operations whose name contains one of ``names``, is repeated, up to
    ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        key = "self_device_time_total" if len(averages) and hasattr(averages[0], "self_device_time_total") \
            else "self_cuda_time_total"
        ops = [e for e in averages if getattr(e, key) > 0]
        found = {e.key: getattr(e, key) / 1000 / iters for e in ops}
        if ops and all(any(n in k for k in found) for n in names):
            return sum(found.values()), sum(e.count for e in ops) / iters, found
    raise RuntimeError(f"chip_smoke: the profiler saw no device time for some of {names or 'the operations'} in "
                       f"{attempts} passes")


def device_ms(fn, iters, names, warmup=2):
    """Device time per call of fn, by kernel, from torch.profiler: {name: ms}
    summed over the kernels whose name contains name, for each of names."""
    found = device_kernels(fn, iters, warmup, names=names)[2]
    return {n: sum(v for k, v in found.items() if n in k) for n in names}


def host_us(fn, calls, passes=20):
    """Host time of fn per call it makes (``calls`` calls a pass): median of
    ``passes`` passes, each started on an idle card, as a printable range."""
    host = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    host.sort()
    return host[len(host) // 2], f"{host[len(host) // 2]:.1f} us per call (median of {passes} passes, " \
                                 f"{host[0]:.1f}-{host[-1]:.1f})"


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this smoke test needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | process TF32 settings left as "
        f"they are (cudnn {torch.backends.cudnn.allow_tf32}, matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}); the model runs f32 itself")
    return card


def bound(bytes_moved, ops, peak_ops=PEAK_F32_PER_S):
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over their peak rate (f32 unless given), whichever is
    larger, and which."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from basedet_tpu_torch.ops import (_build, fused_bn_kernel, iou_kernel, matching_kernel, nms_kernel,
                                       roi_align_kernel, scatter_rows_kernel)

    sources = [nms_kernel.SOURCE, matching_kernel.SOURCE, roi_align_kernel.SOURCE, fused_bn_kernel.SOURCE,
               scatter_rows_kernel.SOURCE, iou_kernel.SOURCE]
    for source in sources:
        _build.library_path(source).unlink(missing_ok=True)  # show the build from this checkout

    def build(source):
        t0 = time.perf_counter()
        path, report = _build.build_library(source)
        return source, path, report, time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build, sources))
    log(f"[build] {len(sources)} kernels in {time.perf_counter() - t0:.2f} s, one nvcc each in "
        f"parallel (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for source, path, report, seconds in built:
        log(f"[build] {source.relative_to(source.parents[2])} -> {path.name} in {seconds:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")


def _random_boxes(rng, B, K, clustered):
    """(B, K, 4) xyxy boxes on a 640x640 canvas; clustered ones jitter around
    a few dozen objects, so many pairs sit near the IoU threshold."""
    if clustered:
        centers = rng.uniform(0, 640, (B, 40, 2))
        sizes = rng.uniform(10, 200, (B, 40, 2))
        pick = rng.randint(0, 40, (B, K))
        c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 4, (B, K, 2))
        s = np.take_along_axis(sizes, pick[..., None], 1) * rng.uniform(0.85, 1.15, (B, K, 2))
        xy1, xy2 = c - s / 2, c + s / 2
    else:
        xy1 = rng.uniform(0, 640, (B, K, 2))
        xy2 = xy1 + rng.uniform(1, 640 / 3, (B, K, 2))
    return np.concatenate([xy1, xy2], -1).astype(np.float32)


def _kernel_cases():
    rng = np.random.RandomState(SEED)
    cases = []
    for seed in range(4):
        boxes = _random_boxes(rng, SLICE_B, SLICE_K, clustered=seed % 2 == 1)
        cases.append((f"slice seed{seed}", boxes, rng.uniform(size=(SLICE_B, SLICE_K)) > 0.1, SLICE_T))
    cases.append(("K=1037", _random_boxes(rng, 3, 1037, True), rng.uniform(size=(3, 1037)) > 0.3, 0.5))
    for name, K, t in (("frcnn rpn", FRCNN_RPN_K, FRCNN_RPN_T), ("frcnn final", FRCNN_FINAL_K, FRCNN_FINAL_T),
                       ("frcnn rpn train", FRCNN_TRAIN_RPN_K, FRCNN_RPN_T),
                       ("retinanet final", RETINA_FINAL_K, RETINA_FINAL_T)):
        cases.append((name, _random_boxes(rng, 2, K, True), rng.uniform(size=(2, K)) > 0.05, t))
    cases.append(("K=1", _random_boxes(rng, 2, 1, False), np.ones((2, 1), bool), SLICE_T))
    cases.append(("all invalid", _random_boxes(rng, 2, 500, True), np.zeros((2, 500), bool), SLICE_T))
    same = np.broadcast_to(np.float32([10, 20, 110, 220]), (2, 300, 4)).copy()
    cases.append(("identical boxes", same, np.arange(300)[None].repeat(2, 0) % 7 != 0, SLICE_T))
    # equal scores: a stable sort keeps index order among the ties
    boxes = _random_boxes(rng, 2, 2000, True)
    scores = np.round(rng.uniform(size=(2, 2000)), 1)
    order = np.argsort(-scores, axis=1, kind="stable")
    cases.append(("equal scores", np.take_along_axis(boxes, order[..., None], 1), np.ones((2, 2000), bool), SLICE_T))
    edge = np.float32([[0, 0, 10, 10], [0, 0, 10, 5], [20, 0, 30, 10], [20, 0, 30, 7.5]])
    tiled = np.concatenate([edge + 40 * i for i in range(32)])[None]  # inter == t*union exactly
    for t in (0.5, 0.75):
        cases.append((f"inter == {t}*union", tiled, np.ones(tiled.shape[:2], bool), t))
    # the word-blocked sweep's edges: K around one 64-box word and past 64 words, invalid boxes on
    # word boundaries, interleaved and filling a word, nothing suppressed
    rng = np.random.RandomState(SEED + 8)
    for K in (63, 64, 65, 4097):
        cases.append((f"K={K}", _random_boxes(rng, 2, K, True), rng.uniform(size=(2, K)) > 0.1, 0.5))
    boxes = _random_boxes(rng, 2, 320, True)
    at_edges = np.ones((2, 320), bool)
    at_edges[:, [0, 63, 64, 127, 128, 191, 255, 256, 319]] = False
    cases.append(("invalid at word edges", boxes, at_edges, 0.5))
    cases.append(("invalid interleaved", boxes, np.arange(320)[None].repeat(2, 0) % 2 == 1, 0.5))
    cases.append(("one word all invalid", boxes, np.arange(320)[None].repeat(2, 0) // 64 != 2, 0.5))
    grid = np.stack(np.meshgrid(np.arange(20) * 30.0, np.arange(15) * 30.0), -1).reshape(-1, 2)
    disjoint = np.concatenate([grid, grid + 20], 1).astype(np.float32)[None].repeat(2, 0)
    cases.append(("all disjoint", disjoint, np.ones(disjoint.shape[:2], bool), 0.3))
    # box k suppresses k + 1 and not k + 2: the sweep's Jacobi rounds do not settle on these words
    x = 3.0 * np.arange(150, dtype=np.float32)
    chain = np.stack([x, np.zeros_like(x), x + 10, np.full_like(x, 10)], 1)[None].repeat(2, 0)
    cases.append(("suppression chain", chain, np.ones(chain.shape[:2], bool), 0.5))
    return cases


def nms_bound(valid, keep):
    """NMS's bound on valid (B, K) and this run's keep (B, K): boxes and
    valid read once, keep written once; ~15 f32 operations per IoU test, and
    the fewest tests greedy NMS needs on this data: each kept box against
    every kept box before it, each suppressed valid box against one (its
    suppressor)."""
    B, K = valid.shape
    kept = keep.sum(1).double()
    suppressed = valid.sum(1).double() - kept
    return bound(B * K * (16 + 1 + 1), 15 * float((kept * (kept - 1) / 2 + suppressed).sum()))


def _nms_split(boxes, valid, t):
    """The NMS call's two launches apart: device time per call of the mask
    kernel and of the sweep, from the profiler."""
    from basedet_tpu_torch.ops.nms_kernel import nms_keep

    dev = device_ms(lambda: nms_keep(boxes, valid, t), 10, ("nms_mask_kernel", "nms_sweep_kernel"))
    return (f"device: mask kernel {dev['nms_mask_kernel']:.4f} ms, sweep {dev['nms_sweep_kernel']:.4f} ms "
            f"(profiler)")


def phase_kernel(card):
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain

    worst = 0
    for name, boxes, valid, t in _kernel_cases():
        b = torch.from_numpy(np.ascontiguousarray(boxes)).cuda()
        v = torch.from_numpy(np.ascontiguousarray(valid)).cuda()
        got, ref = nms_keep(b, v, t), nms_keep_plain(b, v, t)
        torch.cuda.synchronize()
        diff = int((got != ref).sum())
        worst = max(worst, int((got.int() - ref.int()).abs().max()))
        log(f"[kernel] {name:18s} B={b.shape[0]} K={b.shape[1]} t={t}: "
            f"{int(ref.sum())} kept, {diff} differ")
        check(diff == 0, f"NMS kernel differs from nms_keep_plain on case {name!r}")
    n_cases = len(_kernel_cases())
    rng = np.random.RandomState(SEED + 1)
    b = torch.from_numpy(_random_boxes(rng, SLICE_B, SLICE_K, True)).cuda()
    v = torch.ones(SLICE_B, SLICE_K, dtype=torch.bool, device="cuda")
    ms = cuda_ms(lambda: nms_keep(b, v, SLICE_T), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: nms_keep_plain(b, v, SLICE_T), reps=3, warmup=1)
    keep = nms_keep(b, v, SLICE_T)
    kept = keep.sum(1).tolist()
    bound_ms, bound_by = nms_bound(v, keep)
    log(f"[kernel] {n_cases} cases equal; B={SLICE_B} K={SLICE_K} t={SLICE_T} (clustered, "
        f"kept per image {min(kept)}-{max(kept)} of {SLICE_K}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms per call, bound {bound_ms:.6f} ms "
        f"({bound_by}); {_nms_split(b, v, SLICE_T)} | {card}")
    # the clustered shapes of the main paths, and YOLOX's eval shape on small scattered boxes, where
    # most boxes are kept (as random-weight YOLOX-S keeps ~2,800 of 3,000 in det_test)
    for name, B, K, t, clustered in (("frcnn rpn", 1, FRCNN_RPN_K, FRCNN_RPN_T, True),
                                     ("frcnn final", 1, FRCNN_FINAL_K, FRCNN_FINAL_T, True),
                                     ("frcnn rpn train", FRCNN_TRAIN_B, FRCNN_TRAIN_RPN_K, FRCNN_RPN_T, True),
                                     ("retinanet final", 1, RETINA_FINAL_K, RETINA_FINAL_T, True),
                                     ("yolox most kept", 1, SLICE_K, SLICE_T, False)):
        if clustered:
            b = torch.from_numpy(_random_boxes(rng, B, K, True)).cuda()
        else:
            xy = rng.uniform(0, 640, (B, K, 2))
            b = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(1, 12, (B, K, 2))], -1).astype(np.float32)).cuda()
        v = torch.ones(B, K, dtype=torch.bool, device="cuda")
        k_ms = cuda_ms(lambda: nms_keep(b, v, t), reps=50, warmup=5)
        p_ms = cuda_ms(lambda: nms_keep_plain(b, v, t), reps=2, warmup=1)
        keep = nms_keep(b, v, t)
        check(torch.equal(keep, nms_keep_plain(b, v, t)), f"NMS kernel differs from nms_keep_plain at {name}")
        k_bound, k_by = nms_bound(v, keep)
        log(f"[kernel] {name} B={B} K={K} t={t} ({'clustered' if clustered else 'scattered'}, {int(keep.sum())} "
            f"kept): kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms per call, bound {k_bound:.6f} ms ({k_by}); "
            f"{_nms_split(b, v, t)} | {card}")
    return dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _matching_case(rng, B, K, M, valid):
    """YOLOX-like cost and ious: rows of valid gts get costs 0..30 plus 1e5
    off their centre region and ious peaked near 0, invalid rows cost 1e9
    and iou 0, as YOLOX._assign feeds the kernel."""
    cost = rng.uniform(0, 30, (B, K, M)) + 1e5 * (rng.uniform(size=(B, K, M)) > 0.02)
    ious = rng.uniform(size=(B, K, M)) ** 6
    cost = np.where(valid[..., None], cost, 1e9).astype(np.float32)
    ious = np.where(valid[..., None], ious, 0.0).astype(np.float32)
    return cost, ious, valid


def _matching_cases():
    rng = np.random.RandomState(SEED)
    prefix = lambda B, K, n: np.arange(K)[None].repeat(B, 0) < n
    cases = [(f"slice {n} valid", *_matching_case(rng, MATCH_B, MATCH_K, MATCH_M, prefix(MATCH_B, MATCH_K, n)))
             for n in (3, 40)]
    cost, ious, valid = _matching_case(rng, 2, MATCH_K, MATCH_M, prefix(2, MATCH_K, 40))
    cases.append(("tied costs", np.round(cost, 1), ious, valid))
    cost, ious, valid = _matching_case(rng, 2, 6, MATCH_M, np.ones((2, 6), bool))
    tops = [[0.9, 0.7, 0.6, 0.3, 0.2, 0.1, 0.1, 0.05, 0.03, 0.02], [0.7] * 10, [0.5] * 10,
            [0.1] * 10, [1.0, 1.0, 0.5, 0.5, 0.25, 0.25, 0.25, 0.25, 0.0, 0.0],
            [0.95, 0.9, 0.85, 0.8, 0.7, 0.6, 0.5, 0.4, 0.2, 0.1]]  # sums on or next to integers
    ious = (ious * 0.01).astype(np.float32)
    for g, top in enumerate(tops):
        ious[:, g, rng.permutation(MATCH_M)[:10]] = np.float32(top)
    cases.append(("integer sums", cost, ious, valid))
    cases.append(("invalid rows", *_matching_case(rng, 4, MATCH_K, 2000, rng.uniform(size=(4, MATCH_K)) < 0.3)))
    cases.append(("K=1", *_matching_case(rng, 2, 1, MATCH_M, np.ones((2, 1), bool))))
    cases.append(("M<10", *_matching_case(rng, 2, 5, 7, np.ones((2, 5), bool))))
    cases.append(("832x832", *_matching_case(rng, MATCH_B, MATCH_K, MATCH_M_832, prefix(MATCH_B, MATCH_K, 40))))
    return cases


def _check_matching(name, cost, ious, valid):
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain

    best, fg = dynamic_k_matching(cost, ious, valid)
    torch.cuda.synchronize()
    ref_best, ref_fg = dynamic_k_matching_plain(cost, ious, valid)
    diff = int(((fg != ref_fg) | (best != ref_best)).sum())
    log(f"[match] {name:14s} B={cost.shape[0]} K={cost.shape[1]} M={cost.shape[2]}: "
        f"{int(ref_fg.sum())} foreground anchors, {diff} differ")
    check(diff == 0, f"matching kernel differs from dynamic_k_matching_plain on case {name!r}")
    return int((best - ref_best).abs().max()) + int((fg != ref_fg).sum())


def phase_matching(card):
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain

    cases = _matching_cases()
    worst = max(_check_matching(name, *(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays))
                for name, *arrays in cases)
    times = {}
    for name, *arrays in cases[:2]:
        cost, ious, valid = (torch.from_numpy(a).cuda() for a in arrays)
        ms = cuda_ms(lambda: dynamic_k_matching(cost, ious, valid), reps=50, warmup=5)
        plain_ms = cuda_ms(lambda: dynamic_k_matching_plain(cost, ious, valid), reps=10, warmup=2)
        times[name] = (ms, plain_ms)
        log(f"[match] {name}, B={MATCH_B} K={MATCH_K} M={MATCH_M}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms per call | {card}")
    log(f"[match] {len(cases)} cases equal")
    ms, plain_ms = times["slice 3 valid"]  # det_train's dummy batches carry 3 boxes per image
    valid_rows = int(cases[0][3].sum())
    # cost and ious read once for valid rows, best gt (i32) and fg (bool)
    # written per anchor; ~2 operations per element read
    bound_ms, bound_by = bound(valid_rows * MATCH_M * 8 + MATCH_B * MATCH_M * 5,
                               2 * valid_rows * MATCH_M)
    log(f"[match] bound at 3 valid gts per image: {bound_ms:.5f} ms ({bound_by}) | {card}")
    return dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


@torch.no_grad()
def randomise(module, generator):
    """Draw BN statistics and affine and every conv bias from generator, as
    the CPU tests do, so scores spread out; then raise the box-size biases by
    log 4, so a box spans about four strides as a trained detector's box spans
    an object many anchors wide. Same-class neighbours then overlap and NMS
    suppresses on the main path; with the plain init it keeps everything."""
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    for name, m in module.head.named_children():
        if name.startswith("reg_pred_"):
            m.bias[2:].add_(math.log(4.0))


@contextlib.contextmanager
def recording(owner, name, keep=lambda args, out: args, substitute=None):
    """Replace ``owner.name`` with a wrapper that calls it and records
    ``keep(args, result)`` for each call, returning the result, or
    ``substitute(args)`` in its place where given; put it back on the way
    out."""
    fn, calls = getattr(owner, name), []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(keep(args, out))
        return out if substitute is None else substitute(args)

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, fn)


def nms_counts():
    """Record (valid candidates, kept) per image of every NMS call on the
    path, read from the wrapper's inputs and output on the way through."""
    from basedet_tpu_torch.ops import nms as nms_ops

    return recording(nms_ops, "nms_keep",
                     lambda args, keep: list(zip(args[1].sum(1).tolist(), keep.sum(1).tolist())))


def _kept_range(calls):
    seen = [pair for call in calls for pair in call]
    kept = [k for _, k in seen]
    return f"{min(kept)}-{max(kept)} of {min(v for v, _ in seen)}-{max(v for v, _ in seen)} valid"


def make_weights(out_dir):
    """Full-width YOLOX-S on the card with random weights from SEED, spread
    by ``randomise``, saved as a state_dict. Returns (cfg for det_test,
    model, path)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CONFIG)
    cfg.merge(["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(640,640)",
               "GLOBAL.OUTPUT_DIR", out_dir])
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise(model.module, generator)
    weights = os.path.join(out_dir, "yolox_s_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    return cfg, model, weights


def _train_opts(out_dir, weights):
    return ["DATA.TRAIN.name", "dummy", "MODEL.BATCHSIZE", "8", "AUG.TRAIN_SETTING.INPUT_SIZE",
            "(640,640)", "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH", "32",
            "GLOBAL.LOG_INTERVAL", "1", "MODEL.WEIGHTS", weights, "GLOBAL.OUTPUT_DIR", out_dir,
            "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "ckpt")]


def phase_train(out_dir, weights):
    """det_train on full-width YOLOX-S, 4 steps of 8 images; the matching
    counts are zeroed just before and read just after."""
    from basedet_tpu_torch.layers.common import matcher
    from basedet_tpu_torch.models.det.yolox import YOLOX
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain
    from basedet_tpu_torch.tools import det_train

    keep_inputs = lambda args, out: [a.clone() for a in args[:3]]
    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with recording(matcher, "dynamic_k_matching", keep_inputs) as matched, \
            recording(YOLOX, "get_losses", keep_losses) as losses:
        dynamic_k_matching.launches, dynamic_k_matching_plain.calls = 0, 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", CONFIG, "--device", "cuda", *_train_opts(out_dir, weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain_calls = dynamic_k_matching.launches, dynamic_k_matching_plain.calls

    steps = trainer.state.step
    ckpt = os.path.join(out_dir, "ckpt")
    check(steps == 4 and len(losses) == 4, f"det_train took {steps} steps, not 4")
    check(launches == steps, f"the matching kernel launched {launches} times in {steps} steps")
    check(plain_calls == 0, f"the plain matching ran {plain_calls} times on the main path")
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"det_train wrote no {name}")
    size = trainer.model.extra_meter["img_size"]
    check(matched[0][0].shape[2] == MATCH_M_832 and size == 832, "the multiscale resize did not run")
    per_step = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items())
                         for step in losses)
    log(f"[train] det_train YOLOX-S, 4 steps of 8 images 640x640 resized to {size}x{size} "
        f"(multiscale, RandomState(step // 10)), f32, in {seconds:.2f} s; matching kernel launches "
        f"{launches}, plain calls {plain_calls}; lr {trainer.meters['lr'].latest:.4g} = the floor and "
        f"L1 on: a 1-epoch run lies wholly in the 15-epoch no-aug tail; losses per step: {per_step}; "
        f"checkpoints latest.pt, epoch_1.pt, dumped_model.pt written")
    for i, (cost, ious, valid) in enumerate(matched):
        _check_matching(f"train step {i + 1}", cost, ious, valid)
    return launches, os.path.join(ckpt, "dumped_model.pt")


def phase_slice(out_dir, cfg, weights):
    """det_test on 8 requests; the NMS counts are zeroed just before and
    read just after."""
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.tools import det_test

    opts = ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(640,640)",
            "GLOBAL.OUTPUT_DIR", out_dir]
    nms_keep.launches, nms_keep_plain.calls = 0, 0
    t0 = time.perf_counter()
    with nms_counts() as seen:
        results = det_test.main(["-f", CONFIG, "-w", weights, "--device", "cuda", *opts])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain_calls = nms_keep.launches, nms_keep_plain.calls

    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(len(records) >= 1, "det_test gave no detections")
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    check({r["image_id"] for r in records} == set(range(8)), "not every request was answered")
    check(launches > 0, "the NMS kernel was never launched on the main path")
    check(plain_calls == 0, f"the plain NMS ran {plain_calls} times on the main path")
    check(any(k < v for call in seen for v, k in call), "NMS suppressed nothing on the main path")
    log(f"[slice] det_test YOLOX-S (depth {cfg.MODEL.DEPTH_FACTOR}, width {cfg.MODEL.WIDTH_FACTOR}, "
        f"{cfg.DATA.NUM_CLASSES} classes) with det_train's {os.path.basename(weights)} on 8 requests "
        f"of 640x640: {results}, {len(records)} finite detections in {seconds:.2f} s; "
        f"NMS kernel launches {launches}, plain calls {plain_calls}; "
        f"NMS kept per image {_kept_range(seen)}")
    return launches


def phase_card_vs_cpu(cfg, model, weights):
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_test_dataloader
    from basedet_tpu_torch.utils.compare import match_detections

    cpu = build_model(cfg, "cpu")
    cpu.load_weights(weights)
    batch = next(iter(build_test_dataloader(cfg)))  # det_test's first request
    batch = {k: batch[k] for k in ("data", "im_info")}
    with torch.inference_mode():
        gpu_head = model.module(model.pre_process(batch)["image"])
        cpu_head = cpu.module(cpu.pre_process(batch)["image"])
    err = max(float((g.cpu() - c).abs().max())
              for gl, cl in zip(gpu_head, cpu_head) for g, c in zip(gl, cl))
    check(err <= HEAD_ATOL, f"head outputs differ between card and CPU by {err}")
    gpu = {k: v.cpu().numpy() for k, v in model.inference(batch).items()}
    ref = {k: v.numpy() for k, v in cpu.inference(batch).items()}
    frac = match_detections(ref, gpu)
    check(np.isfinite(gpu["boxes"]).all() and gpu["valid"].any(), "card detections empty or non-finite")
    check(frac >= 0.95, f"only {frac:.3f} of the CPU's detections matched on the card")
    log(f"[parity] card vs CPU, f32, one 640x640 image: head max |diff| {err:.3e} (tol {HEAD_ATOL}); "
        f"{int(ref['valid'].sum())} CPU / {int(gpu['valid'].sum())} card detections, "
        f"{frac:.4f} matched (label, IoU >= 0.999, |dscore| <= 1e-4)")


AMP_OPTS = {None: [], "bf16": ["TRAINER.AMP.ENABLE", "True"],
            "fused": ["TRAINER.AMP.ENABLE", "True", "TRAINER.AMP.FUSED_BN", "True"]}


def _train_setup(weights, device, batch_size, amp=None):
    """YOLOX-S in train mode with ``weights``, its solver, state and step
    (f32, or under the bf16 policy with ``amp`` "bf16" or "fused"), the first
    synthetic batch of ``batch_size`` 640x640 images and the config."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_train_dataloader
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import YOLOXSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CONFIG)
    cfg.merge(["DATA.TRAIN.name", "dummy", "MODEL.BATCHSIZE", str(batch_size), *AMP_OPTS[amp]])
    model = build_model(cfg, device)
    model.load_weights(weights)
    model.train()
    solver = YOLOXSolver.build(cfg)
    state = TrainState(model, solver, ema=True)
    return (model, solver, state, make_train_step(model, solver, cfg), next(build_train_dataloader(cfg)),
            cfg)


def phase_train_vs_cpu(weights):
    """One train step on the card and on the CPU, same weights and batch.
    The gradient norm is read where the step hands the gradients to the
    solver, before the optimizer (whose CUDA path updates some in place)."""
    def grad_norm(args, out):
        return float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in args[0])))

    runs = {}
    for device in ("cuda", "cpu"):
        model, solver, state, step, batch, _ = _train_setup(weights, device, 2)
        with recording(model, "assign", lambda args, out: out[0].cpu()) as fg, \
                recording(solver, "clip_grads", grad_norm) as norm:
            metrics = step(state, batch)
        stats = {k: v.double().cpu() for k, v in model.module.state_dict().items() if "running" in k}
        runs[device] = ({k: float(v) for k, v in metrics.items() if k != "lr"}, fg[0], norm[0], stats)
    (gpu_losses, gpu_fg, gpu_norm, gpu_stats), (cpu_losses, cpu_fg, cpu_norm, cpu_stats) = \
        runs["cuda"], runs["cpu"]
    stats_rel = max(float(((gpu_stats[k] - v).abs() / v.abs().clamp(min=1.0)).max())
                    for k, v in cpu_stats.items())
    rel = {k: abs(gpu_losses[k] - v) / max(abs(v), 1e-12) for k, v in cpu_losses.items() if v != 0}
    agree = float((gpu_fg == cpu_fg).float().mean())
    norm_rel = abs(gpu_norm - cpu_norm) / cpu_norm
    log(f"[parity] train step card vs CPU, f32, batch 2 of 640x640: losses card "
        f"{', '.join(f'{k} {v:.6f}' for k, v in gpu_losses.items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in cpu_losses.items())}, worst rel diff "
        f"{max(rel.values()):.3e} (tol {LOSS_RTOL}); foreground {int(gpu_fg.sum())} card / "
        f"{int(cpu_fg.sum())} CPU anchors, agreement {agree:.6f} of {gpu_fg.numel()} (min {FG_AGREE}); "
        f"gradient norm {gpu_norm:.6f} card / {cpu_norm:.6f} CPU, rel diff {norm_rel:.3e} "
        f"(tol {GRAD_NORM_RTOL}); new BN running statistics differ by {stats_rel:.3e} of "
        f"max(|value|, 1) (tol {STATS_RTOL})")
    check(all(math.isfinite(v) for v in gpu_losses.values()), "non-finite losses on the card")
    check(max(rel.values()) <= LOSS_RTOL, f"train losses differ between card and CPU: {rel}")
    check(agree >= FG_AGREE, f"only {agree:.6f} of the anchors agree on foreground")
    check(norm_rel <= GRAD_NORM_RTOL, f"gradient norms differ by {norm_rel:.3e}")
    check(stats_rel <= STATS_RTOL, f"BN running statistics differ by {stats_rel:.3e}")


AMP_LABELS = {None: "f32", "bf16": "bf16, fused chain off", "fused": "bf16, fused chain on"}


def phase_train_timing(weights, card, amp=None, fused_step=None):
    """One train step at batch 8 of 640x640 (input already on the card,
    multiscale pinned), f32 or under the bf16 policy with the fused chain off
    or on (``amp``), as a total and split by prefix: the forward, the
    assignment alone (the matching kernel inside), get_losses (forward,
    assignment, losses), get_losses with backward, the whole step. With the
    chain on, ``fused_step`` (the fused kernels' times summed over one step's
    calls, from ``phase_fused_kernels``) gives their share of the step."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.precision import policy_from_cfg, precision_policy
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching

    model, _, state, step, batch, cfg = _train_setup(weights, "cuda", 8, amp)
    policy = policy_from_cfg(cfg)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    image = model.pre_process(batch, train=True)["image"]

    def forward():
        with full_f32(), precision_policy(*policy):
            model.module(image)

    def losses():
        with full_f32(), precision_policy(*policy):
            return model.get_losses(batch)[0]

    def losses_backward():
        with full_f32():
            losses().backward()

    with recording(model, "assign", lambda args, out: args) as assigned:
        losses()
    launches, fused = dynamic_k_matching.launches, fused_gemm_stats.launches
    t_fwd = cuda_ms(forward, reps=10, warmup=3)
    t_assign = cuda_ms(lambda: model.assign(*assigned[0]), reps=10, warmup=3)
    t_loss = cuda_ms(losses, reps=10, warmup=3)
    t_fb = cuda_ms(losses_backward, reps=10, warmup=3)
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated()
    check(dynamic_k_matching.launches > launches, "train timing ran no matching kernel")
    check((fused_gemm_stats.launches > fused) == (amp == "fused"),
          f"{AMP_LABELS[amp]} train timing made {fused_gemm_stats.launches - fused} fused launches")
    share = ""
    if fused_step is not None:
        kernels = fused_step["fwd"] + fused_step["bwd"]
        share = (f"; the 36 + 36 fused kernel calls {kernels:.3f} ms of it ({kernels / t_step:.3f} of the "
                 f"step, timed alone)")
    log(f"[timing] YOLOX-S {AMP_LABELS[amp]} train step, batch 8 of 640x640: {t_step:.3f} ms per step "
        f"({8000 / t_step:.1f} img/s): forward {t_fwd:.3f} ms, assignment {t_assign:.3f} ms "
        f"(matching kernel inside), losses {t_loss - t_fwd - t_assign:.3f} ms, backward "
        f"{t_fb - t_loss:.3f} ms, SGD+EMA {t_step - t_fb:.3f} ms (parts are differences of means "
        f"of 10 runs each){share}; peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated), input already on the card | {card}")
    return t_step, lambda: step(state, batch)


# -- fused 1x1-GEMM + BN statistics (kernels #3 and #4) ------------------------------------------

def _bf16_ulp(t):
    """The spacing of bf16 at |t| (t rounded to bf16 first), f32."""
    a = t.float().abs().bfloat16()
    return ((a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float())


def _fused_signature(terms):
    """(spec, M, K per term, N) of a fused call."""
    from basedet_tpu_torch.ops.fused_bn import flatten_terms

    spec, flat = flatten_terms(terms)
    return spec, flat[0].shape[0], tuple(t[2].shape[0] for t in terms), terms[0][2].shape[1]


def _fused_bytes_ops(terms):
    """Bytes (each input read once, each output written once) and tensor
    operations of one fused forward and one backward call."""
    from basedet_tpu_torch.ops.fused_bn import flatten_terms

    _, flat = flatten_terms(terms)
    M, N = flat[0].shape[0], terms[0][2].shape[1]
    inputs = sum(a.numel() * a.element_size() for a in flat)
    ks = sum(t[2].shape[0] for t in terms)
    m_in = sum(a.numel() * 2 for a in flat if a.dim() == 2 and a.shape[0] == M)
    vectors = sum(a.numel() * 4 for a in flat if a.dim() == 1)
    weights = sum(t[2].numel() for t in terms)
    fwd = (inputs + M * N * 2 + 2 * N * 4, 2 * M * ks * N)
    # backward: inputs, y, dy read, ds, dss read; dx per M-tensor (bf16), dw f32, dscale/dshift f32
    bwd = (inputs + 2 * M * N * 2 + 2 * N * 4 + m_in + weights * 4 + vectors, 4 * M * ks * N)
    return fwd, bwd


def check_fused_case(terms, dy, ds, dss):
    """Kernels #3 and #4 against their plain versions on one call. Every
    output's deviation is divided by its tolerance (``FUSED_SUM_RTOL`` of the
    sum of its terms' magnitudes, propagated, plus one ulp where the output is
    bf16); returns the largest such ratio per output, which must be <= 1, and
    the share of y elements that differ and that differ by more than one
    ulp."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.fused_bn import (_dsilu, _prologue, fused_gemm_stats_backward_plain,
                                                fused_gemm_stats_plain)
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats, fused_gemm_stats_backward

    r = FUSED_SUM_RTOL
    mm = lambda a, b: a.float().abs() @ b.float().abs()
    with torch.no_grad(), full_f32():
        y, s, ss = fused_gemm_stats(terms)
        torch.cuda.synchronize()
        yp, sp, ssp = fused_gemm_stats_plain(terms)
        ops = [t[1] if t[0] == "act" else _prologue(t[1])[0] for t in terms]
        absum = sum(mm(a, t[2]) for a, t in zip(ops, terms))
        tol_y = _bf16_ulp(yp) + r * absum
        ratios = {"y": float(((y.float() - yp.float()).abs() / tol_y).max())}
        yf = yp.float()
        tol_s = tol_y.sum(0) + r * yf.abs().sum(0)
        tol_ss = (2 * yf.abs() * tol_y + tol_y * tol_y).sum(0) + r * (yf * yf).sum(0)
        ratios["s"] = float(((s - sp).abs() / tol_s).max())
        ratios["ss"] = float(((ss - ssp).abs() / tol_ss).max())
        diff = y != yp
        ulps = (y.float() - yp.float()).abs() / _bf16_ulp(yp)
        shares = (float(diff.float().mean()), float((ulps > 1.0001).float().mean()))

        got = fused_gemm_stats_backward(terms, yp, dy, ds, dss)
        torch.cuda.synchronize()
        want = fused_gemm_stats_backward_plain(terms, yp, dy, ds, dss)
        dy16 = (dy.float() + ds + 2.0 * yp.float() * dss).to(torch.bfloat16)
        tols = []  # (name, tolerance) in the order of the cotangents
        for t, a in zip(terms, ops):
            w = t[2]
            dact_err = r * mm(dy16, w.t())  # dy_eff @ w^T summed in another order
            if t[0] == "act":
                tols.append(("dx", _bf16_ulp(want[len(tols)]) + dact_err))
            else:
                _, pres, xfs = _prologue(t[1])
                dact = dy16.float() @ w.float().t()
                for (_, sc, _), pre, xf in zip(t[1], pres, xfs):
                    dsilu = _dsilu(pre).abs()
                    g_abs, g_err = dact.abs() * dsilu, dact_err * dsilu
                    tols.append(("dx", _bf16_ulp(want[len(tols)]) + g_err * sc.abs()))
                    tols.append(("dscale", r * (g_abs * xf.abs()).sum(0) + (g_err * xf.abs()).sum(0) + 1e-30))
                    tols.append(("dshift", r * g_abs.sum(0) + g_err.sum(0) + 1e-30))
            tols.append(("dw", _bf16_ulp(want[len(tols)]) + r * mm(a.t(), dy16)))
        errs = {"y": float((y.float() - yp.float()).abs().max())}
        for (name, tol), g, w in zip(tols, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"fused backward: {name} {g.dtype} "
                                                             f"{tuple(g.shape)} vs {w.dtype} {tuple(w.shape)}")
            d = (g.float() - w.float()).abs()
            ratios[name] = max(ratios.get(name, 0.0), float((d / tol).max()))
            errs[name] = max(errs.get(name, 0.0), float(d.max()))
        errs["s"], errs["ss"] = float((s - sp).abs().max()), float((ss - ssp).abs().max())
    return ratios, shares, errs


def check_fused_cases(tag, cases):
    """``check_fused_case`` on each (name, terms, (dy, ds, dss)) of cases,
    a line each; fails if any output lies beyond its tolerance. Returns the
    largest |kernel - plain| per output."""
    worst, worst_err, failed = {}, {}, []
    for name, terms, cts in cases:
        ratios, (share, share_1), errs = check_fused_case(terms, *cts)
        for k, v in ratios.items():
            worst[k] = max(worst.get(k, 0.0), v)
            worst_err[k] = max(worst_err.get(k, 0.0), errs[k])
        log(f"[{tag}] {name:42s} y differs on {share:.5f} of elements ({share_1:.6f} by more than 1 ulp); "
            f"max |kernel - plain| / tolerance: " + ", ".join(f"{k} {errs[k]:.2e}/{v:.3f}" for k, v in ratios.items()))
        if any(v > 1.0 for v in ratios.values()):
            failed.append(name)
    check(not failed, f"fused kernels differ from their plain versions beyond tolerance on {failed}")
    log(f"[{tag}] {len(cases)} cases within tolerance ({FUSED_SUM_RTOL:.3e} of the sums of magnitudes + 1 bf16 "
        f"ulp); worst max |kernel - plain| / tolerance: "
        + ", ".join(f"{k} {worst_err[k]:.3e}/{v:.3f}" for k, v in worst.items()))
    return worst_err


def fused_backward_calls(first_per_shape):
    """Record the fused backward calls as (signature, terms, (dy, ds, dss)),
    cloned: every call's, or with ``first_per_shape`` only the first of
    each signature's (later ones as (signature, None, None))."""
    from basedet_tpu_torch.ops import fused_bn_kernel

    seen = set()

    def keep(args, out):  # _backward(terms, M, N, device, y, dy, ds, dss)
        sig = _fused_signature(args[0])
        if first_per_shape and sig in seen:
            return sig, None, None
        seen.add(sig)
        return sig, _detached_terms(args[0]), tuple(a.detach().clone() for a in args[5:8])

    return recording(fused_bn_kernel, "_backward", keep)


def _case_name(sig):
    return (f"{'+'.join(str(x[1] if x[0] == 'raw' else 'act') for x in sig[0])} M={sig[1]} "
            f"K={'+'.join(map(str, sig[2]))} N={sig[3]}")


def _fused_errs(worst_err):
    """The kernel report's max_abs_err of the forward and the backward."""
    fwd = max(worst_err[k] for k in ("y", "s", "ss"))
    return fwd, max(v for k, v in worst_err.items() if k not in ("y", "s", "ss"))


def _random_fused_terms(gen, spec, M, K, N):
    terms = []
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    for s in spec:
        w = (randn(K, N) * K ** -0.5).bfloat16()
        if s == "act":
            terms.append(("act", randn(M, K).bfloat16(), w))
        else:
            terms.append(("raw", [(randn(M, K).bfloat16(), torch.rand(K, device="cuda", generator=gen) + 0.5,
                                   randn(K) * 0.1) for _ in range(s)], w))
    return terms


def _fused_cotangents(gen, M, N, zero=False):
    if zero:
        return (torch.randn(M, N, device="cuda", generator=gen).bfloat16(),
                torch.zeros(N, device="cuda"), torch.zeros(N, device="cuda"))
    return (torch.randn(M, N, device="cuda", generator=gen).mul(1e-2).bfloat16(),
            torch.randn(N, device="cuda", generator=gen) * 1e-4,
            torch.randn(N, device="cuda", generator=gen) * 1e-5)


def _detached_terms(terms):
    return [(t[0], t[1].detach().clone() if t[0] == "act" else
             [tuple(a.detach().clone() for a in raw) for raw in t[1]], t[2].detach().clone()) for t in terms]


def _grad_terms(terms):
    """Copies of terms whose tensors need gradients, as a train step's do."""
    copy = lambda a: a.detach().clone().requires_grad_(True)
    return [(t[0], copy(t[1]) if t[0] == "act" else [tuple(map(copy, raw)) for raw in t[1]], copy(t[2]))
            for t in terms]


def _fused_repeats(terms, cts):
    """The outputs on which two launches of the fused forward on terms, or
    two of the backward on its y and the cotangents cts, differ in their bits:
    "y", "s", "ss", or "d<i>" for the backward's i-th cotangent."""
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats, fused_gemm_stats_backward

    bits = lambda a: a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(torch.int32)
    with torch.no_grad():
        first = [a.clone() for a in fused_gemm_stats(terms)]
        second = fused_gemm_stats(terms)
        back = [[a.clone() for a in fused_gemm_stats_backward(terms, first[0], *cts)] for _ in range(2)]
    names = ["y", "s", "ss", *(f"d{i}" for i in range(len(back[0])))]
    return [n for n, a, b in zip(names, [*first, *back[0]], [*second, *back[1]]) if not torch.equal(bits(a), bits(b))]


def fused_step_calls(weights):
    """The 36 fused calls of one bf16 train forward of full-width YOLOX-S at
    batch 8 of 640x640, in order: (signature, detached terms, y)."""
    from basedet_tpu_torch.layers.blocks import csp_fused
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.precision import precision_policy

    model, _, _, _, batch, _ = _train_setup(weights, "cuda", 8, amp="fused")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    keep = lambda args, out: (_fused_signature(args[0]), _detached_terms(args[0]), out[0].detach())
    with recording(csp_fused, "fused_gemm_stats", keep) as calls, full_f32(), \
            precision_policy(torch.bfloat16, True):
        model.get_losses(batch)[0].backward()
    check(len(calls) == 36, f"one YOLOX-S forward made {len(calls)} fused calls, not 36")
    return calls


def fused_backward_library(terms, y, dy, ds, dss):
    """Kernel #4's yardstick, which the port never calls: per term
    ``torch.matmul(dy_eff16, w^T)`` and ``torch.matmul(a16^T, dy_eff16)`` on
    bf16 operands computed beforehand (dy_eff and a raw term's prologue), as
    #3's yardstick precomputes its operand."""
    from basedet_tpu_torch.ops.fused_bn import _prologue

    dy16 = (dy.float() + ds + 2.0 * y.float() * dss).to(torch.bfloat16)
    ops = [(t[1] if t[0] == "act" else _prologue(t[1])[0], t[2]) for t in terms]

    def library():
        for a, w in ops:
            torch.matmul(dy16, w.t())
            torch.matmul(a.t(), dy16)

    return library


def fused_backward_replay(calls, gen, card):
    """The step's backward calls as training makes them: each call's forward
    run once through the autograd Function on copies of its inputs that need
    gradients, then the 36 backwards replayed by one ``torch.autograd.grad``
    pass over all of them, on random cotangents of y, s and ss, as a train
    step's backward runs them (the autograd engine, in reverse order of the
    forwards; ``_FusedGemmStats.backward``; the kernels): events time, the
    device time of every operation they run and operations per call
    (profiler), host time per call. Then kernel #4's yardstick on the same
    calls in order: two ``torch.matmul`` a term, events and device time."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.fused_bn import flatten_terms
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats

    outs, leaves, cts, yardsticks = [], [], [], []
    with full_f32():
        for sig, terms, _ in calls:
            train_terms = _grad_terms(terms)
            leaves += flatten_terms(train_terms)[1]
            outs += fused_gemm_stats(train_terms)
            cts += _fused_cotangents(gen, sig[1], sig[3])
            yardsticks.append(fused_backward_library(terms, outs[-3].detach(), *cts[-3:]))

    def replay():
        torch.autograd.grad(outs, leaves, cts, retain_graph=True)

    def library():
        for fn in yardsticks:
            fn()

    with full_f32():
        ms = cuda_ms(replay, reps=20, warmup=3)
        device, ops, names = device_kernels(replay, 5)
        host, host_text = host_us(replay, len(calls))
    with torch.no_grad(), full_f32():
        library_ms = cuda_ms(library, reps=20, warmup=3)
        library_device = device_kernels(library, 5)[0]
    top = ", ".join(f"{n} {v:.4f}" for n, v in sorted(names.items(), key=lambda kv: -kv[1])[:4])
    log(f"[fused] the step's 36 backward calls, as training makes them (one torch.autograd.grad pass through the "
        f"autograd Function): events {ms:.4f} ms, device time of everything they run {device:.4f} ms in "
        f"{ops / len(calls):.2f} operations per call (profiler; {top}), host {host_text}; two torch.matmul a "
        f"term on the same calls in order: events {library_ms:.4f} ms, device {library_device:.4f} ms | {card}")
    return dict(ms=ms, device_ms=device, ops_per_call=ops / len(calls), host_us=host, library_ms=library_ms,
                library_device_ms=library_device, kernels={n: round(v, 5) for n, v in names.items()})


# phase 9a's cases where kernel #4 streams w's rows: its shared memory would not hold them with
# dy_eff over all of N
STREAMED_CASES = ("YOLOX-M dark5 conv3", "YOLOX-L dark5 conv3", "YOLOX-X dark5 conv3", "16 raw N=640")


def fused_streamed_timing(cases, card):
    """Kernel #4 on the cases where it streams w (checked against the plan):
    events and device time a call (profiler), the plain version, the
    yardstick and the bound."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.fused_bn import flatten_terms, fused_gemm_stats_backward_plain
    from basedet_tpu_torch.ops.fused_bn_kernel import MAX_SMEM, backward_smem, fused_gemm_stats, \
        fused_gemm_stats_backward

    check(len(cases) == len(STREAMED_CASES), f"phase 9a lacks some of {STREAMED_CASES}")
    for name, terms, (dy, ds, dss) in cases:
        spec = flatten_terms(terms)[0]
        N = terms[0][2].shape[1]
        check(backward_smem(N, spec, 2) > MAX_SMEM, f"kernel #4 would keep w resident on {name}")
        with torch.no_grad(), full_f32():
            y = fused_gemm_stats(terms)[0]
            call = lambda: fused_gemm_stats_backward(terms, y, dy, ds, dss)
            ms = cuda_ms(call, reps=20, warmup=3)
            device = device_kernels(call, 10)[0]
            plain = cuda_ms(lambda: fused_gemm_stats_backward_plain(terms, y, dy, ds, dss), reps=5, warmup=1)
            library = cuda_ms(fused_backward_library(terms, y, dy, ds, dss), reps=20, warmup=3)
        log(f"[fused] backward, w streamed, {name} (M={y.shape[0]} K={terms[0][2].shape[0]} N={N}): events {ms:.4f} "
            f"ms, device {device:.4f} ms (profiler), plain {plain:.4f}, two torch.matmul a term {library:.4f}, "
            f"bound {bound(*_fused_bytes_ops(terms)[1], PEAK_BF16_PER_S)[0]:.4f} | {card}")


def phase_fused_kernels(weights, card):
    """Kernels #3 and #4 against their plain versions: on the fused calls of
    one bf16 train forward of full-width YOLOX-S at batch 8 of 640x640 (real
    activations, every distinct shape) and on edge cases; then each distinct
    shape timed, kernel, plain version and the library yardsticks, and summed
    over the calls of one step; then the step's forward and backward calls
    replayed in order."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.fused_bn import _prologue, fused_gemm_stats_backward_plain, fused_gemm_stats_plain
    from basedet_tpu_torch.ops.fused_bn_kernel import _card, forward_plan, fused_gemm_stats, fused_gemm_stats_backward

    calls = fused_step_calls(weights)
    first = {}
    for sig, terms, y in calls:
        first.setdefault(sig, terms)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [(f"yolox {_case_name(sig)}", terms, _fused_cotangents(gen, sig[1], sig[3]))
             for sig, terms in first.items()]
    for name, spec, M, K, N in (("M=1037 act", ("act",), 1037, 64, 32), ("M=1037 1 raw", (1,), 1037, 128, 64),
                                ("2 raw", (2,), 4096, 64, 64), ("4 raw", (4,), 4096, 128, 64),
                                ("act + raw", ("act", 1), 2048, 128, 128), ("4 raw + 1 raw", (4, 1), 3000, 256, 512),
                                ("N=512 K=512", ("act",), 3200, 512, 512), ("K=24 N=40", (2,), 777, 24, 40),
                                # conv3's left term at YOLOX-M's depth (dark3: n = 6, so 7 raw inputs) and
                                # YOLOX-X's (dark4: n = 12, so 13), at their widths and batch 8 of 640x640
                                ("7 raw, YOLOX-M dark3", (7,), 8 * 80 * 80, 96, 192),
                                ("13 raw, YOLOX-X dark4", (13,), 8 * 40 * 40, 320, 640),
                                # the strip kernels' edges: one row, a ragged strip, a strip and a
                                # row; one panel of 64 columns, mostly padding
                                ("M=1 act", ("act",), 1, 32, 64), ("M=127 2 raw", (2,), 127, 32, 64),
                                ("M=129 act + raw", ("act", 1), 129, 64, 128),
                                ("N=8 K=8 act", ("act",), 300, 8, 8), ("N=8 K=8 3 raw", (3,), 129, 8, 8),
                                # where the backward streams w's rows: conv3 of the dark5 CSP layer of
                                # YOLOX-M, -L and -X at batch 8 of 640x640 (N = 1024 x width), and a raw
                                # term of 16 inputs, the most a term takes, at N = 640
                                ("YOLOX-M dark5 conv3", (1, 1), 3200, 384, 768),
                                ("YOLOX-L dark5 conv3", (1, 1), 3200, 512, 1024),
                                ("YOLOX-X dark5 conv3", (1, 1), 3200, 640, 1280),
                                ("16 raw N=640", (16,), 12800, 320, 640)):
        cases.append((name, _random_fused_terms(gen, spec, M, K, N), _fused_cotangents(gen, M, N)))
    M, K, N = 5000, 96, 64
    cases.append(("ds = dss = 0", _random_fused_terms(gen, (1, 1), M, K, N), _fused_cotangents(gen, M, N, zero=True)))
    worst_err = check_fused_cases("fused", cases)
    differ = [(name, d) for name, terms, cts in cases if (d := _fused_repeats(terms, cts))]
    check(not differ, f"two runs of the fused kernels differ on {differ}")
    log(f"[fused] two runs of the forward kernel bit-equal in y, s and ss, and of the backward in every "
        f"cotangent, on all {len(cases)} cases")
    fused_streamed_timing([c for c in cases if c[0] in STREAMED_CASES], card)

    times = {}
    for sig, terms in first.items():
        dy, ds, dss = _fused_cotangents(gen, sig[1], sig[3])
        with torch.no_grad(), full_f32():
            y = fused_gemm_stats(terms)[0]
            a_cat = torch.cat([t[1] if t[0] == "act" else _prologue(t[1])[0] for t in terms], 1)
            w_cat = torch.cat([t[2] for t in terms], 0)

            def library():
                yl = torch.matmul(a_cat, w_cat).float()
                return yl.sum(0), (yl * yl).sum(0)

            times[sig] = dict(
                plain=cuda_ms(lambda: fused_gemm_stats_plain(terms), reps=5, warmup=1),
                library=cuda_ms(library, reps=20, warmup=3),
                bwd=cuda_ms(lambda: fused_gemm_stats_backward(terms, y, dy, ds, dss), reps=20, warmup=3),
                bwd_library=cuda_ms(fused_backward_library(terms, y, dy, ds, dss), reps=20, warmup=3),
                bwd_plain=cuda_ms(lambda: fused_gemm_stats_backward_plain(terms, y, dy, ds, dss), reps=5, warmup=1))
        with full_f32():
            train_terms = _grad_terms(terms)
            times[sig]["fwd"] = cuda_ms(lambda: fused_gemm_stats(train_terms), reps=20, warmup=3)
        (fb, fo), (bb, bo) = _fused_bytes_ops(terms)
        times[sig]["bound"] = bound(fb, fo, PEAK_BF16_PER_S)[0]
        times[sig]["bwd_bound"] = bound(bb, bo, PEAK_BF16_PER_S)[0]
        t = times[sig]
        n = sum(1 for c in calls if c[0] == sig)
        plan = forward_plan(sig[1], sig[3], *_card(torch.cuda.current_device()))
        log(f"[fused] {n} x spec {sig[0]} M={sig[1]} K={sig[2]} N={sig[3]} (forward: {plan[0]} panels, "
            f"grid {plan[1]} x {plan[2]}): forward kernel {t['fwd']:.4f} ms "
            f"(bound {t['bound']:.4f}, plain {t['plain']:.4f}, torch.matmul + column sums {t['library']:.4f}); "
            f"backward kernel {t['bwd']:.4f} ms (bound {t['bwd_bound']:.4f}, plain {t['bwd_plain']:.4f}, "
            f"two torch.matmul a term {t['bwd_library']:.4f}) | {card}")
    step = {k: sum(times[c[0]][k] for c in calls) for k in ("fwd", "plain", "library", "bwd", "bwd_plain",
                                                             "bwd_library", "bound", "bwd_bound")}
    step_calls = [_grad_terms(c[1]) for c in calls]

    def replay():
        for terms in step_calls:
            fused_gemm_stats(terms)

    # as det_train --amp calls the kernel: inputs that need gradients, gradients on, each call recorded
    # by autograd; then with gradients off, through the same autograd Function
    with full_f32():
        replay_ms = cuda_ms(replay, reps=20, warmup=3)
        device = device_ms(replay, 5, ("fwd_kernel",))["fwd_kernel"]
        host = host_us(replay, len(step_calls))[1]
    with torch.no_grad(), full_f32():
        replay_nograd_ms = cuda_ms(replay, reps=20, warmup=3)
        host_nograd = host_us(replay, len(step_calls))[1]
    log(f"[fused] the step's 36 forward calls in order, as training makes them (gradients on): events "
        f"{replay_ms:.4f} ms, device time of fwd_kernel {device:.4f} ms (profiler), host {host}; gradients off: "
        f"events {replay_nograd_ms:.4f} ms, host {host_nograd}; bound {step['bound']:.4f} ms, torch.matmul + "
        f"column sums {step['library']:.4f} ms | {card}")
    replay_bwd = fused_backward_replay(calls, gen, card)
    check(replay_bwd["ops_per_call"] <= 2.0, f"the fused backward ran {replay_bwd['ops_per_call']:.2f} device "
                                             f"operations a call, not at most 2")
    fwd_bytes = sum(_fused_bytes_ops(c[1])[0][0] for c in calls)
    bwd_bytes = sum(_fused_bytes_ops(c[1])[1][0] for c in calls)
    log(f"[fused] per train step at batch 8 of 640x640 (36 calls each): forward kernels {step['fwd']:.3f} ms "
        f"(bound {step['bound']:.4f} ms: {fwd_bytes / 1e9:.3f} GB; plain {step['plain']:.3f}, torch.matmul + "
        f"column sums {step['library']:.3f}); backward kernels {step['bwd']:.3f} ms (bound {step['bwd_bound']:.4f} "
        f"ms: {bwd_bytes / 1e9:.3f} GB; plain {step['bwd_plain']:.3f}, two torch.matmul a term "
        f"{step['bwd_library']:.3f}) | {card}")
    by = [[bound(*_fused_bytes_ops(c[1])[i], PEAK_BF16_PER_S) for c in calls] for i in (0, 1)]
    bound_by = ["bytes" if sum(t for t, b in bs if b == "bytes") >= sum(t for t, _ in bs) / 2 else "operations"
                for bs in by]
    fwd_err, bwd_err = _fused_errs(worst_err)
    fwd = dict(max_abs_err=fwd_err, ms=step["fwd"], plain_ms=step["plain"],
               bound_ms=step["bound"], bound_by=bound_by[0], library_ms=step["library"])
    bwd = dict(max_abs_err=bwd_err, ms=step["bwd"], plain_ms=step["bwd_plain"], bound_ms=step["bwd_bound"],
               bound_by=bound_by[1], library_ms=step["bwd_library"])
    return fwd, bwd, step


def phase_train_amp(out_dir, weights):
    """det_train --amp TRAINER.AMP.FUSED_BN True on full-width YOLOX-S, 4
    steps of 8 images; the fused-kernel and matching counts are zeroed just
    before and read just after. Then kernels #3 and #4 are held to their
    plain versions on the first backward call of each distinct shape of the
    run (832x832 after the multiscale resize): its inputs and its cotangents
    as the step gave them. Returns the launches, the largest |kernel - plain|
    per output and the dumped weights."""
    from basedet_tpu_torch.layers.blocks import csp_fused
    from basedet_tpu_torch.layers.precision import compute_dtype
    from basedet_tpu_torch.models.det.yolox import YOLOX
    from basedet_tpu_torch.ops.fused_bn import fused_gemm_stats_backward_plain, fused_gemm_stats_plain
    from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats, fused_gemm_stats_backward
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching, dynamic_k_matching_plain
    from basedet_tpu_torch.tools import det_train

    ckpt = os.path.join(out_dir, "amp_ckpt")
    opts = [*_train_opts(out_dir, weights), "GLOBAL.CKPT_SAVE_DIR", ckpt, "TRAINER.AMP.FUSED_BN", "True"]
    kernels = (fused_gemm_stats, fused_gemm_stats_backward, dynamic_k_matching)
    plains = (fused_gemm_stats_plain, fused_gemm_stats_backward_plain, dynamic_k_matching_plain)
    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with recording(YOLOX, "get_losses", keep_losses) as losses, \
            recording(csp_fused, "fused_gemm_stats", lambda args, out: _fused_signature(args[0])[1]) as rows, \
            fused_backward_calls(first_per_shape=True) as backward:
        for fn in kernels:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", CONFIG, "--device", "cuda", "--amp", *opts])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [fn.launches for fn in kernels]
        plain_calls = [fn.calls for fn in plains]

    steps = trainer.state.step
    size = trainer.model.extra_meter["img_size"]
    check(steps == 4 and len(losses) == 4, f"det_train --amp took {steps} steps, not 4")
    check(launches == [36 * steps, 36 * steps, steps],
          f"fused forward, fused backward and matching kernels launched {launches} times in {steps} steps")
    check(plain_calls == [0, 0, 0], f"plain versions ran {plain_calls} times on the main path")
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    check(compute_dtype() is None, "the bf16 policy outlived the train step")
    check(all(p.dtype == torch.float32 for p in trainer.model.module.parameters()), "parameters left f32")
    check(size == 832 and rows[0] == 8 * (832 // 4) ** 2, f"the multiscale resize did not run ({size}, {rows[0]})")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"det_train --amp wrote no {name}")
    per_step = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items())
                         for step in losses)
    log(f"[amp-train] det_train --amp TRAINER.AMP.FUSED_BN True, YOLOX-S, 4 steps of 8 images 640x640 "
        f"resized to {size}x{size}, bf16 policy, in {seconds:.2f} s; launches: fused forward {launches[0]}, "
        f"fused backward {launches[1]} (36 per step, the first on {rows[0]} rows), matching {launches[2]}; "
        f"plain calls {plain_calls}; losses per step: {per_step}; checkpoints written")
    rows_832 = {8 * (size // stride) ** 2 for stride in (4, 8, 16, 32)}  # the CSP layers' strides
    check(len(backward) == launches[1] and {sig[1] for sig, _, _ in backward} == rows_832,
          f"the fused backward calls have shapes {[sig for sig, _, _ in backward]}")
    worst_err = check_fused_cases("amp-fused", [(f"det_train step 1 {_case_name(sig)}", terms, cts)
                                                for sig, terms, cts in backward if terms is not None])
    return launches, worst_err, os.path.join(ckpt, "dumped_model.pt")


def phase_amp_train_vs_cpu(weights):
    """One bf16 train step with the fused chain, same weights and batch of 2,
    on the CPU (plain versions), on the card (kernels, twice) and on the card
    with the plain versions in the kernels' place. The kernels are held to
    their plain versions on each of the card step's 36 calls, with its
    inputs and cotangents (FUSED_SUM_RTOL). Then foreground on each device's
    own assignment, and on the CPU's assignment the losses, gradients and BN
    running statistics of the card's step against its plain-version step and
    against the CPU's, within the AMP_* tolerances; an f32 step on the CPU
    measures how far bf16 itself turns the gradient. Returns the largest
    |kernel - plain| per output of the 36 calls."""
    from unittest import mock

    from basedet_tpu_torch.ops import fused_bn_kernel
    from basedet_tpu_torch.ops.fused_bn import fused_gemm_stats_backward_plain, fused_gemm_stats_plain, unflatten_terms

    grads = lambda args, out: [p.grad.detach().double().cpu().clone() for p in args[0]]
    plain = {"_launch_forward": lambda call: fused_gemm_stats_plain(unflatten_terms(call.spec, call.flat)),
             "_launch_backward": lambda terms, M, N, device, *cts: fused_gemm_stats_backward_plain(terms, *cts)}
    counters = (fused_bn_kernel.fused_gemm_stats, fused_bn_kernel.fused_gemm_stats_backward,
                fused_gemm_stats_plain, fused_gemm_stats_backward_plain)
    runs, assigned, calls = {}, None, None
    for run, device, amp in (("cpu", "cpu", "fused"), ("card", "cuda", "fused"), ("card plain", "cuda", "fused"),
                             ("card again", "cuda", "fused"), ("cpu f32", "cpu", None)):
        model, solver, state, step, batch, _ = _train_setup(weights, device, 2, amp=amp)
        t0 = time.perf_counter()
        shared = None if assigned is None else lambda args: tuple(t.to(args[0].device) for t in assigned)
        before = [getattr(c, "launches", getattr(c, "calls", 0)) for c in counters]
        with contextlib.ExitStack() as stack:
            own = stack.enter_context(recording(model, "assign", lambda args, out: out, shared))
            g = stack.enter_context(recording(solver, "clip_grads", grads))
            if run == "card":
                calls = stack.enter_context(fused_backward_calls(first_per_shape=False))
            if run == "card plain":
                for name, fn in plain.items():
                    stack.enter_context(mock.patch.object(fused_bn_kernel, name, fn))
            metrics = step(state, batch)
        seconds = time.perf_counter() - t0
        counts = [getattr(c, "launches", getattr(c, "calls", 0)) - b for c, b in zip(counters, before)]
        want = {"cpu": [0, 0, 36, 36], "card": [36, 36, 0, 0], "card plain": [0, 0, 36, 36],
                "card again": [36, 36, 0, 0], "cpu f32": [0] * 4}
        check(counts == want[run], f"the {run} step made {counts} fused kernel launches and plain calls")
        if assigned is None:
            assigned = tuple(t.detach().cpu() for t in own[0])
        stats = {k: v.double().cpu() for k, v in model.module.state_dict().items() if "running" in k}
        runs[run] = ({k: float(v) for k, v in metrics.items() if k != "lr"}, own[0][0].cpu(), g[0], stats, seconds)
    worst_err = check_fused_cases("amp-parity", [(f"card step call {i + 1} {_case_name(sig)}", terms, cts)
                                                 for i, (sig, terms, cts) in enumerate(calls)])

    norm = lambda g: math.sqrt(sum(float((t * t).sum()) for t in g))
    dist = lambda a, b: norm([x - y for x, y in zip(a, b)]) / norm(b)
    cos = lambda a, b: sum(float((x * y).sum()) for x, y in zip(a, b)) / (norm(a) * norm(b) or 1.0)
    loss_rel = lambda a, b: max(abs(a[k] - v) / abs(v) for k, v in b.items() if v != 0)
    stats_rel = lambda a, b: max(float(((a[k] - v).abs() / v.abs().clamp(min=1.0)).max()) for k, v in b.items())
    (cpu_losses, cpu_fg, cpu_g, cpu_stats, cpu_s), (gpu_losses, gpu_fg, gpu_g, gpu_stats, _), \
        (plain_losses, _, plain_g, plain_stats, _), (_, _, again_g, _, _), (f32_losses, _, f32_g, _, _) = \
        runs.values()
    agree = float((gpu_fg == cpu_fg).float().mean())
    bf16_cos = cos(cpu_g, f32_g)
    pairs = {"kernels vs plain versions on the card": (plain_losses, plain_g, plain_stats),
             "card vs CPU": (cpu_losses, cpu_g, cpu_stats)}
    seen = {name: dict(losses=loss_rel(gpu_losses, l), cos=cos(gpu_g, g), dist=dist(gpu_g, g),
                       norm=abs(norm(gpu_g) - norm(g)) / norm(g), stats=stats_rel(gpu_stats, st))
            for name, (l, g, st) in pairs.items()}
    log(f"[amp-parity] bf16 train step with the fused chain, batch 2 of 640x640, on the card with the kernels, on "
        f"the card with the plain versions in their place, and on the CPU (plain versions, {cpu_s:.1f} s): each "
        f"device's own assignment: foreground {int(gpu_fg.sum())} card / {int(cpu_fg.sum())} CPU anchors, agreement "
        f"{agree:.6f} of {gpu_fg.numel()} (min {AMP_FG_AGREE}); on the CPU's assignment: losses card "
        f"{', '.join(f'{k} {v:.6f}' for k, v in gpu_losses.items())} / card plain "
        f"{', '.join(f'{k} {v:.6f}' for k, v in plain_losses.items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in cpu_losses.items())}; gradient norm {norm(gpu_g):.6f} card / "
        f"{norm(plain_g):.6f} card plain / {norm(cpu_g):.6f} CPU / {norm(f32_g):.6f} CPU f32; the kernels' step run "
        f"twice: |g - g_again| / |g_again| {dist(gpu_g, again_g):.3e}; bf16 itself, the CPU's bf16 step against its "
        f"f32 step: losses {loss_rel(cpu_losses, f32_losses):.3e}, gradient cosine {bf16_cos:.4f}, |g_bf16 - g_f32| "
        f"/ |g_f32| {dist(cpu_g, f32_g):.3e}")
    for name, d in seen.items():
        log(f"[amp-parity] {name}: losses {d['losses']:.3e} (tol {AMP_LOSS_RTOL}), gradient cosine {d['cos']:.4f} "
            f"(min bf16's own {bf16_cos:.4f}), |g - g_other| / |g_other| {d['dist']:.3e}, gradient norm "
            f"{d['norm']:.3e}, BN running statistics {d['stats']:.3e} of max(|value|, 1) (tol {AMP_STATS_RTOL})")
    check(all(math.isfinite(v) for v in gpu_losses.values()), "non-finite bf16 losses on the card")
    check(agree >= AMP_FG_AGREE, f"only {agree:.6f} of the anchors agree on foreground under bf16")
    for name, d in seen.items():
        check(d["losses"] <= AMP_LOSS_RTOL, f"{name}: bf16 train losses differ by {d['losses']:.3e}")
        check(d["cos"] >= bf16_cos, f"{name}: the gradient turned further ({d['cos']:.4f}) than bf16's own "
                                    f"{bf16_cos:.4f}")
        check(d["stats"] <= AMP_STATS_RTOL, f"{name}: BN running statistics differ by {d['stats']:.3e}")
    return worst_err


def _timing_batch(bs, size=(640, 640)):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    h, w = size
    data = torch.rand(bs, h, w, 3, device="cuda", generator=gen) * 255
    info = torch.tensor([[h, w, h, w, 0]], dtype=torch.float32, device="cuda").repeat(bs, 1)
    return {"data": data, "im_info": info}


def phase_timing(model, card):
    from basedet_tpu_torch.ops.nms_kernel import nms_keep

    totals = {}
    for bs, reps in ((1, 30), (32, 8)):
        batch = _timing_batch(bs)
        info = batch["im_info"]
        total = cuda_ms(lambda: model.inference(batch), reps=reps, warmup=3)
        image = model.pre_process(batch)["image"]
        with torch.inference_mode():
            fwd = cuda_ms(lambda: model.module(image), reps=reps, warmup=2)
            head = model.module(image)
            post = cuda_ms(lambda: model.post_process(*head, info), reps=reps, warmup=2)
        with nms_counts() as seen:
            model.inference(batch)
        totals[bs] = total
        log(f"[timing] YOLOX-S f32 640x640 batch {bs}: {total:.3f} ms per batch "
            f"({1000 * bs / total:.1f} img/s; network {fwd:.3f} ms, decode+top-k+NMS {post:.3f} ms; "
            f"NMS kept per image {_kept_range(seen)}), input already on the card | {card}")
    check(nms_keep.launches > 0, "timing ran no NMS kernel")
    return totals


def phase_profile(card, out_dir, runs):
    """torch.profiler over a few calls of each run (name, label, fn, calls,
    unprofiled ms): device kernel time per call against the profiled wall
    time, and against the unprofiled time of the timing phases (the profiler
    slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    for name, label, fn, iters, unprofiled in runs:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1000 / iters
        averages = prof.key_averages()
        key = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
        kernels = sorted((e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -getattr(e, key))
        busy = sum(getattr(e, key) for e in kernels) / 1000 / iters
        check(busy > 0, "the profiler saw no device time")
        path = os.path.join(out_dir, f"profile_{name}.txt")
        with open(path, "w") as f:
            f.write(f"{label}, {iters} calls | {card}\n")
            f.write(averages.table(sort_by=key, row_limit=60, max_name_column_width=90))
        top = ", ".join(f"{e.key[:48]} {getattr(e, key) / 1000 / iters:.3f} ms" for e in kernels[:6])
        log(f"[profile] {label}: {sum(e.count for e in kernels) / iters:.0f} device kernels per "
            f"call, busy {busy:.3f} ms of {wall:.3f} ms profiled wall (idle share {1 - busy / wall:.3f}; "
            f"{1 - busy / unprofiled:.3f} against the unprofiled {unprofiled:.3f} ms) -> {path}")
        log(f"[profile]   largest: {top}")


def _proposal_rois(rng, B, R):
    """(B, R, 4) proposal-like boxes on the 800x1333 image: sqrt(area)
    log-uniform in 8-800 px, aspect 1/2-2, clipped to the image; a tenth are
    zero-area padding, as the RPN pads its empty slots."""
    h, w = FRCNN_IMAGE
    side = np.exp(rng.uniform(np.log(8), np.log(800), (B, R)))
    ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), (B, R)))
    bw, bh = side * np.sqrt(ar), side / np.sqrt(ar)
    cx, cy = rng.uniform(0, w, (B, R)), rng.uniform(0, h, (B, R))
    rois = np.stack([np.clip(cx - bw / 2, 0, w), np.clip(cy - bh / 2, 0, h),
                     np.clip(cx + bw / 2, 0, w), np.clip(cy + bh / 2, 0, h)], -1)
    rois[rng.uniform(size=(B, R)) < 0.1] = 0.0
    return rois.astype(np.float32)


def _edge_rois():
    """(1, R, 4): sqrt(area) exactly on the level boundaries 112, 224 and
    448 (and 56, 896, clipped), zero-area padding, boxes partly and wholly
    outside the image, sub-pixel boxes, boxes on the last row and column of
    every level (the padded input is 800x1344)."""
    H, W = 800, 1344
    rows = [[0, 0, 0, 0], [300, 200, 300, 200], [-40, -60, 100, 90], [1200, 700, 1500, 900],
            [-300, -300, -10, -20], [2000, 900, 2100, 1000], [10.2, 20.7, 10.6, 21.0],
            [3.0, 3.0, 3.25, 3.5], [W - 3, H - 2, W, H], [0, H - 1, W, H], [W - 1, 0, W, H],
            [0, 0, W, H], [W - 40, H - 40, W + 20, H + 20]]
    for side in (56, 112, 224, 448, 896):
        for x, y in ((0, 0), (17, 33), (W - side, H - side)):
            for r in (0.25, 1.0, 4.0):
                rows.append([x, y, x + side * r ** 0.5, y + side / r ** 0.5])
    return np.float32(rows)[None]


def _roi_feats(gen, B, C=ROI_C):
    return [torch.randn(B, C, h, w, device="cuda", generator=gen) for h, w in ROI_LEVELS]


def roi_align_touched(feats, rois, levels, output_size=(7, 7)):
    """The (level, b, y, x) feature rows that some RoI's taps read with a
    nonzero weight, counted from the plain version's per-axis weights: a RoI
    reads the product of the rows and the columns its samples touch."""
    from basedet_tpu_torch.ops.roi_align import _axis_weights

    ph, pw = output_size
    touched = 0
    for li, (f, stride) in enumerate(zip(feats, ROI_STRIDES)):
        H, W = f.shape[-2:]
        box = rois / stride - 0.5
        mask = (levels == li).float()
        py = _axis_weights(box[..., 1], (box[..., 3] - box[..., 1]) / ph, ph, 2, H, mask)
        px = _axis_weights(box[..., 0], (box[..., 2] - box[..., 0]) / pw, pw, 2, W, mask)
        rows, cols = (py != 0).any(-2).float(), (px != 0).any(-2).float()  # (B, R, H), (B, R, W)
        touched += int((torch.einsum("bry,brx->byx", rows, cols) > 0).sum())
    return touched


def roi_align_bound(feats, rois, levels):
    """RoIAlign's bound: the output written once, the rois and level ids
    read once, and the C channels of every feature row that some RoI's taps
    touch read once (``roi_align_touched``); 16 taps x (2 multiplies + 1
    add) + 4 sample weights per output element in f32."""
    B, R = levels.shape
    out_elems = B * R * 7 * 7 * ROI_C
    feat_bytes = roi_align_touched(feats, rois, levels) * ROI_C * 4
    t = bound(out_elems * 4 + feat_bytes + B * R * 20, out_elems * (16 * 3 + 4 * 4))
    return (*t, feat_bytes)


def _check_roi_align(name, feats, rois):
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    levels = roi_level_assignment(rois, 2, 5)
    got = multilevel_roi_align(feats, rois, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    want = multilevel_roi_align_plain(feats, rois, levels, ROI_STRIDES)
    err = float((got - want).abs().max())
    tol = 1e-5 * max(1.0, max(float(f.abs().max()) for f in feats))
    per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    log(f"[roi] {name:16s} B={rois.shape[0]} R={rois.shape[1]} C={feats[0].shape[1]}, RoIs per level "
        f"P2-P5 {per_level}: max |kernel - plain| {err:.3e} (tol {tol:.3e})")
    check(err <= tol, f"RoIAlign kernel differs from its plain version by {err} on case {name!r}")
    return err


def phase_roi_align(card):
    rng, gen = np.random.RandomState(SEED), torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for B in (1, 2):
        feats = _roi_feats(gen, B)
        rois = torch.from_numpy(_proposal_rois(rng, B, ROI_R)).cuda()
        worst = max(worst, _check_roi_align("slice", feats, rois))
    worst = max(worst, _check_roi_align("edges", _roi_feats(gen, 1), torch.from_numpy(_edge_rois()).cuda()))
    big = [f * 1000.0 for f in _roi_feats(gen, 1)]  # the tolerance scales with max |F|
    worst = max(worst, _check_roi_align("edges |F|~4e3", big, torch.from_numpy(_edge_rois()).cuda()))
    for C in (100, 6):  # channels off the kernel's slab, and not a multiple of 4
        worst = max(worst, _check_roi_align(f"edges C={C}", _roi_feats(gen, 1, C), torch.from_numpy(_edge_rois()).cuda()))
    feats = [f.contiguous(memory_format=torch.channels_last) for f in _roi_feats(gen, 1)]
    worst = max(worst, _check_roi_align("channels-last F", feats, torch.from_numpy(_proposal_rois(rng, 1, 300)).cuda()))

    t = roi_align_timing(rng, gen, card)
    check(t["other_ops"] == 0, f"the RoIAlign wrapper ran device work besides its kernel: {t['names']}")
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None)


def roi_align_timing(rng, gen, card):
    """The RoIAlign wrapper at Faster R-CNN's eval shape (B = 1, R = 1000,
    C = 256, P2-P5 of 800x1344) on proposal-like RoIs: events time of the
    call, the device time of its kernel and of anything else it runs
    (profiler), the plain version and the bound."""
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    feats = _roi_feats(gen, 1)
    rois = torch.from_numpy(_proposal_rois(rng, 1, ROI_R)).cuda()
    levels = roi_level_assignment(rois, 2, 5)
    call = lambda: multilevel_roi_align(feats, rois, levels, ROI_STRIDES)
    ms = cuda_ms(call, reps=50, warmup=5)
    device, ops, names = device_kernels(call, 10)
    kernel = sum(v for n, v in names.items() if "roi_align" in n)
    other = {n: v for n, v in names.items() if "roi_align" not in n}
    plain_ms = cuda_ms(lambda: multilevel_roi_align_plain(feats, rois, levels, ROI_STRIDES), reps=3, warmup=1)
    bound_ms, bound_by, feat_bytes = roi_align_bound(feats, rois, levels)
    log(f"[roi] B=1 R={ROI_R} C={ROI_C} levels {ROI_LEVELS}: wrapper {ms:.4f} ms per call; device time "
        f"(profiler) {device:.4f} ms in {ops:.0f} operations: the RoIAlign kernel {kernel:.4f} ms, anything else "
        f"{sum(other.values()):.4f} ms {sorted(other)}; plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {feat_bytes / 1e6:.1f} MB of the {sum(f.numel() * 4 for f in feats) / 1e6:.1f} MB of "
        f"P2-P5 touched) | {card}")
    return dict(ms=ms, device_ms=device, kernel_ms=kernel, other_ms=sum(other.values()),
                other_ops=len(other), names=sorted(names), plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def roi_align_bwd_bound(grad, sizes):
    """The RoIAlign backward's bound: g, the rois and the level ids read
    once, every level's dF written once; per element of g, 4 samples' weights
    (4 multiplies) and 16 taps x (1 multiply + 1 add) in f32."""
    B, R = grad.shape[:2]
    d_bytes = sum(B * h * w * grad.shape[-1] * 4 for h, w in sizes)
    t = bound(grad.numel() * 4 + d_bytes + B * R * 20, grad.numel() * (16 * 2 + 4))
    return (*t, d_bytes)


def _check_roi_align_bwd(name, grad, rois):
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_backward_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align_backward

    levels = roi_level_assignment(rois, 2, 5)
    got = multilevel_roi_align_backward(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    torch.cuda.synchronize()
    want = multilevel_roi_align_backward_plain(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    again = multilevel_roi_align_backward(grad, rois, levels, ROI_STRIDES, ROI_LEVELS)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rerun = max(float((g - a).abs().max()) for g, a in zip(got, again))
    biggest = max(float(w.abs().max()) for w in want)
    tol = ROI_BWD_RTOL * max(1.0, biggest)
    per_level = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    log(f"[roi-bwd] {name:16s} B={rois.shape[0]} R={rois.shape[1]} C={grad.shape[-1]}, RoIs per level "
        f"P2-P5 {per_level}: max |kernel - plain| {err:.3e} (tol {tol:.3e}, max |dF| {biggest:.3e}); "
        f"two runs of the kernel differ by {rerun:.3e} (the atomics' order)")
    check(all(g.shape == w.shape for g, w in zip(got, want)), "RoIAlign backward: wrong dF shapes")
    check(err <= tol, f"RoIAlign backward kernel differs from its plain version by {err} on case {name!r}")
    return err


def phase_roi_align_bwd(card):
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_backward_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align_backward

    rng, gen = np.random.RandomState(SEED + 2), torch.Generator(device="cuda").manual_seed(SEED + 2)
    B, R = FRCNN_TRAIN_B, FRCNN_TRAIN_R

    def grad_like(rois):
        return torch.randn(*rois.shape[:2], 7, 7, ROI_C, device="cuda", generator=gen)

    spread_rois = torch.from_numpy(_proposal_rois(rng, B, R)).cuda()
    same_rois = torch.from_numpy(np.broadcast_to(np.float32([301.3, 211.7, 642.9, 505.1]), (B, R, 4)).copy()).cuda()
    edge_rois = torch.from_numpy(_edge_rois()).cuda()
    worst = 0.0
    for name, rois in (("proposal-like", spread_rois), ("edges", edge_rois), ("identical RoIs", same_rois)):
        worst = max(worst, _check_roi_align_bwd(name, grad_like(rois), rois))
    worst = max(worst, _check_roi_align_bwd("edges |g|~1e3", grad_like(edge_rois) * 1000.0, edge_rois))

    times = {}
    for name, rois in (("proposal-like", spread_rois), ("identical RoIs", same_rois)):
        grad, levels = grad_like(rois), roi_level_assignment(rois, 2, 5)
        ms = cuda_ms(lambda: multilevel_roi_align_backward(grad, rois, levels, ROI_STRIDES, ROI_LEVELS),
                     reps=30, warmup=5)
        plain_ms = cuda_ms(lambda: multilevel_roi_align_backward_plain(grad, rois, levels, ROI_STRIDES, ROI_LEVELS),
                           reps=3, warmup=1)
        times[name] = (ms, plain_ms)
    zero_ms = cuda_ms(lambda: torch.zeros(sum(B * h * w * ROI_C for h, w in ROI_LEVELS), device="cuda"),
                      reps=30, warmup=5)
    grad = grad_like(spread_rois)
    bound_ms, bound_by, d_bytes = roi_align_bwd_bound(grad, ROI_LEVELS)
    ms, plain_ms = times["proposal-like"]
    log(f"[roi-bwd] B={B} R={R} C={ROI_C} levels {ROI_LEVELS}: wrapper {ms:.4f} ms per call on "
        f"proposal-like RoIs (of which the zero-fill of dF alone {zero_ms:.4f} ms), plain {plain_ms:.3f} ms; "
        f"on {R} identical RoIs {times['identical RoIs'][0]:.4f} ms, plain {times['identical RoIs'][1]:.3f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}: {grad.numel() * 4 / 1e6:.1f} MB of g read, "
        f"{d_bytes / 1e6:.1f} MB of dF written) | {card}")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


@torch.no_grad()
def randomise_frcnn(module, generator):
    """Draw the frozen BN statistics and affine and every conv and fc bias
    from generator, as ``randomise`` does for YOLOX-S; raise the RPN's
    box-size biases by log 3, so that a proposal spans about three times its
    anchor's side and the proposals reach every pooling level P2-P5 (with
    the plain init all 1000 land on P2, the top-scoring anchors being the
    small ones); and spread the class logits' biases by 2, so that some
    classes clear the 0.05 score threshold of an untrained head (whose
    softmax over 81 classes gives ~0.012)."""
    from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm

    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    module.rpn.rpn_bbox_offsets.bias.view(-1, 4)[:, 2:].add_(math.log(3.0))  # (dx, dy, dw, dh) per anchor
    bias = module.rcnn.pred_cls.bias
    bias.add_(torch.empty_like(bias).normal_(0.0, 2.0, generator=generator))


def make_frcnn_weights(out_dir):
    """Full-width Faster R-CNN R50-FPN on the card with random weights from
    SEED, spread by ``randomise_frcnn``, saved as a state_dict."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(FRCNN_CONFIG)
    cfg.merge(_frcnn_opts(out_dir))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise_frcnn(model.module, generator)
    weights = os.path.join(out_dir, "faster_rcnn_r50_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    n_params = sum(p.numel() for p in model.module.parameters())
    log(f"[frcnn] {FRCNN_CONFIG}: {cfg.MODEL.BACKBONE.NAME} (FrozenBN, freeze_at "
        f"{cfg.MODEL.BACKBONE.FREEZE_AT}), FPN {cfg.MODEL.FPN.OUT_CHANNELS}, RPN top "
        f"{cfg.MODEL.RPN.TEST_PREV_NMS_TOPK}/{cfg.MODEL.RPN.TEST_POST_NMS_TOPK}, "
        f"{cfg.DATA.NUM_CLASSES} classes, {n_params} parameters, random from seed {SEED}")
    return cfg, model, weights


def _frcnn_opts(out_dir):
    return ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "GLOBAL.OUTPUT_DIR", out_dir]


def _frcnn_train_opts(out_dir, weights):
    return ["DATA.TRAIN.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "MODEL.BATCHSIZE", str(FRCNN_TRAIN_B), "SOLVER.MAX_EPOCH", "1",
            "SOLVER.NUM_IMAGE_PER_EPOCH", str(4 * FRCNN_TRAIN_B), "GLOBAL.LOG_INTERVAL", "1",
            "MODEL.WEIGHTS", weights, "GLOBAL.OUTPUT_DIR", out_dir,
            "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "frcnn_ckpt")]


def phase_frcnn_train(out_dir, weights):
    """det_train on full-width Faster R-CNN, 4 steps of 2 images of 800x1333;
    the RoIAlign (forward and backward) and NMS counts are zeroed just before
    and read just after."""
    from basedet_tpu_torch.models.det.faster_rcnn import FasterRCNN, FasterRCNNModule
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.ops.roi_align import (multilevel_roi_align_backward_plain,
                                                 multilevel_roi_align_plain, roi_level_assignment)
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align, multilevel_roi_align_backward
    from basedet_tpu_torch.tools import det_train

    def sampled(args, out):  # per step: foreground, background, sampled RoIs per level P2-P5
        rois, labels, _, weights = out
        levels = roi_level_assignment(rois, 2, 5)
        return (int((labels > 0).sum()), int((labels == 0).sum()),
                torch.bincount(levels[weights > 0].long(), minlength=4).tolist())

    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    kernels = (multilevel_roi_align, multilevel_roi_align_backward, nms_keep)
    plains = (multilevel_roi_align_plain, multilevel_roi_align_backward_plain, nms_keep_plain)
    with recording(FasterRCNNModule, "sample", sampled) as samples, \
            recording(FasterRCNN, "get_losses", keep_losses) as losses, nms_counts() as seen:
        for fn in kernels:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", FRCNN_CONFIG, "--device", "cuda", *_frcnn_train_opts(out_dir, weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = [fn.launches for fn in kernels]
        plain_calls = [fn.calls for fn in plains]

    steps = trainer.state.step
    ckpt = os.path.join(out_dir, "frcnn_ckpt")
    per_level = np.sum([s[2] for s in samples], axis=0).tolist()
    check(steps == 4 and len(losses) == 4, f"Faster R-CNN det_train took {steps} steps, not 4")
    check(launches == [steps] * 3, f"RoIAlign forward, backward and NMS kernels launched {launches} "
                                   f"times in {steps} steps")
    check(plain_calls == [0, 0, 0], f"plain versions ran {plain_calls} times on the main path")
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    check(all(len(step) == 5 and step["total_loss"] > 0 for step in losses), f"losses {losses}")
    # the synthetic gt boxes reach P3 and P4 (sqrt(area) up to ~410 px) and an untrained RPN's best
    # 1000 of 8819 candidates are mostly P2's: mixed levels in each launch, not every level
    check(sum(n > 0 for n in per_level) >= 3, f"sampled RoIs per level P2-P5 {per_level}: fewer than 3 levels")
    check(all(fg > 0 and bg > 0 for fg, bg, _ in samples), f"a step sampled no foreground or background: {samples}")
    check(len(seen) == steps and all(len(call) == FRCNN_TRAIN_B for call in seen),
          f"NMS saw {[len(call) for call in seen]} images per call, not {FRCNN_TRAIN_B} in each of {steps}")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"Faster R-CNN det_train wrote no {name}")
    per_step = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items())
                         for step in losses)
    log(f"[frcnn-train] det_train Faster R-CNN R50-FPN, 4 steps of {FRCNN_TRAIN_B} images "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} (padded 800x1344), f32, in {seconds:.2f} s; kernel launches: "
        f"RoIAlign forward {launches[0]}, RoIAlign backward {launches[1]}, NMS {launches[2]}; plain calls "
        f"{plain_calls}; lr {trainer.meters['lr'].latest:.4g} (step 3 of the 500-step warm-up); losses per "
        f"step: {per_step}; sampled per step (foreground, background of {FRCNN_TRAIN_B * FRCNN_TRAIN_R} "
        f"rows): {[s[:2] for s in samples]}; sampled RoIs per level P2-P5 over the 4 steps {per_level}; "
        f"RPN NMS kept per image {_kept_range(seen)}; checkpoints latest.pt, epoch_1.pt, dumped_model.pt written")
    return launches, os.path.join(ckpt, "dumped_model.pt")


def phase_frcnn_slice(out_dir, weights):
    """det_test on full-width Faster R-CNN over 8 requests; the RoIAlign and
    NMS counts are zeroed just before and read just after."""
    from basedet_tpu_torch.models.det import faster_rcnn
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align
    from basedet_tpu_torch.tools import det_test

    def level_counts(args, out):  # RoIs with positive area (proposals, not padding) per level
        rois = args[1]
        area = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
        levels = roi_level_assignment(rois, 2, 5)
        return torch.bincount(levels[area > 0].long(), minlength=4).tolist()

    multilevel_roi_align.launches, multilevel_roi_align_plain.calls = 0, 0
    nms_keep.launches, nms_keep_plain.calls = 0, 0
    t0 = time.perf_counter()
    with recording(faster_rcnn, "pool_rois_multilevel", level_counts) as levels, \
            nms_counts() as seen:
        results = det_test.main(["-f", FRCNN_CONFIG, "-w", weights, "--device", "cuda",
                                 *_frcnn_opts(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    roi_launches, roi_plain = multilevel_roi_align.launches, multilevel_roi_align_plain.calls
    nms_launches, nms_plain = nms_keep.launches, nms_keep_plain.calls

    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    per_level = np.sum(levels, axis=0).tolist()
    check(len(records) >= 1, "Faster R-CNN det_test gave no detections")
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    check({r["image_id"] for r in records} == set(range(8)), "not every request was answered")
    check(roi_launches == 8, f"the RoIAlign kernel launched {roi_launches} times for 8 requests")
    check(roi_plain == 0, f"the plain RoIAlign ran {roi_plain} times on the main path")
    check(nms_launches == 16, f"the NMS kernel launched {nms_launches} times for 8 requests")
    check(nms_plain == 0, f"the plain NMS ran {nms_plain} times on the main path")
    check(all(n > 0 for n in per_level), f"RoIs per level P2-P5 {per_level}: a level got none")
    rpn, final = seen[0::2], seen[1::2]
    log(f"[frcnn] det_test Faster R-CNN R50-FPN with {os.path.basename(weights)} on 8 requests of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} "
        f"(padded 800x1344): {results}, {len(records)} finite detections in {seconds:.2f} s; "
        f"RoIAlign kernel launches {roi_launches}, plain calls {roi_plain}; NMS kernel launches "
        f"{nms_launches}, plain calls {nms_plain}; RPN NMS kept per image {_kept_range(rpn)}, final "
        f"NMS kept {_kept_range(final)}; proposals per level P2-P5 over the 8 requests {per_level}")
    return roi_launches, nms_launches


def _frcnn_stages(model, batch):
    """The RPN's proposals and valid flags and the detections of one batch,
    on the CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    with torch.inference_mode(), full_f32():
        x = model.pre_process(batch)
        feats = model.module.features(x["image"])
        proposals, valid = model.module.proposals(feats, x["img_info"])
    dets = {k: v.cpu() for k, v in model.inference(batch).items()}
    return proposals.cpu(), valid.cpu(), dets


def _slot_agreement(cpu_boxes, cpu_valid, gpu_boxes, gpu_valid, extra=None):
    """Fraction of the CPU's valid slots whose card slot is valid with every
    coordinate within FRCNN_ATOL (and ``extra`` true), and the largest
    coordinate difference over those matched slots."""
    close = (gpu_boxes - cpu_boxes).abs().amax(-1)
    ok = cpu_valid & gpu_valid & (close <= FRCNN_ATOL)
    if extra is not None:
        ok &= extra
    frac = float(ok.sum()) / max(int(cpu_valid.sum()), 1)
    return frac, float(close[ok].max()) if ok.any() else 0.0


def phase_frcnn_card_vs_cpu(cfg, model, weights):
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_test_dataloader

    cpu = build_model(cfg, "cpu")
    cpu.load_weights(weights)
    batch = next(iter(build_test_dataloader(cfg)))  # det_test's first request
    batch = {k: batch[k] for k in ("data", "im_info")}
    t0 = time.perf_counter()
    c_prop, c_valid, c_dets = _frcnn_stages(cpu, batch)
    cpu_s = time.perf_counter() - t0
    g_prop, g_valid, g_dets = _frcnn_stages(model, batch)
    prop_frac, prop_err = _slot_agreement(c_prop, c_valid, g_prop, g_valid)
    same = ((g_dets["box_labels"] == c_dets["box_labels"])
            & ((g_dets["box_scores"] - c_dets["box_scores"]).abs() <= FRCNN_ATOL))
    det_frac, det_err = _slot_agreement(c_dets["boxes"], c_dets["valid"], g_dets["boxes"],
                                        g_dets["valid"], same)
    score_err = float((g_dets["box_scores"] - c_dets["box_scores"])[same & c_dets["valid"]].abs().max())
    log(f"[parity] Faster R-CNN card vs CPU, f32, one {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} image (CPU "
        f"run {cpu_s:.1f} s, plain RoIAlign): proposals {int(c_valid.sum())} CPU / {int(g_valid.sum())} "
        f"card valid, {prop_frac:.4f} of slots matched, max |dbox| {prop_err:.3e} on them; detections "
        f"{int(c_dets['valid'].sum())} CPU / {int(g_dets['valid'].sum())} card, {det_frac:.4f} of "
        f"slots matched (label, |dbox|, |dscore| <= {FRCNN_ATOL}), max |dbox| {det_err:.3e}, max "
        f"|dscore| {score_err:.3e} on them")
    check(bool(g_dets["valid"].any()) and torch.isfinite(g_dets["boxes"]).all(),
          "card detections empty or non-finite")
    check(prop_frac >= FRCNN_AGREE, f"only {prop_frac:.3f} of the CPU's proposals matched on the card")
    check(det_frac >= FRCNN_AGREE, f"only {det_frac:.3f} of the CPU's detections matched on the card")


def _frcnn_train_setup(weights, device):
    """Full-width Faster R-CNN in train mode with ``weights``, its train
    state and step, and the first synthetic batch of 2 images of 800x1333."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import DetSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(FRCNN_CONFIG)
    cfg.merge(_frcnn_train_opts(".", weights))
    model = build_model(cfg, device)
    model.load_weights(weights)
    model.train()
    solver = DetSolver.build(cfg)
    state = TrainState(model, solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def _frcnn_train_stages(model, batch, noise, proposals=None):
    """One train forward and backward through the module's stage methods,
    with ``proposals`` (boxes, valid) from another run in place of its own
    when given. Returns the RPN labels, its own proposals, the sampled
    labels, the four losses and the total's gradient norm, on the CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    m = model.module
    noise = {k: v.to(model.device) for k, v in noise.items()}
    with full_f32():
        x = model.pre_process(batch, train=True)
        num_gt = x["img_info"][:, 4].long()
        feats = m.features(x["image"])
        rpn_out = m.rpn_head(feats)
        labels, offsets = m.rpn_targets(feats, x["gt_boxes"], num_gt, noise["rpn_pos"], noise["rpn_neg"])
        rpn_cls, rpn_reg = m.rpn_loss(rpn_out, labels, offsets)
        own = m.proposals(feats, x["img_info"], train=True, rpn_out=rpn_out)
        boxes, valid = own if proposals is None else (t.to(model.device) for t in proposals)
        rois, roi_labels, targets, weights = m.sample(
            boxes, valid, x["gt_boxes"], num_gt, noise["rcnn_fg"], noise["rcnn_bg"], noise["rcnn_tie"])
        rcnn_cls, rcnn_reg = m.head_losses(m.pool(feats, rois), roi_labels, targets, weights)
        m.zero_grad(set_to_none=True)
        (rpn_cls + rpn_reg + rcnn_cls + rcnn_reg).backward()
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in m.parameters() if p.grad is not None)))
    losses = {k: float(v.detach()) for k, v in
              dict(rpn_cls=rpn_cls, rpn_reg=rpn_reg, rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg).items()}
    return dict(rpn_labels=labels.cpu(), proposals=tuple(t.cpu() for t in own), roi_labels=roi_labels.cpu(),
                losses=losses, grad_norm=norm)


def phase_frcnn_train_vs_cpu(weights):
    """One Faster R-CNN train step on the CPU and on the card: same weights,
    batch and noise (a CPU and a CUDA generator give different streams, so it
    is drawn once on the CPU and copied). The card's R-CNN stages run on the
    CPU run's proposals."""
    from basedet_tpu_torch.layers.common.sampling import draw_sampling_noise

    noise = draw_sampling_noise(42, 0, FRCNN_TRAIN_B, FRCNN_ANCHORS, FRCNN_CANDIDATES, "cpu")
    model, _, _, batch = _frcnn_train_setup(weights, "cpu")
    t0 = time.perf_counter()
    cpu = _frcnn_train_stages(model, batch, noise)
    cpu_s = time.perf_counter() - t0
    model = _frcnn_train_setup(weights, "cuda")[0]
    gpu = _frcnn_train_stages(model, batch, noise, proposals=cpu["proposals"])

    agree = float((gpu["rpn_labels"] == cpu["rpn_labels"]).float().mean())
    prop_frac, prop_err = _slot_agreement(*cpu["proposals"], *gpu["proposals"])
    same_rois = bool((gpu["roi_labels"] == cpu["roi_labels"]).all())
    rel = {k: abs(gpu["losses"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["losses"].items()}
    norm_rel = abs(gpu["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    labels = cpu["rpn_labels"]
    log(f"[parity] Faster R-CNN train step card vs CPU, f32, batch {FRCNN_TRAIN_B} of "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} (CPU run {cpu_s:.1f} s, plain RoIAlign forward and backward), "
        f"same noise: RPN labels agree on {agree:.6f} of {labels.numel()} anchors (min {RPN_LABEL_AGREE}; CPU "
        f"{int((labels == 1).sum())} positives, {int((labels == 0).sum())} negatives sampled); the card's own "
        f"train proposals match {prop_frac:.4f} of the CPU's slots (max |dbox| {prop_err:.3e}); on the CPU's "
        f"proposals: sampled labels equal {same_rois} ({int((cpu['roi_labels'] > 0).sum())} foreground, "
        f"{int((cpu['roi_labels'] == 0).sum())} background); losses card "
        f"{', '.join(f'{k} {v:.6f}' for k, v in gpu['losses'].items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in cpu['losses'].items())}, worst rel diff "
        f"{max(rel.values()):.3e} (tol {LOSS_RTOL}); gradient norm {gpu['grad_norm']:.6f} card / "
        f"{cpu['grad_norm']:.6f} CPU, rel diff {norm_rel:.3e} (tol {GRAD_NORM_RTOL})")
    check(all(math.isfinite(v) for v in gpu["losses"].values()), "non-finite Faster R-CNN losses on the card")
    check(agree >= RPN_LABEL_AGREE, f"only {agree:.6f} of the RPN labels agree between card and CPU")
    check(same_rois, "the sampled RoI labels differ between card and CPU on the same proposals and noise")
    check(max(rel.values()) <= LOSS_RTOL, f"Faster R-CNN train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"Faster R-CNN gradient norms differ by {norm_rel:.3e}")


def phase_frcnn_train_timing(weights, card):
    """One f32 Faster R-CNN train step at batch 2 of 800x1333 (input already
    on the card): the stage methods each timed alone on the previous stage's
    outputs, gradients enabled; get_losses, get_losses with backward and the
    whole step as nested prefixes; and the RoIAlign backward alone on the
    arguments a real backward gave it."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.common.sampling import draw_sampling_noise
    from basedet_tpu_torch.models.det.faster_rcnn import FasterRCNNModule
    from basedet_tpu_torch.ops.roi_align import roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align_backward

    model, state, step, batch = _frcnn_train_setup(weights, "cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    noise = draw_sampling_noise(42, 0, FRCNN_TRAIN_B, FRCNN_ANCHORS, FRCNN_CANDIDATES, "cuda")
    m, reps = model.module, 10

    def timed(fn):
        def run():
            with full_f32():
                return fn()
        return cuda_ms(run, reps=reps, warmup=2), run()

    x = model.pre_process(batch, train=True)
    image, info, gt = x["image"], x["img_info"], x["gt_boxes"]
    num_gt = info[:, 4].long()
    t_feat, feats = timed(lambda: m.features(image))
    t_rpn, rpn_out = timed(lambda: m.rpn_head(feats))
    t_targets, _ = timed(lambda: m.rpn_loss(rpn_out, *m.rpn_targets(feats, gt, num_gt, noise["rpn_pos"],
                                                                       noise["rpn_neg"])))
    t_prop, (proposals, valid) = timed(lambda: m.proposals(feats, info, train=True, rpn_out=rpn_out))
    t_sample, (rois, roi_labels, targets, weights) = timed(lambda: m.sample(
        proposals, valid, gt, num_gt, noise["rcnn_fg"], noise["rcnn_bg"], noise["rcnn_tie"]))
    t_pool, pooled = timed(lambda: m.pool(feats, rois))
    t_head, _ = timed(lambda: m.head_losses(pooled, roi_labels, targets, weights))
    del feats, rpn_out, pooled

    def losses_backward():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch, noise=noise)[0].backward()

    t_loss, _ = timed(lambda: model.get_losses(batch, noise=noise)[0])
    t_fb, _ = timed(losses_backward)
    # the gradient that reaches the pooled features in a real backward, and its RoIs
    grads = []
    with recording(FasterRCNNModule, "pool", lambda args, out: (out.register_hook(grads.append), args[2])[1]) as pooled_rois, \
            full_f32():
        losses_backward()
    g, rois = grads[-1].contiguous(), pooled_rois[-1]
    levels = roi_level_assignment(rois, 2, 5)
    t_roi_bwd = cuda_ms(lambda: multilevel_roi_align_backward(g, rois, levels, ROI_STRIDES, ROI_LEVELS),
                        reps=30, warmup=3)
    launches = multilevel_roi_align_backward.launches
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=reps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    check(multilevel_roi_align_backward.launches > launches,
          "Faster R-CNN train timing ran no RoIAlign backward kernel")
    nonzero = float((g != 0).float().mean())
    log(f"[timing] Faster R-CNN R50-FPN f32 train step, batch {FRCNN_TRAIN_B} of "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: {t_step:.3f} ms per step ({1000 * FRCNN_TRAIN_B / t_step:.2f} "
        f"img/s); stages each alone, gradients enabled: backbone+FPN {t_feat:.3f}, RPN head {t_rpn:.3f}, "
        f"RPN targets+losses {t_targets:.3f}, proposals {t_prop:.3f}, sampling {t_sample:.3f}, RoIAlign "
        f"{t_pool:.3f}, box head+losses {t_head:.3f} ms; get_losses {t_loss:.3f} ms, backward "
        f"{t_fb - t_loss:.3f} ms (of which the RoIAlign backward {t_roi_bwd:.3f} ms, timed alone on the "
        f"step's own g, {nonzero:.3f} of it nonzero), SGD {t_step - t_fb:.3f} ms (differences of means "
        f"of {reps} runs of nested prefixes); peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated), input already on the card | {card}")


def phase_frcnn_timing(model, card):
    """Faster R-CNN f32 inference at batch 1 and 8 of 800x1333, input on the
    card: the whole request and its stages, each timed alone on the previous
    stage's outputs."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    m = model.module
    launches = multilevel_roi_align.launches
    for bs, reps in ((1, 20), (8, 5)):
        batch = _timing_batch(bs, FRCNN_IMAGE)
        total = cuda_ms(lambda: model.inference(batch), reps=reps, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        model.inference(batch)
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode(), full_f32():
            x = model.pre_process(batch)
            image, info = x["image"], x["img_info"]
            t_feat = cuda_ms(lambda: m.features(image), reps=reps, warmup=2)
            feats = m.features(image)
            t_prop = cuda_ms(lambda: m.proposals(feats, info), reps=reps, warmup=2)
            proposals, valid = m.proposals(feats, info)
            t_pool = cuda_ms(lambda: m.pool(feats, proposals), reps=reps, warmup=2)
            pooled = m.pool(feats, proposals)
            t_head = cuda_ms(lambda: m.box_head(pooled, proposals), reps=reps, warmup=2)
            boxes, scores = m.box_head(pooled, proposals)
            t_post = cuda_ms(lambda: model.post_process(boxes, scores, valid, info), reps=reps, warmup=2)
        log(f"[timing] Faster R-CNN R50-FPN f32 {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} batch {bs}: "
            f"{total:.3f} ms per batch ({1000 * bs / total:.2f} img/s); backbone+FPN {t_feat:.3f}, "
            f"RPN+proposals {t_prop:.3f}, RoIAlign {t_pool:.3f}, box head {t_head:.3f}, post-process "
            f"{t_post:.3f} ms (each alone, means of {reps}); peak memory {peak / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated), input already on the card | {card}")
    check(multilevel_roi_align.launches > launches, "Faster R-CNN timing ran no RoIAlign kernel")


# -- CenterNet R50-DCNv2 and the row scatter (kernel #9) ----------------------------------------

def scatter_edges(rng):
    """Edge cases of kernel #9, on the CPU: name -> (idx (B, N) int32, values (B, N, D), R)."""
    def case(B, N, R, D, lo=0, hi=None, dtype=torch.float32):
        idx = torch.from_numpy(rng.randint(lo, R if hi is None else hi, (B, N)).astype(np.int32))
        return idx, torch.from_numpy(rng.randn(B, N, D).astype(np.float32)).to(dtype), R

    cases = {
        "all entries on one row": case(2, 2304, 289, 256),
        "rows that receive nothing (10 of 1089 used)": case(2, 9216, 1089, 128, 0, 10),
        "indices out of range, negative and >= R": case(2, 5000, 500, 128, -600, 1100),
        "N and D off the tile (N 1001, D 1030)": case(2, 1001, 77, 1030),
        "D = 12": case(2, 2304, 289, 12),
        "B = 1, stage 3's shape": case(1, 36864, 4225, 512),
        "bf16, D = 13": case(2, 3000, 300, 13, dtype=torch.bfloat16),
    }
    cases["all entries on one row"][0].fill_(7)
    return cases


def check_scatter_case(idx, values, n_rows):
    """Kernel #9 run twice and its plain version on one case on the card: the two kernel runs
    give the same bits, and each output element lies within SCATTER_RTOL of the sum of the
    |values| that land on it. Returns (worst share of that tolerance, max |kernel - plain|)."""
    from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows

    out = scatter_rows(idx, values, n_rows)
    again = scatter_rows(idx, values, n_rows)
    torch.cuda.synchronize()
    check(torch.equal(out.view(torch.int32), again.view(torch.int32)),
          f"two runs of the scatter kernel differ on {tuple(values.shape)}")
    plain = scatter_rows_plain(idx, values, n_rows)
    mag = scatter_rows_plain(idx, values.float().abs(), n_rows)
    err = (out - plain).abs()
    ratio = torch.where(err > 0, err / (SCATTER_RTOL * mag), torch.zeros_like(err))
    return float(ratio.max()) if ratio.numel() else 0.0, float(err.max()) if err.numel() else 0.0


def scatter_bound(idx, values, n_rows):
    """(ms, "bytes" or "operations"): idx and values read once, the (B, R, D) f32 output written
    once; one add per value whose index lands in [0, R)."""
    B, N, D = values.shape
    landing = int(((idx >= 0) & (idx < n_rows)).sum())
    return bound(idx.numel() * 4 + values.numel() * values.element_size() + B * n_rows * D * 4,
                 landing * D)


@torch.no_grad()
def randomise_cnet(module, generator):
    """Draw BN statistics and affine and every bias from generator, as ``randomise`` does for
    YOLOX-S, and give each DCN's offset branch random weights (zero at init, where every tap sits
    on the grid and each row of the block table receives about nine entries): then the offsets
    are fractional, some taps fall off the map and the rows receive uneven counts."""
    from basedet_tpu_torch.layers.blocks.deformable import ModulatedDeformConv

    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if isinstance(getattr(m, "bias", None), torch.Tensor):
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
        if isinstance(m, ModulatedDeformConv):
            w = m.conv_offset.weight
            w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=generator)
            m.conv_offset.bias.normal_(0.0, 0.5, generator=generator)


def _cnet_opts(out_dir):
    return ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(CNET_IMAGE).replace(" ", ""),
            "GLOBAL.OUTPUT_DIR", out_dir]


def _cnet_train_opts(out_dir, weights, batch=CNET_B):
    return ["DATA.TRAIN.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(CNET_IMAGE).replace(" ", ""),
            "MODEL.BATCHSIZE", str(batch), "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH",
            str(4 * batch), "GLOBAL.LOG_INTERVAL", "1", "MODEL.WEIGHTS", weights,
            "GLOBAL.OUTPUT_DIR", out_dir, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "cnet_ckpt")]


def make_cnet_weights(out_dir):
    """Full-width CenterNet R50-DCNv2 on the card with random weights from SEED, spread by
    ``randomise_cnet``, saved as a state_dict."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CNET_CONFIG)
    cfg.merge(_cnet_opts(out_dir))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise_cnet(model.module, generator)
    weights = os.path.join(out_dir, "centernet_r50_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    m = cfg.MODEL
    log(f"[cnet] {CNET_CONFIG}: {m.BACKBONE.NAME} (train-mode BN, freeze_at {m.BACKBONE.FREEZE_AT}), "
        f"DCNv2 + 4x4 deconvolution stages {m.HEAD.DECONV_CHANNEL}, heads at stride {m.HEAD.DOWN_SCALE}, "
        f"{cfg.DATA.NUM_CLASSES} classes, {sum(p.numel() for p in model.module.parameters())} "
        f"parameters, random from seed {SEED} (offset branches random)")
    return weights


def phase_cnet_train(out_dir, weights):
    """det_train on full-width CenterNet, 4 steps of 16 images of 512x512; the scatter counts are
    zeroed just before and read just after. Keeps the first step's three scatter calls (the
    gather's row ids and, on the way back, its cotangent) and its sampling statistics."""
    from basedet_tpu_torch.layers.blocks import deformable
    from basedet_tpu_torch.models.det.centernet import CenterNet
    from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows
    from basedet_tpu_torch.tools import det_train

    kept = []

    def keep_gather(args, out):  # the first step's three DCN stages: row ids, rows, cotangent
        if len(kept) < 3:
            entry = {"idx": args[1].detach().clone(), "rows": args[0].shape[1]}
            out.register_hook(lambda g, e=entry: e.__setitem__("values", g.detach().clone()))
            kept.append(entry)

    def sampling(args, out):  # share of taps between grid points, share wholly off the map
        img, y, x = args
        H, W = img.shape[1:3]
        return (float(((y - y.floor()) > 1e-3).float().mean()),
                float(((y <= -1) | (y >= H) | (x <= -1) | (x >= W)).float().mean()))

    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with recording(CenterNet, "get_losses", keep_losses) as losses, \
            recording(deformable, "gather_rows_batched", keep_gather), \
            recording(deformable, "bilinear_sample_batched", sampling) as taps:
        scatter_rows.launches, scatter_rows_plain.calls = 0, 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", CNET_CONFIG, "--device", "cuda", *_cnet_train_opts(out_dir, weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain_calls = scatter_rows.launches, scatter_rows_plain.calls

    steps = trainer.state.step
    ckpt = os.path.join(out_dir, "cnet_ckpt")
    check(steps == 4 and len(losses) == 4, f"CenterNet det_train took {steps} steps, not 4")
    check(launches == 3 * steps, f"the scatter kernel launched {launches} times in {steps} steps, not 3 each")
    check(plain_calls == 0, f"the plain scatter ran {plain_calls} times on the main path")
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    check(all(len(step) == 4 and step["total_loss"] > 0 for step in losses), f"losses {losses}")
    check(len(kept) == 3 and all("values" in e for e in kept), "the first step's scatter calls were not seen")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"CenterNet det_train wrote no {name}")
    cases = []
    for stage, e in enumerate(kept, 1):
        idx, values, rows = e["idx"], e["values"], e["rows"]
        counts = torch.bincount((idx.long() + torch.arange(idx.shape[0], device=idx.device)[:, None] * rows).flatten(),
                                minlength=idx.shape[0] * rows)
        frac, off = taps[stage - 1]
        log(f"[cnet-train] stage {stage}: scatter of {tuple(values.shape)} {str(values.dtype)[6:]} values into "
            f"R = {rows} rows: entries per row {int(counts.min())}-{int(counts.max())} (mean "
            f"{float(counts.float().mean()):.2f}), {int((counts == 0).sum())} rows empty; taps between grid "
            f"points {frac:.4f}, wholly off the map {off:.4f}")
        cases.append((f"stage {stage}", idx, values.contiguous(), rows))
    side = CNET_IMAGE[0] // 32  # res5
    check(kept[0]["values"].shape == (CNET_B, 9 * side * side, 4 * 2048),
          f"stage 1's scatter took {tuple(kept[0]['values'].shape)}, not the full-width shape")
    check(all(f > 0.5 for f, _ in taps[:3]) and any(o > 0 for _, o in taps[:3]),
          f"the offsets did not spread the taps: {taps[:3]}")
    per_step = "; ".join(", ".join(f"{k} {v:.4f}" for k, v in step.items()) for step in losses)
    log(f"[cnet-train] det_train CenterNet R50-DCNv2, 4 steps of {CNET_B} images {CNET_IMAGE[0]}x{CNET_IMAGE[1]}, "
        f"f32, in {seconds:.2f} s; scatter kernel launches {launches}, plain calls {plain_calls}; lr "
        f"{trainer.meters['lr'].latest:.4g}; losses per step: {per_step}; checkpoints latest.pt, epoch_1.pt, "
        f"dumped_model.pt written")
    return launches, cases, os.path.join(ckpt, "dumped_model.pt")


def phase_scatter_kernel(card, stages):
    """Kernel #9 against its plain version on the first train step's three calls (the step's own
    row ids and cotangents, f32, and the same cast to bf16) and on edge cases, two kernel runs
    bit-equal each time; then each stage timed: kernel (with its sort glue), the glue alone, the
    plain version and ``index_add_`` (atomics, not deterministic; the port never calls it), and
    summed over the three calls of a step."""
    from basedet_tpu_torch.ops.scatter_rows import row_segments, scatter_rows_plain
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows

    cases = list(stages) + [(f"{name} bf16", idx, values.bfloat16(), rows) for name, idx, values, rows in stages]
    cases += [(name, idx.cuda(), values.cuda(), rows)
              for name, (idx, values, rows) in scatter_edges(np.random.RandomState(SEED + 9)).items()]
    worst, worst_err = 0.0, 0.0
    for name, idx, values, rows in cases:
        ratio, err = check_scatter_case(idx, values, rows)
        worst, worst_err = max(worst, ratio), max(worst_err, err)
        log(f"[scatter] {name}: {tuple(values.shape)} {str(values.dtype)[6:]} into {rows} rows: max |kernel - "
            f"plain| {err:.3e}, {ratio:.3f} of the tolerance (SCATTER_RTOL {SCATTER_RTOL:.3e} x sum |values| "
            f"per element); two kernel runs bit-equal")
        check(ratio <= 1.0, f"scatter kernel against its plain version on {name}: {ratio:.3f} of the tolerance")

    step = dict(ms=0.0, glue=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    by = []
    for name, idx, values, rows in stages:
        B, N, D = values.shape
        key = torch.where((idx >= 0) & (idx < rows), idx.long() + torch.arange(B, device="cuda")[:, None] * rows,
                          B * rows).flatten()
        flat = values.view(B * N, D)

        def library():
            return torch.zeros(B * rows + 1, D, device="cuda").index_add_(0, key, flat)

        t = dict(ms=cuda_ms(lambda: scatter_rows(idx, values, rows), reps=20, warmup=3),
                 glue=cuda_ms(lambda: row_segments(idx, rows), reps=20, warmup=3),
                 plain_ms=cuda_ms(lambda: scatter_rows_plain(idx, values, rows), reps=3, warmup=1),
                 library_ms=cuda_ms(library, reps=20, warmup=3))
        t["bound_ms"], b = scatter_bound(idx, values, rows)
        by.append(b)
        for k in step:
            step[k] += t[k]
        log(f"[scatter] {name} {tuple(values.shape)} -> ({B}, {rows}, {D}): kernel {t['ms']:.4f} ms (of which the "
            f"sort glue {t['glue']:.4f}), bound {t['bound_ms']:.4f} ms ({b}), plain {t['plain_ms']:.4f}, "
            f"index_add_ {t['library_ms']:.4f} | {card}")
    log(f"[scatter] per train step at batch {CNET_B} of {CNET_IMAGE[0]}x{CNET_IMAGE[1]} (3 calls): kernel "
        f"{step['ms']:.4f} ms (sort glue {step['glue']:.4f}), bound {step['bound_ms']:.4f} ms, plain "
        f"{step['plain_ms']:.4f}, index_add_ {step['library_ms']:.4f}; worst case {worst:.3f} of the tolerance | {card}")
    return dict(max_abs_err=worst_err, ms=step["ms"], plain_ms=step["plain_ms"], bound_ms=step["bound_ms"],
                bound_by=max(set(by), key=by.count), library_ms=step["library_ms"])


def phase_cnet_slice(out_dir, weights):
    """det_test on full-width CenterNet over 8 requests of one 512x512 image."""
    from basedet_tpu_torch.tools import det_test

    t0 = time.perf_counter()
    results = det_test.main(["-f", CNET_CONFIG, "-w", weights, "--device", "cuda", *_cnet_opts(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(len(records) >= 1, "CenterNet det_test gave no detections")
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    check({r["image_id"] for r in records} == set(range(8)), "not every request was answered")
    log(f"[cnet] det_test CenterNet R50-DCNv2 with {os.path.basename(weights)} on 8 requests of "
        f"{CNET_IMAGE[0]}x{CNET_IMAGE[1]}: {results}, {len(records)} finite detections in {seconds:.2f} s")


def _cnet_train_setup(weights, device, batch):
    """Full-width CenterNet in train mode with ``weights``, its train state and step, and the first
    synthetic batch of ``batch`` 512x512 images."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import DetSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CNET_CONFIG)
    cfg.merge(_cnet_train_opts(".", weights, batch))
    model = build_model(cfg, device)
    model.load_weights(weights)
    solver = DetSolver.build(cfg)
    state = TrainState(model.train(), solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def phase_cnet_card_vs_cpu(weights):
    """CenterNet card against CPU, f32, TF32 off, on one batch of 2 at full width: the eval-mode
    head outputs and detections, then one train forward and backward: losses, gradient norm and
    the new BN running statistics."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows
    from basedet_tpu_torch.utils.compare import match_detections

    runs = {}
    for device in ("cpu", "cuda"):
        model, _, _, batch = _cnet_train_setup(weights, device, CNET_PARITY_B)
        request = {k: batch[k] for k in ("data", "im_info")}
        t0 = time.perf_counter()
        model.eval()
        with torch.inference_mode(), full_f32():
            m = model.module
            y = m.features(model.pre_process(request)["image"])
            stages = {"res5": y.cpu()}
            for i, stage in enumerate(m.upsample.stages(), 1):
                y = stage(y)
                stages[f"deconv{i}"] = y.cpu()
            heads = {k: v.cpu() for k, v in m.heads(y).items()}
        dets = {k: v.cpu().numpy() for k, v in model.inference(request).items()}
        model.train()
        launches = scatter_rows.launches
        model.module.zero_grad(set_to_none=True)
        with full_f32():  # the backward too, as the train step holds it
            total, losses = model.get_losses(batch)
            total.backward()
        norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.module.parameters())))
        stats = {k: v.double().cpu() for k, v in model.module.state_dict().items() if "running" in k}
        runs[device] = dict(heads=heads, stages=stages, dets=dets,
                            losses={k: float(v.detach()) for k, v in losses.items()},
                            norm=norm, stats=stats, launches=scatter_rows.launches - launches,
                            seconds=time.perf_counter() - t0)
    cpu, gpu = runs["cpu"], runs["cuda"]
    head_err = {k: (float((gpu["heads"][k] - v).abs().max()), float(v.abs().max())) for k, v in cpu["heads"].items()}
    worst_head = max(err for err, _ in head_err.values())
    stage_err = {k: float((gpu["stages"][k] - v).abs().max() / v.abs().max()) for k, v in cpu["stages"].items()}
    frac = match_detections(cpu["dets"], gpu["dets"])
    rel = {k: abs(gpu["losses"][k] - v) / max(abs(v), 1e-12) for k, v in cpu["losses"].items()}
    norm_rel = abs(gpu["norm"] - cpu["norm"]) / cpu["norm"]
    stats_rel = max(float(((gpu["stats"][k] - v).abs() / v.abs().clamp(min=1.0)).max())
                    for k, v in cpu["stats"].items())
    log(f"[parity] CenterNet card vs CPU, f32, batch {CNET_PARITY_B} of {CNET_IMAGE[0]}x{CNET_IMAGE[1]} (CPU run "
        f"{cpu['seconds']:.1f} s, plain scatter; card scatter launches {gpu['launches']}): eval features, max |diff| "
        f"over max |value|: {', '.join(f'{k} {v:.3e}' for k, v in stage_err.items())}; heads max |diff| (max |value|) "
        f"{', '.join(f'{k} {e:.3e} ({v:.3e})' for k, (e, v) in head_err.items())} (tol {HEAD_ATOL}); "
        f"{int(cpu['dets']['valid'].sum())} CPU / "
        f"{int(gpu['dets']['valid'].sum())} card detections, {frac:.4f} matched (label, IoU >= 0.999, |dscore| "
        f"<= 1e-4); train losses card {', '.join(f'{k} {v:.6f}' for k, v in gpu['losses'].items())} / CPU "
        f"{', '.join(f'{k} {v:.6f}' for k, v in cpu['losses'].items())}, worst rel diff {max(rel.values()):.3e} "
        f"(tol {LOSS_RTOL}); gradient norm {gpu['norm']:.6f} card / {cpu['norm']:.6f} CPU, rel diff "
        f"{norm_rel:.3e} (tol {GRAD_NORM_RTOL}); new BN running statistics differ by {stats_rel:.3e} of "
        f"max(|value|, 1) (tol {STATS_RTOL})")
    check(gpu["launches"] == 3, f"the card's train backward launched the scatter kernel {gpu['launches']} times")
    check(worst_head <= HEAD_ATOL, f"CenterNet head outputs differ between card and CPU: {head_err}")
    check(np.isfinite(gpu["dets"]["boxes"]).all() and gpu["dets"]["valid"].any(),
          "card detections empty or non-finite")
    check(frac >= 0.95, f"only {frac:.3f} of the CPU's CenterNet detections matched on the card")
    check(all(math.isfinite(v) for v in gpu["losses"].values()), "non-finite CenterNet losses on the card")
    check(max(rel.values()) <= LOSS_RTOL, f"CenterNet train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"CenterNet gradient norms differ by {norm_rel:.3e}")
    check(stats_rel <= STATS_RTOL, f"CenterNet BN running statistics differ by {stats_rel:.3e}")


def phase_cnet_train_timing(weights, card, scatter_step_ms):
    """One f32 CenterNet train step at batch 16 of 512x512 (input already on the card): backbone,
    each deconvolution stage, heads, and targets + losses, each timed alone on the previous
    stage's outputs with gradients enabled; get_losses, get_losses with backward and the whole
    step as nested prefixes; the three scatter calls' share of the backward from the kernel
    phase; peak memory. Returns (step ms, a function running one step)."""
    from basedet_tpu_torch.layers.common.function import full_f32

    model, state, step, batch = _cnet_train_setup(weights, "cuda", CNET_B)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    m, reps = model.module, 10

    def timed(fn):
        def run():
            with full_f32():
                return fn()
        return cuda_ms(run, reps=reps, warmup=2), run()

    x = model.pre_process(batch, train=True)
    t_backbone, y = timed(lambda: m.features(x["image"]))
    t_stages = []
    for stage in m.upsample.stages():
        t, y = timed(lambda y=y, stage=stage: stage(y))
        t_stages.append(t)
    t_heads, pred = timed(lambda: m.heads(y))
    t_losses, _ = timed(lambda: model.losses(pred, x["img_info"], x["gt_boxes"]))
    del y, pred

    def losses_backward():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch)[0].backward()

    t_loss, _ = timed(lambda: model.get_losses(batch)[0])
    t_fb, _ = timed(losses_backward)
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=reps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    t_bwd = t_fb - t_loss
    log(f"[timing] CenterNet R50-DCNv2 f32 train step, batch {CNET_B} of {CNET_IMAGE[0]}x{CNET_IMAGE[1]}: "
        f"{t_step:.3f} ms per step ({1000 * CNET_B / t_step:.2f} img/s); each alone, gradients enabled: backbone "
        f"{t_backbone:.3f}, deconvolution stages {', '.join(f'{t:.3f}' for t in t_stages)}, heads {t_heads:.3f}, "
        f"targets+losses {t_losses:.3f} ms; get_losses {t_loss:.3f} ms, backward {t_bwd:.3f} ms (of which the "
        f"three scatter calls {scatter_step_ms:.3f} ms, {scatter_step_ms / t_bwd:.3f} of it, timed alone on the "
        f"first det_train step's own arguments), SGD {t_step - t_fb:.3f} ms (differences of means of {reps} "
        f"runs of nested prefixes); peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), input "
        f"already on the card | {card}")
    return t_step, lambda: step(state, batch)


# -- RetinaNet R50-FPN and pairwise IoU (kernel #10) ---------------------------------------------

def _iou_boxes(rng, shape, size=200.0):
    """Random xyxy f32 boxes of ``shape`` (..., 4) on a canvas of ``size``, sides 1 to size / 3, as
    tests/ops/test_iou_pallas.py draws them."""
    xy = rng.uniform(0, size, shape[:-1] + (2,))
    wh = rng.uniform(1, size / 3, shape[:-1] + (2,))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))


def iou_edges(rng):
    """Edge cases of kernel #10, on the CPU: name -> (boxes1, boxes2). The special boxes meet each
    other in zero-area, inverted (union <= 0), identical (IoU exactly 1), touching-edge and disjoint
    pairs, and at coordinates up to 1e4."""
    special = torch.tensor([
        [10, 10, 10, 30],  # zero width
        [10, 10, 30, 10],  # zero height
        [5, 5, 5, 5],  # a point
        [30, 30, 10, 10],  # inverted in x and y: area +400
        [30, 10, 10, 40],  # inverted in x: area -600, so unions with it fall to <= 0
        [10, 10, 30, 30],  # identical to itself: IoU exactly 1
        [30, 10, 50, 30],  # touches [10, 10, 30, 30] along x = 30
        [10, 30, 30, 50],  # touches it along y = 30
        [300, 300, 320, 320],  # disjoint from all but itself
        [0, 0, 1e4, 1e4],
        [9990.5, 9990.25, 1e4, 1e4],
        [1234.5, 9000, 9876.25, 9999.75],
    ], dtype=torch.float32)
    mixed = torch.cat([special, _iou_boxes(rng, (20, 4))])
    return {
        "zero-area, inverted, identical, touching, disjoint, 1e4 (2, 32) x (1030,)":
            (torch.stack([mixed, mixed.flip(0)]), torch.cat([special, _iou_boxes(rng, (1018, 4), 1e4)])),
        "M = 1, N = 4097 (off the block and off 4)": (_iou_boxes(rng, (1, 4)), _iou_boxes(rng, (4097, 4))),
        "boxes2 per image (3, 17) x (3, 1021)": (_iou_boxes(rng, (3, 17, 4)), _iou_boxes(rng, (3, 1021, 4))),
        "one set against itself (257,) x (257,)": (mixed.repeat(9, 1)[:257], mixed.repeat(9, 1)[:257]),
    }


def check_iou_case(boxes1, boxes2):
    """Kernel #10 and its plain version on one case on the card: (max |kernel - plain|, whether
    the two are bit-equal)."""
    from basedet_tpu_torch.ops.iou_kernel import box_iou, box_iou_plain

    got = box_iou(boxes1, boxes2)
    torch.cuda.synchronize()
    ref = box_iou_plain(boxes1, boxes2)
    check(got.shape == ref.shape, f"IoU kernel gave {tuple(got.shape)}, plain {tuple(ref.shape)}")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    return err, bool(torch.equal(got.view(torch.int32), ref.view(torch.int32)))


def iou_bound(boxes1, boxes2):
    """(ms, "bytes" or "operations"): both box sets read once, the f32 output written once; ~17
    f32 operations per pair (4 min/max, 2 differences, 2 clamps, the product, the two sums, the
    compare, the max and the quotient, and the two areas' 3 operations each, amortised)."""
    B = boxes1.shape[0] if boxes1.dim() == 3 else 1
    pairs = B * boxes1.shape[-2] * boxes2.shape[-2]
    return bound(4 * pairs + 4 * boxes1.numel() + 4 * boxes2.numel(), 17 * pairs)


@torch.no_grad()
def randomise_retina(module, generator):
    """Draw the frozen BN statistics and affine and every bias from generator, as
    ``randomise_frcnn`` does; spread the class logits' biases by 2 around the prior (-4.6), so that
    some (anchor, class) scores clear the 0.05 threshold (at the prior every score is ~0.01 and NMS
    would see nothing), and raise the box-size regression by log 2, so that a box spans twice its
    anchor and same-class neighbours overlap: NMS then suppresses on the main path."""
    from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm

    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            m.running_mean.normal_(0.0, 0.2, generator=generator)
            m.running_var.uniform_(0.5, 2.0, generator=generator)
            m.weight.uniform_(0.5, 1.5, generator=generator)
        if getattr(m, "bias", None) is not None:
            m.bias.add_(torch.empty_like(m.bias).normal_(0.0, 0.3, generator=generator))
    head = module.head
    head.cls_score.bias.add_(torch.empty_like(head.cls_score.bias).normal_(0.0, 2.0, generator=generator))
    head.bbox_pred.bias.view(-1, 4)[:, 2:].add_(math.log(2.0))  # (dx, dy, dw, dh) per anchor


def _retina_opts(out_dir):
    return ["DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "GLOBAL.OUTPUT_DIR", out_dir]


def _retina_train_opts(out_dir, weights):
    return ["DATA.TRAIN.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", str(FRCNN_IMAGE).replace(" ", ""),
            "MODEL.BATCHSIZE", str(RETINA_B), "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH",
            str(4 * RETINA_B), "GLOBAL.LOG_INTERVAL", "1", "MODEL.WEIGHTS", weights, "GLOBAL.OUTPUT_DIR",
            out_dir, "GLOBAL.CKPT_SAVE_DIR", os.path.join(out_dir, "retina_ckpt")]


def make_retina_weights(out_dir):
    """Full-width RetinaNet R50-FPN on the card with random weights from SEED, spread by
    ``randomise_retina``, saved as a state_dict. Returns (cfg for det_test, model, path)."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(RETINA_CONFIG)
    cfg.merge(_retina_opts(out_dir))
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    model = build_model(cfg, "cuda", generator)
    randomise_retina(model.module, generator)
    weights = os.path.join(out_dir, "retinanet_r50_seed0.pt")
    torch.save(model.module.state_dict(), weights)
    m = cfg.MODEL
    log(f"[retina] {RETINA_CONFIG}: {m.BACKBONE.NAME} (FrozenBN, freeze_at {m.BACKBONE.FREEZE_AT}), FPN "
        f"P3-P7 {m.FPN.OUT_CHANNELS} (p6p7 on {m.FPN.TOP_BLOCK_IN_FEATURE}), "
        f"{model.anchor_gen.num_anchors} anchors per location, {m.HEAD.NUM_CONVS}-conv head, "
        f"{cfg.DATA.NUM_CLASSES} classes, {sum(p.numel() for p in model.module.parameters())} parameters, "
        f"random from seed {SEED}")
    return cfg, model, weights


def low_quality_counts(matcher, matrix, row_valid, labels):
    """(foreground, ignored, the low-quality rule's picks: anchors equal to a valid gt's best IoU, ties
    included, and those of them whose own best IoU is under the foreground threshold, foreground by
    the rule alone) of one Matcher call."""
    masked = torch.where(row_valid[:, :, None], matrix, -1.0)
    picks = ((masked == masked.amax(2, keepdim=True)) & row_valid[:, :, None]).any(1)
    low = picks & (masked.amax(1) < matcher.thresholds[-1])
    return int((labels > 0).sum()), int((labels == -1).sum()), int(picks.sum()), int(low.sum())


def phase_retina_train(out_dir, weights):
    """det_train on full-width RetinaNet, 4 steps of 2 images of 800x1333; the IoU kernel's and its
    plain version's counts are zeroed just before and read just after. Keeps every step's IoU
    arguments (gts and anchors) and, per step, the foreground, ignored and low-quality matches."""
    from basedet_tpu_torch.layers.common.matcher import Matcher
    from basedet_tpu_torch.models.det import retinanet
    from basedet_tpu_torch.models.det.retinanet import RetinaNet
    from basedet_tpu_torch.ops.iou_kernel import box_iou, box_iou_plain
    from basedet_tpu_torch.tools import det_train

    def assigned(args, out):  # foreground, ignored, the low-quality rule's picks and those under the threshold
        return low_quality_counts(*args, out[1])

    keep_losses = lambda args, out: {k: float(v.detach()) for k, v in out[1].items()}
    with recording(retinanet, "box_iou", lambda args, out: tuple(a.clone() for a in args)) as iou_calls, \
            recording(Matcher, "__call__", assigned) as assignments, \
            recording(RetinaNet, "get_losses", keep_losses) as losses:
        box_iou.launches, box_iou_plain.calls = 0, 0
        t0 = time.perf_counter()
        trainer = det_train.main(["-f", RETINA_CONFIG, "--device", "cuda", *_retina_train_opts(out_dir, weights)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain_calls = box_iou.launches, box_iou_plain.calls

    steps = trainer.state.step
    ckpt = os.path.join(out_dir, "retina_ckpt")
    check(steps == 4 and len(losses) == 4, f"RetinaNet det_train took {steps} steps, not 4")
    check(launches == steps, f"the IoU kernel launched {launches} times in {steps} steps")
    check(plain_calls == 0, f"the plain IoU ran {plain_calls} times on the main path")
    check(all(math.isfinite(v) for step in losses for v in step.values()), f"non-finite losses {losses}")
    check(all(len(step) == 3 and step["total_loss"] > 0 for step in losses), f"losses {losses}")
    check(len(assignments) == steps and all(fg > 0 and ign > 0 and picks > 0 for fg, ign, picks, _ in assignments),
          f"a step had no foreground, no ignored anchors or no low-quality pick: {assignments}")
    gts, anchors = iou_calls[0]
    check(tuple(gts.shape) == (RETINA_B, 100, 4) and tuple(anchors.shape) == (RETINA_ANCHORS, 4),
          f"the IoU took {tuple(gts.shape)} x {tuple(anchors.shape)}, not the full-width shape")
    for name in ("latest.pt", "epoch_1.pt", "dumped_model.pt"):
        check(os.path.exists(os.path.join(ckpt, name)), f"RetinaNet det_train wrote no {name}")
    per_step = "; ".join(", ".join(f"{k.replace('_loss', '')} {v:.4f}" for k, v in step.items()) for step in losses)
    log(f"[retina-train] det_train RetinaNet R50-FPN, 4 steps of {RETINA_B} images {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} "
        f"(padded 800x1344), f32, in {seconds:.2f} s; IoU kernel launches {launches} at {tuple(gts.shape)} x "
        f"{tuple(anchors.shape)}, plain calls {plain_calls}; lr {trainer.meters['lr'].latest:.4g}; losses per step: "
        f"{per_step}; per step (foreground, ignored, the low-quality rule's picks, those of them under the "
        f"0.5 threshold) of {RETINA_B * RETINA_ANCHORS} anchors: {assignments}; checkpoints latest.pt, epoch_1.pt, dumped_model.pt written")
    return launches, iou_calls[0], os.path.join(ckpt, "dumped_model.pt")


def phase_iou_kernel(card, step_call):
    """Kernel #10 against its plain version (max |diff| 0 required) on the first train step's own
    gts and anchors, at Faster R-CNN's RPN shape (100 gts x 268,569 anchors per image), SimOTA's
    (8, 100, 8400) with boxes2 per image, the 2-D (300, 130) of tests/ops/test_iou_pallas.py, and
    the edge cases; the kernel and the plain version timed at the four shapes."""
    from basedet_tpu_torch.layers.common.anchor_generator import DefaultAnchorGenerator
    from basedet_tpu_torch.ops.iou_kernel import box_iou, box_iou_plain
    from basedet_tpu_torch.tools import import_config

    rng = np.random.RandomState(SEED + 10)
    m = import_config(FRCNN_CONFIG).MODEL
    rpn_gen = DefaultAnchorGenerator(tuple(map(tuple, m.ANCHOR.SCALES)), tuple(map(tuple, m.ANCHOR.RATIOS)),
                                     tuple(m.FPN.STRIDES), m.ANCHOR.OFFSET)
    rpn_anchors = torch.cat(rpn_gen([*ROI_LEVELS, (13, 21)], "cuda"))
    check(rpn_anchors.shape[0] == FRCNN_ANCHORS, f"{rpn_anchors.shape[0]} Faster R-CNN anchors")
    timed = {
        "RetinaNet train step (gts, anchors)": step_call,
        "Faster R-CNN RPN targets": (_iou_boxes(rng, (FRCNN_TRAIN_B, 100, 4), 1333.0).cuda(), rpn_anchors),
        "SimOTA (boxes2 per image)": (_iou_boxes(rng, (MATCH_B, MATCH_K, 4), 640.0).cuda(),
                                      _iou_boxes(rng, (MATCH_B, MATCH_M, 4), 640.0).cuda()),
        "2-D (300, 130)": (_iou_boxes(rng, (300, 4)).cuda(), _iou_boxes(rng, (130, 4)).cuda()),
    }
    worst = 0.0
    cases = {**timed, **{k: (a.cuda(), b.cuda()) for k, (a, b) in iou_edges(rng).items()}}
    for name, (b1, b2) in cases.items():
        err, bits = check_iou_case(b1, b2)
        worst = max(worst, err)
        log(f"[iou] {name}: {tuple(b1.shape)} x {tuple(b2.shape)}: max |kernel - plain| {err:.3e}, "
            f"bit-equal {bits}")
        check(err == 0.0, f"IoU kernel against its plain version on {name}: max |diff| {err:.3e}")
    b1, _ = cases["one set against itself (257,) x (257,)"]
    proper = (b1[:, 2] > b1[:, 0]) & (b1[:, 3] > b1[:, 1])
    check(bool((box_iou(b1, b1).diagonal()[proper] == 1.0).all()), "a box against itself is not IoU 1")
    out = {}
    for name, (b1, b2) in timed.items():
        ms = cuda_ms(lambda: box_iou(b1, b2), reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: box_iou_plain(b1, b2), reps=5, warmup=1)
        bound_ms, bound_by = iou_bound(b1, b2)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[iou] {name} {tuple(b1.shape)} x {tuple(b2.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}) | {card}")
    log(f"[iou] {len(cases)} cases equal to the plain version (max |diff| 0)")
    return dict(max_abs_err=worst, library_ms=None, **out["RetinaNet train step (gts, anchors)"])


def phase_retina_slice(out_dir, weights):
    """det_test on full-width RetinaNet over 8 requests of one 800x1333 image; the NMS counts are
    zeroed just before and read just after."""
    from basedet_tpu_torch.ops import nms as nms_ops
    from basedet_tpu_torch.ops.nms_kernel import nms_keep, nms_keep_plain
    from basedet_tpu_torch.tools import det_test

    seen = lambda args, keep: (args[0].shape[1], list(zip(args[1].sum(1).tolist(), keep.sum(1).tolist())))
    nms_keep.launches, nms_keep_plain.calls = 0, 0
    t0 = time.perf_counter()
    with recording(nms_ops, "nms_keep", seen) as calls:
        results = det_test.main(["-f", RETINA_CONFIG, "-w", weights, "--device", "cuda", *_retina_opts(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain_calls = nms_keep.launches, nms_keep_plain.calls
    with open(os.path.join(out_dir, "predict_coco.json")) as f:
        records = json.load(f)
    check(len(records) >= 1, "RetinaNet det_test gave no detections")
    check(np.isfinite([r["bbox"] + [r["score"]] for r in records]).all(), "non-finite detections")
    check({r["image_id"] for r in records} == set(range(8)), "not every request was answered")
    check(launches == 8, f"the NMS kernel launched {launches} times for 8 requests")
    check(plain_calls == 0, f"the plain NMS ran {plain_calls} times on the main path")
    check(all(k == RETINA_FINAL_K for k, _ in calls), f"NMS took {[k for k, _ in calls]} candidates, not 5000")
    check(any(k < v for _, call in calls for v, k in call), "NMS suppressed nothing on the main path")
    log(f"[retina] det_test RetinaNet R50-FPN with {os.path.basename(weights)} on 8 requests of "
        f"{FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} (padded 800x1344): {results}, {len(records)} finite detections in "
        f"{seconds:.2f} s; NMS kernel launches {launches} at K = {RETINA_FINAL_K}, plain calls {plain_calls}; "
        f"NMS kept per image {_kept_range([call for _, call in calls])}")
    return launches


def _retina_train_setup(weights, device):
    """Full-width RetinaNet in train mode with ``weights``, its train state and step, and the first
    synthetic batch of 2 images of 800x1333."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import DataloaderBuilder
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import DetSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(RETINA_CONFIG)
    cfg.merge(_retina_train_opts(".", weights))
    model = build_model(cfg, device)
    model.load_weights(weights)
    solver = DetSolver.build(cfg)
    state = TrainState(model.train(), solver)
    return model, state, make_train_step(model, solver, cfg), next(DataloaderBuilder.build(cfg))


def _retina_stages(model, request):
    """res3-res5, P3-P7 and the per-level head outputs of one eval request, and its detections,
    on the CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    m = model.module.eval()
    with torch.inference_mode(), full_f32():
        bottom_up = m.bottom_up(model.pre_process(request)["image"])
        feats = m.fpn(bottom_up)
        logits, offsets = m.head([feats[n] for n in m.level_names])
    stages = {**{k: v.cpu() for k, v in bottom_up.items()}, **{k: feats[k].cpu() for k in m.level_names},
              **{f"logits {n}": x.cpu() for n, x in zip(m.level_names, logits)},
              **{f"offsets {n}": x.cpu() for n, x in zip(m.level_names, offsets)}}
    return stages, {k: v.cpu().numpy() for k, v in model.inference(request).items()}


def _retina_train_pass(model, batch):
    """One train forward and backward at full width: anchor labels, losses, gradient norm, on the
    CPU."""
    from basedet_tpu_torch.layers.common.function import full_f32

    model.train()
    with full_f32():
        x = model.pre_process(batch, train=True)
        logits_l, offsets_l = model.module(x["image"])
        anchors = torch.cat(model.anchors(logits_l), dim=0)
        labels, gt_offsets = model.ground_truth(anchors, x["gt_boxes"], x["img_info"][:, 4].long())
        logits, offsets = (torch.cat(v, dim=1) for v in model.flatten(logits_l, offsets_l))
        losses = model.losses(logits, offsets, labels, gt_offsets)
        model.module.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
    norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in model.module.parameters()
                                if p.grad is not None)))
    return labels.cpu(), {k: float(v.detach()) for k, v in losses.items()}, norm


def phase_retina_card_vs_cpu(cfg, model, weights):
    """RetinaNet card against CPU, f32, TF32 off: det_test's first request (one 800x1333 image)
    stage by stage and its detections, then one train forward and backward at batch 2: anchor
    labels, losses, gradient norm."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_test_dataloader
    from basedet_tpu_torch.ops.iou_kernel import box_iou, box_iou_plain
    from basedet_tpu_torch.utils.compare import match_detections

    cpu = build_model(cfg, "cpu")
    cpu.load_weights(weights)
    request = next(iter(build_test_dataloader(cfg)))
    request = {k: request[k] for k in ("data", "im_info")}
    t0 = time.perf_counter()
    c_stages, c_dets = _retina_stages(cpu, request)
    g_stages, g_dets = _retina_stages(model, request)
    stage_err = {k: float((g_stages[k] - v).abs().max() / v.abs().max()) for k, v in c_stages.items()}
    frac = match_detections(c_dets, g_dets)
    cpu_model, _, _, batch = _retina_train_setup(weights, "cpu")
    plain = box_iou_plain.calls
    c_labels, c_losses, c_norm = _retina_train_pass(cpu_model, batch)
    check(box_iou_plain.calls == plain + 1, "the CPU train pass ran no plain IoU")
    cpu_s = time.perf_counter() - t0
    launches = box_iou.launches
    g_labels, g_losses, g_norm = _retina_train_pass(_retina_train_setup(weights, "cuda")[0], batch)
    check(box_iou.launches == launches + 1, "the card's train pass launched no IoU kernel")
    agree = float((g_labels == c_labels).float().mean())
    rel = {k: abs(g_losses[k] - v) / max(abs(v), 1e-12) for k, v in c_losses.items()}
    norm_rel = abs(g_norm - c_norm) / c_norm
    log(f"[parity] RetinaNet card vs CPU, f32 (CPU runs {cpu_s:.1f} s, plain IoU): one {FRCNN_IMAGE[0]}x"
        f"{FRCNN_IMAGE[1]} image, max |diff| over max |value| per stage: "
        f"{', '.join(f'{k} {v:.3e}' for k, v in stage_err.items())} (tol {HEAD_ATOL}); "
        f"{int(c_dets['valid'].sum())} CPU / {int(g_dets['valid'].sum())} card detections, {frac:.4f} matched "
        f"(label, IoU >= 0.999, |dscore| <= 1e-4); train pass at batch {RETINA_B}: anchor labels agree on "
        f"{agree:.6f} of {c_labels.numel()} (min {LABEL_AGREE}; CPU {int((c_labels > 0).sum())} foreground, "
        f"{int((c_labels == -1).sum())} ignored); losses card {', '.join(f'{k} {v:.6f}' for k, v in g_losses.items())} "
        f"/ CPU {', '.join(f'{k} {v:.6f}' for k, v in c_losses.items())}, worst rel diff {max(rel.values()):.3e} "
        f"(tol {LOSS_RTOL}); gradient norm {g_norm:.6f} card / {c_norm:.6f} CPU, rel diff {norm_rel:.3e} "
        f"(tol {GRAD_NORM_RTOL})")
    check(max(stage_err.values()) <= HEAD_ATOL, f"RetinaNet stages differ between card and CPU: {stage_err}")
    phase_retina_low_quality(cpu_model, model)
    check(np.isfinite(g_dets["boxes"]).all() and g_dets["valid"].any(), "card detections empty or non-finite")
    check(frac >= FRCNN_AGREE, f"only {frac:.3f} of the CPU's RetinaNet detections matched on the card")
    check(agree >= LABEL_AGREE, f"only {agree:.6f} of the anchor labels agree between card and CPU")
    check(all(math.isfinite(v) for v in g_losses.values()), "non-finite RetinaNet losses on the card")
    check(max(rel.values()) <= LOSS_RTOL, f"RetinaNet train losses differ between card and CPU: {rel}")
    check(norm_rel <= GRAD_NORM_RTOL, f"RetinaNet gradient norms differ by {norm_rel:.3e}")


def _small_gts(rng, B, K=100, n=12):
    """(B, K, 5) padded gts whose best anchor IoU lies under the 0.4 background threshold: n valid rows
    per image, alternately 8x8 boxes (each inside several 32x32 and ratio anchors of area 1024 at once,
    so that its best IoU, 64/1024, ties across them) and 400x20 slivers."""
    gt = np.zeros((B, K, 5), np.float32)
    small = np.arange(n) % 2 == 0
    for b in range(B):
        x, y = rng.uniform(20, 900, n), rng.uniform(20, 760, n)
        w, h = np.where(small, 8.0, 400.0), np.where(small, 8.0, 20.0)
        gt[b, :n] = np.stack([x, y, x + w, y + h, rng.randint(1, 81, n)], 1)
    return torch.from_numpy(gt)


def phase_retina_low_quality(cpu_model, model):
    """The anchor assignment (IoU kernel, Matcher, encode) on the card against the CPU's on gts that only
    the low-quality rule can match (the synthetic loader's boxes, 10-40% of the image, always find an
    anchor at IoU >= 0.5): labels equal, offsets within 1e-5, low-quality matches and ties among them
    live."""
    from basedet_tpu_torch.ops.iou_kernel import box_iou_plain

    gts = _small_gts(np.random.RandomState(SEED + 11), RETINA_B)
    num = torch.full((RETINA_B,), 12, dtype=torch.int64)
    anchors = torch.cat(cpu_model.anchors([torch.zeros(1, 1, h, w) for h, w in RETINA_LEVELS]))
    check(anchors.shape[0] == RETINA_ANCHORS, f"{anchors.shape[0]} RetinaNet anchors")
    runs = {}
    for m in (cpu_model, model):
        labels, offsets = m.ground_truth(anchors.to(m.device), gts.to(m.device), num.to(m.device))
        runs[m.device.type] = labels.cpu(), offsets.cpu()
    valid = torch.arange(gts.shape[1])[None] < num[:, None]
    fg, ign, picks, low = low_quality_counts(cpu_model.matcher, box_iou_plain(gts[..., :4], anchors), valid,
                                             runs["cpu"][0])
    same = torch.equal(runs["cuda"][0], runs["cpu"][0])
    off_err = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
    log(f"[retina] assignment on gts only the low-quality rule matches ({int(num.sum())} valid: 8x8 boxes and "
        f"400x20 slivers): card labels equal to the CPU's {same}, offsets max |diff| {off_err:.3e}; foreground {fg} "
        f"= the rule's picks {picks} (ties included), {low} of them under the 0.5 threshold; ignored {ign}")
    check(same, "the card's anchor labels differ from the CPU's on the low-quality gts")
    check(off_err <= 1e-5, f"the card's anchor offsets differ from the CPU's by {off_err:.3e}")
    check(low > 0 and picks > int(num.sum()), f"low-quality matches {low}, picks {picks}: the rule or its ties are not live")


def phase_retina_train_timing(weights, card):
    """One f32 RetinaNet train step at batch 2 of 800x1333 (input already on the card): backbone +
    FPN, head, the IoU kernel alone, the assignment (IoU + Matcher + encode) and the losses, each
    timed alone on the previous stage's outputs with gradients enabled; get_losses, get_losses with
    backward and the whole step as nested prefixes; peak memory. Returns (step ms, a function
    running one step)."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.iou_kernel import box_iou

    model, state, step, batch = _retina_train_setup(weights, "cuda")
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    m, reps = model.module, 10

    def timed(fn):
        def run():
            with full_f32():
                return fn()
        return cuda_ms(run, reps=reps, warmup=2), run()

    x = model.pre_process(batch, train=True)
    num_gt = x["img_info"][:, 4].long()
    t_feat, feats = timed(lambda: m.features(x["image"]))
    t_head, (logits_l, offsets_l) = timed(lambda: m.head(feats))
    anchors = torch.cat(model.anchors(logits_l), dim=0)
    gts = x["gt_boxes"][..., :4].contiguous()
    t_iou = cuda_ms(lambda: box_iou(gts, anchors), reps=reps, warmup=2)
    t_assign, (labels, gt_offsets) = timed(lambda: model.ground_truth(anchors, x["gt_boxes"], num_gt))
    t_losses, _ = timed(lambda: model.losses(*(torch.cat(v, dim=1) for v in model.flatten(logits_l, offsets_l)),
                                              labels, gt_offsets))
    del feats, logits_l, offsets_l

    def losses_backward():
        m.zero_grad(set_to_none=True)
        model.get_losses(batch)[0].backward()

    t_loss, _ = timed(lambda: model.get_losses(batch)[0])
    t_fb, _ = timed(losses_backward)
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=reps, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    log(f"[timing] RetinaNet R50-FPN f32 train step, batch {RETINA_B} of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]}: "
        f"{t_step:.3f} ms per step ({1000 * RETINA_B / t_step:.2f} img/s); each alone, gradients enabled: "
        f"backbone+FPN {t_feat:.3f}, head {t_head:.3f}, assignment (IoU kernel + Matcher + encode) "
        f"{t_assign:.3f} ms (the IoU kernel alone {t_iou:.4f}), flatten+losses {t_losses:.3f} ms; get_losses "
        f"{t_loss:.3f} ms, backward {t_fb - t_loss:.3f} ms, SGD {t_step - t_fb:.3f} ms (differences of means of "
        f"{reps} runs of nested prefixes); peak memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), "
        f"input already on the card | {card}")
    return t_step, lambda: step(state, batch)


def phase_retina_timing(model, card):
    """RetinaNet f32 inference at batch 1 and 8 of 800x1333, input on the card: the whole request,
    the network, the per-level top-1000 (sigmoid, stable sort of R·C scores, decode) and NMS with
    the rescale, each timed alone on the previous stage's outputs, means of 10."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.common.post_processing import post_processing

    test_cfg = model.cfg.TEST
    for bs in (1, 8):
        batch = _timing_batch(bs, FRCNN_IMAGE)
        total = cuda_ms(lambda: model.inference(batch), reps=10, warmup=2)
        torch.cuda.reset_peak_memory_stats()
        model.inference(batch)
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode(), full_f32():
            x = model.pre_process(batch)
            image, info = x["image"], x["img_info"]
            t_net = cuda_ms(lambda: model.module(image), reps=10, warmup=2)
            logits_l, offsets_l = model.module(image)
            flat = model.flatten(logits_l, offsets_l)
            anchors = model.anchors(logits_l)
            t_topk = cuda_ms(lambda: model.candidates(*flat, anchors), reps=10, warmup=2)
            cands = model.candidates(*flat, anchors)
            t_nms = cuda_ms(lambda: post_processing(*cands, info, test_cfg.IOU_THRESHOLD,
                                                    test_cfg.MAX_BOXES_PER_IMAGE), reps=10, warmup=2)
        log(f"[timing] RetinaNet R50-FPN f32 {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} batch {bs}: {total:.3f} ms per batch "
            f"({1000 * bs / total:.2f} img/s); network {t_net:.3f}, top-1000 per level + decode {t_topk:.3f}, "
            f"NMS at K = {cands[1].shape[1]} + rescale {t_nms:.3f} ms (each alone, means of 10); peak memory "
            f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated), input already on the card | {card}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", help="also profile inference and the train steps, tables into DIR")
    args = parser.parse_args()
    card = phase_device()
    phase_build()
    kernel = phase_kernel(card)
    matching = phase_matching(card)
    roi = phase_roi_align(card)
    roi_bwd = phase_roi_align_bwd(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        cfg, model, weights = make_weights(out_dir)
        match_launches, dumped = phase_train(out_dir, weights)
        launches = phase_slice(out_dir, cfg, dumped)
        phase_card_vs_cpu(cfg, model, weights)
        phase_train_vs_cpu(weights)
        steps = {None: phase_train_timing(weights, card)}
        fused_fwd, fused_bwd, fused_step = phase_fused_kernels(weights, card)
        (amp_fused, amp_fused_bwd, amp_match), amp_err, amp_dumped = phase_train_amp(out_dir, weights)
        amp_nms = phase_slice(out_dir, cfg, amp_dumped)
        for errs in (amp_err, phase_amp_train_vs_cpu(weights)):
            for report, err in zip((fused_fwd, fused_bwd), _fused_errs(errs)):
                report["max_abs_err"] = max(report["max_abs_err"], err)
        steps["bf16"] = phase_train_timing(weights, card, "bf16")
        steps["fused"] = phase_train_timing(weights, card, "fused", fused_step)
        frcnn_cfg, frcnn, frcnn_weights = make_frcnn_weights(out_dir)
        (train_roi, train_roi_bwd, train_nms), frcnn_dumped = phase_frcnn_train(out_dir, frcnn_weights)
        roi_launches, frcnn_nms_launches = phase_frcnn_slice(out_dir, frcnn_dumped)
        phase_frcnn_card_vs_cpu(frcnn_cfg, frcnn, frcnn_weights)
        phase_frcnn_train_vs_cpu(frcnn_weights)
        phase_frcnn_train_timing(frcnn_weights, card)
        cnet_weights = make_cnet_weights(out_dir)
        cnet_launches, scatter_stages, cnet_dumped = phase_cnet_train(out_dir, cnet_weights)
        scatter = phase_scatter_kernel(card, scatter_stages)
        del scatter_stages
        phase_cnet_slice(out_dir, cnet_dumped)
        phase_cnet_card_vs_cpu(cnet_weights)
        cnet_step = phase_cnet_train_timing(cnet_weights, card, scatter["ms"])
        retina_cfg, retina, retina_weights = make_retina_weights(out_dir)
        iou_launches, iou_call, retina_dumped = phase_retina_train(out_dir, retina_weights)
        iou = phase_iou_kernel(card, iou_call)
        del iou_call
        retina_nms = phase_retina_slice(out_dir, retina_dumped)
        phase_retina_card_vs_cpu(retina_cfg, retina, retina_weights)
        retina_step = phase_retina_train_timing(retina_weights, card)
    totals = phase_timing(model, card)
    if args.profile:
        batches = {bs: _timing_batch(bs) for bs in (1, 32)}
        phase_profile(card, args.profile, [
            *((f"b{bs}", f"YOLOX-S f32 640x640 batch {bs}", functools.partial(model.inference, batches[bs]), iters,
               totals[bs]) for bs, iters in ((1, 5), (32, 3))),
            *((f"step_{amp or 'f32'}", f"YOLOX-S {AMP_LABELS[amp]} train step, batch 8 of 640x640", run, 3, ms)
              for amp, (ms, run) in steps.items())])
    phase_frcnn_timing(frcnn, card)
    phase_retina_timing(retina, card)
    if args.profile:
        phase_profile(card, args.profile, [
            ("step_centernet", f"CenterNet R50-DCNv2 f32 train step, batch {CNET_B} of {CNET_IMAGE[0]}x"
             f"{CNET_IMAGE[1]}", cnet_step[1], 3, cnet_step[0]),
            ("step_retinanet", f"RetinaNet R50-FPN f32 train step, batch {RETINA_B} of {FRCNN_IMAGE[0]}x"
             f"{FRCNN_IMAGE[1]}", retina_step[1], 3, retina_step[0])])
    log(f"[report] launches on the main paths: nms_keep {launches} on YOLOX-S det_test + {amp_nms} on "
        f"det_test of the --amp run + {train_nms} on Faster R-CNN det_train + {frcnn_nms_launches} on its "
        f"det_test; dynamic_k_matching {match_launches} on det_train + {amp_match} on det_train --amp; "
        f"multilevel_roi_align {train_roi} on det_train + {roi_launches} on det_test; fused_gemm_stats and "
        f"its backward {amp_fused} and {amp_fused_bwd} on det_train --amp; scatter_rows {cnet_launches} on "
        f"CenterNet det_train; box_iou {iou_launches} on RetinaNet det_train; nms_keep {retina_nms} on RetinaNet "
        f"det_test")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    report = {"kernels": [{
        "name": "nms_keep", "route": "cuda", "source": "basedet_tpu_torch/csrc/nms.cu",
        "replaces": "basedet_tpu/ops/nms_pallas.py:26",
        "launches": launches + amp_nms + train_nms + frcnn_nms_launches + retina_nms,
        **{k: kernel[k] for k in keys},
    }, {
        "name": "dynamic_k_matching", "route": "cuda", "source": "basedet_tpu_torch/csrc/matching.cu",
        "replaces": "basedet_tpu/ops/matching_pallas.py:31", "launches": match_launches + amp_match,
        **{k: matching[k] for k in keys},
    }, {
        "name": "multilevel_roi_align", "route": "cuda", "source": "basedet_tpu_torch/csrc/roi_align.cu",
        "replaces": "basedet_tpu/ops/roi_align_window.py:257 and basedet_tpu/ops/roi_align_pallas.py:54",
        "launches": train_roi + roi_launches, **{k: roi[k] for k in keys},
    }, {
        "name": "multilevel_roi_align_backward", "route": "cuda",
        "source": "basedet_tpu_torch/csrc/roi_align.cu",
        "replaces": "basedet_tpu/ops/roi_align_window.py:355 and basedet_tpu/ops/roi_align_pallas.py:94",
        "launches": train_roi_bwd, **{k: roi_bwd[k] for k in keys},
    }, {
        "name": "fused_gemm_stats", "route": "cuda", "source": "basedet_tpu_torch/csrc/fused_bn.cu",
        "replaces": "basedet_tpu/ops/fused_bn.py:152", "launches": amp_fused, **{k: fused_fwd[k] for k in keys},
    }, {
        "name": "fused_gemm_stats_backward", "route": "cuda", "source": "basedet_tpu_torch/csrc/fused_bn.cu",
        "replaces": "basedet_tpu/ops/fused_bn.py:257", "launches": amp_fused_bwd,
        **{k: fused_bwd[k] for k in keys},
    }, {
        "name": "scatter_rows", "route": "cuda", "source": "basedet_tpu_torch/csrc/scatter_rows.cu",
        "replaces": "basedet_tpu/ops/scatter_onehot.py:117", "launches": cnet_launches,
        **{k: scatter[k] for k in keys},
    }, {
        "name": "box_iou", "route": "cuda", "source": "basedet_tpu_torch/csrc/iou.cu",
        "replaces": "basedet_tpu/ops/iou_pallas.py:37", "launches": iou_launches, **{k: iou[k] for k in keys},
    }]}
    log(json.dumps(report))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
