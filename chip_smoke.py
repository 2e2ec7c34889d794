#!/usr/bin/env python3
"""Smoke test of basedet_tpu_torch on one NVIDIA GPU:

    python3 chip_smoke.py [--profile DIR]

Run from the root of the repository. Phases, each of which raises on failure:
  1. device: require CUDA, print the card's name and power limit. The script
     sets no precision: the port's models and train step run in IEEE f32
     (TF32 off) by themselves, and phases 5, 8 and 13 hold them to the CPU;
  2. build the three kernels afresh, in parallel: basedet_tpu_torch/csrc/nms.cu,
     csrc/matching.cu and csrc/roi_align.cu, with their ptxas reports;
  3. hold the NMS kernel to its plain PyTorch version on the card, exactly,
     on random batches at the YOLOX eval shape, at Faster R-CNN's two shapes
     (RPN, K = 4819, and the final class-aware NMS, K = 2000) and on edge
     cases; time both;
  4. the same for the SimOTA matching kernel, at the train slice's shape
     (8, 100, 8400) and on edge cases and one 832x832 case;
  4b. hold the RoIAlign kernel to its plain version within 1e-5 of
     max(1, max|F|), at Faster R-CNN's eval shape (B = 1 and 2, R = 1000,
     C = 256, the levels of an 800x1344 input) and on edge cases; time both;
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
 10. with --profile DIR only: a torch.profiler pass over YOLOX-S inference
     at both batch sizes, kernel tables written to DIR, busy time and idle
     share;
 11. Faster R-CNN R50-FPN (full width, random weights from a seed with the
     frozen BN statistics, affine and biases spread) through det_test over 8
     requests of one 800x1333 image; check the RoIAlign kernel ran 8 times
     and the NMS kernel 16, their plain versions never, and RoIs landed on
     every level P2-P5;
 12. hold its card inference to a CPU run of the same weights and image:
     proposals and detections slot by slot;
 13. time its inference at batch 1 and batch 8, split into backbone+FPN,
     RPN+proposals, RoIAlign, box head and post-process, with peak memory;
 14. print the kernel report, the card, and the result line.
"""
import argparse
import concurrent.futures
import contextlib
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
ROI_R, ROI_C, ROI_STRIDES = 1000, 256, (4, 8, 16, 32)
ROI_LEVELS = [(200, 336), (100, 168), (50, 84), (25, 42)]
FRCNN_ATOL, FRCNN_AGREE = 1e-3, 0.95
# NVIDIA H100 SXM data sheet: HBM3 rate, f32 rate outside the tensor cores
PEAK_BYTES_PER_S, PEAK_F32_PER_S = 3.35e12, 67e12
SLICE_B, SLICE_K, SLICE_T = 8, 3000, 0.65  # YOLOX-S eval: 3 levels x top-1000, IoU 0.65
HEAD_ATOL = 1e-3
MATCH_B, MATCH_K, MATCH_M = 8, 100, 8400  # YOLOX-S train: batch 8, MAX_INSTANCES 100, 640x640
MATCH_M_832 = 104 * 104 + 52 * 52 + 26 * 26  # anchors at 832x832
LOSS_RTOL, FG_AGREE, GRAD_NORM_RTOL, STATS_RTOL = 1e-3, 0.999, 1e-3, 1e-4


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


def bound(bytes_moved, ops):
    """The least time (ms) the card could take: bytes over the memory rate
    or f32 operations over the f32 rate, whichever is larger, and which."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from basedet_tpu_torch.ops import _build, matching_kernel, nms_kernel, roi_align_kernel

    sources = [nms_kernel.SOURCE, matching_kernel.SOURCE, roi_align_kernel.SOURCE]
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
    for name, K, t in (("frcnn rpn", FRCNN_RPN_K, FRCNN_RPN_T), ("frcnn final", FRCNN_FINAL_K, FRCNN_FINAL_T)):
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
        f"({bound_by}) | {card}")
    for name, K, t in (("frcnn rpn", FRCNN_RPN_K, FRCNN_RPN_T), ("frcnn final", FRCNN_FINAL_K, FRCNN_FINAL_T)):
        b = torch.from_numpy(_random_boxes(rng, 1, K, True)).cuda()
        v = torch.ones(1, K, dtype=torch.bool, device="cuda")
        k_ms = cuda_ms(lambda: nms_keep(b, v, t), reps=50, warmup=5)
        p_ms = cuda_ms(lambda: nms_keep_plain(b, v, t), reps=2, warmup=1)
        keep = nms_keep(b, v, t)
        k_bound, k_by = nms_bound(v, keep)
        log(f"[kernel] {name} B=1 K={K} t={t} (clustered, {int(keep.sum())} kept): kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.3f} ms per call, bound {k_bound:.6f} ms ({k_by}) | {card}")
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
def recording(owner, name, keep=lambda args, out: args):
    """Replace ``owner.name`` with a wrapper that calls it and records
    ``keep(args, result)`` for each call; put it back on the way out."""
    fn, calls = getattr(owner, name), []

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(keep(args, out))
        return out

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


def _train_setup(weights, device, batch_size):
    """YOLOX-S in train mode with ``weights``, its solver, state and step,
    and the first synthetic batch of ``batch_size`` 640x640 images."""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.data import build_train_dataloader
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.solver import YOLOXSolver
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(CONFIG)
    cfg.merge(["DATA.TRAIN.name", "dummy", "MODEL.BATCHSIZE", str(batch_size)])
    model = build_model(cfg, device)
    model.load_weights(weights)
    model.train()
    solver = YOLOXSolver.build(cfg)
    state = TrainState(model, solver, ema=True)
    return model, solver, state, make_train_step(model, solver, cfg), next(build_train_dataloader(cfg))


def phase_train_vs_cpu(weights):
    """One train step on the card and on the CPU, same weights and batch.
    The gradient norm is read where the step hands the gradients to the
    solver, before the optimizer (whose CUDA path updates some in place)."""
    def grad_norm(args, out):
        return float(torch.sqrt(sum((p.grad.double() ** 2).sum() for p in args[0])))

    runs = {}
    for device in ("cuda", "cpu"):
        model, solver, state, step, batch = _train_setup(weights, device, 2)
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


def phase_train_timing(weights, card):
    """One f32 train step at batch 8 of 640x640 (input already on the card,
    multiscale pinned), as a total and split by prefix: the forward, the
    assignment alone (the matching kernel inside), get_losses (forward,
    assignment, losses), get_losses with backward, the whole step."""
    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching

    model, _, state, step, batch = _train_setup(weights, "cuda", 8)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    image = model.pre_process(batch, train=True)["image"]

    def forward():
        with full_f32():
            model.module(image)

    def losses():
        with full_f32():
            return model.get_losses(batch)[0]

    def losses_backward():
        with full_f32():
            losses().backward()

    with recording(model, "assign", lambda args, out: args) as assigned:
        losses()
    launches = dynamic_k_matching.launches
    t_fwd = cuda_ms(forward, reps=10, warmup=3)
    t_assign = cuda_ms(lambda: model.assign(*assigned[0]), reps=10, warmup=3)
    t_loss = cuda_ms(losses, reps=10, warmup=3)
    t_fb = cuda_ms(losses_backward, reps=10, warmup=3)
    torch.cuda.reset_peak_memory_stats()
    t_step = cuda_ms(lambda: step(state, batch), reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated()
    check(dynamic_k_matching.launches > launches, "train timing ran no matching kernel")
    log(f"[timing] YOLOX-S f32 train step, batch 8 of 640x640: {t_step:.3f} ms per step "
        f"({8000 / t_step:.1f} img/s): forward {t_fwd:.3f} ms, assignment {t_assign:.3f} ms "
        f"(matching kernel inside), losses {t_loss - t_fwd - t_assign:.3f} ms, backward "
        f"{t_fb - t_loss:.3f} ms, SGD+EMA {t_step - t_fb:.3f} ms (parts are differences of means "
        f"of 10 runs each); peak memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated), input already on the card | {card}")


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


def phase_profile(model, card, out_dir, totals):
    """torch.profiler over a few inferences per batch size: device kernel time
    per batch against the profiled wall time, and against the unprofiled
    total of phase 6 (the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    for bs, iters in ((1, 5), (32, 3)):
        batch = _timing_batch(bs)
        for _ in range(3):
            model.inference(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model.inference(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1000 / iters
        averages = prof.key_averages()
        key = "self_device_time_total" if hasattr(averages[0], "self_device_time_total") else "self_cuda_time_total"
        kernels = sorted((e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -getattr(e, key))
        busy = sum(getattr(e, key) for e in kernels) / 1000 / iters
        check(busy > 0, "the profiler saw no device time")
        path = os.path.join(out_dir, f"profile_b{bs}.txt")
        with open(path, "w") as f:
            f.write(f"YOLOX-S f32 640x640 batch {bs}, {iters} inferences | {card}\n")
            f.write(averages.table(sort_by=key, row_limit=60, max_name_column_width=90))
        top = ", ".join(f"{e.key[:48]} {getattr(e, key) / 1000 / iters:.3f} ms" for e in kernels[:6])
        log(f"[profile] batch {bs}: {sum(e.count for e in kernels) / iters:.0f} device kernels per "
            f"batch, busy {busy:.3f} ms of {wall:.3f} ms profiled wall (idle share {1 - busy / wall:.3f}; "
            f"{1 - busy / totals[bs]:.3f} against the unprofiled {totals[bs]:.3f} ms) -> {path}")
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


def _roi_feats(gen, B):
    return [torch.randn(B, ROI_C, h, w, device="cuda", generator=gen) for h, w in ROI_LEVELS]


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
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    rng, gen = np.random.RandomState(SEED), torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for B in (1, 2):
        feats = _roi_feats(gen, B)
        rois = torch.from_numpy(_proposal_rois(rng, B, ROI_R)).cuda()
        worst = max(worst, _check_roi_align("slice", feats, rois))
    worst = max(worst, _check_roi_align("edges", _roi_feats(gen, 1), torch.from_numpy(_edge_rois()).cuda()))
    big = [f * 1000.0 for f in _roi_feats(gen, 1)]  # the tolerance scales with max |F|
    worst = max(worst, _check_roi_align("edges |F|~4e3", big, torch.from_numpy(_edge_rois()).cuda()))

    feats = _roi_feats(gen, 1)
    rois = torch.from_numpy(_proposal_rois(rng, 1, ROI_R)).cuda()
    levels = roi_level_assignment(rois, 2, 5)
    ms = cuda_ms(lambda: multilevel_roi_align(feats, rois, levels, ROI_STRIDES), reps=50, warmup=5)
    copy_ms = cuda_ms(lambda: [f.permute(0, 2, 3, 1).contiguous() for f in feats], reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: multilevel_roi_align_plain(feats, rois, levels, ROI_STRIDES), reps=3, warmup=1)
    bound_ms, bound_by, feat_bytes = roi_align_bound(feats, rois, levels)
    log(f"[roi] B=1 R={ROI_R} C={ROI_C} levels {ROI_LEVELS}: wrapper {ms:.4f} ms per call (of which "
        f"the channels-last copy of P2-P5 alone {copy_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {feat_bytes / 1e6:.1f} MB of the "
        f"{sum(f.numel() * 4 for f in feats) / 1e6:.1f} MB of P2-P5 touched) | {card}")
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
    log(f"[frcnn] det_test Faster R-CNN R50-FPN on 8 requests of {FRCNN_IMAGE[0]}x{FRCNN_IMAGE[1]} "
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", help="also profile inference, tables into DIR")
    args = parser.parse_args()
    card = phase_device()
    phase_build()
    kernel = phase_kernel(card)
    matching = phase_matching(card)
    roi = phase_roi_align(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        cfg, model, weights = make_weights(out_dir)
        match_launches, dumped = phase_train(out_dir, weights)
        launches = phase_slice(out_dir, cfg, dumped)
        phase_card_vs_cpu(cfg, model, weights)
        phase_train_vs_cpu(weights)
        phase_train_timing(weights, card)
        frcnn_cfg, frcnn, frcnn_weights = make_frcnn_weights(out_dir)
        roi_launches, frcnn_nms_launches = phase_frcnn_slice(out_dir, frcnn_weights)
        phase_frcnn_card_vs_cpu(frcnn_cfg, frcnn, frcnn_weights)
    totals = phase_timing(model, card)
    if args.profile:
        phase_profile(model, card, args.profile, totals)
    phase_frcnn_timing(frcnn, card)
    log(f"[report] nms_keep launches: {launches} on YOLOX-S det_test + {frcnn_nms_launches} on "
        f"Faster R-CNN det_test")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    report = {"kernels": [{
        "name": "nms_keep", "route": "cuda", "source": "basedet_tpu_torch/csrc/nms.cu",
        "replaces": "basedet_tpu/ops/nms_pallas.py:26", "launches": launches + frcnn_nms_launches,
        **{k: kernel[k] for k in keys},
    }, {
        "name": "dynamic_k_matching", "route": "cuda", "source": "basedet_tpu_torch/csrc/matching.cu",
        "replaces": "basedet_tpu/ops/matching_pallas.py:31", "launches": match_launches,
        **{k: matching[k] for k in keys},
    }, {
        "name": "multilevel_roi_align", "route": "cuda", "source": "basedet_tpu_torch/csrc/roi_align.cu",
        "replaces": "basedet_tpu/ops/roi_align_window.py:257", "launches": roi_launches,
        **{k: roi[k] for k in keys},
    }]}
    log(json.dumps(report))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
