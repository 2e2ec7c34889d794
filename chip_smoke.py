#!/usr/bin/env python3
"""Smoke test of basedet_tpu_torch on one NVIDIA GPU:

    python3 chip_smoke.py [--profile DIR]

Run from the root of the repository. Phases, each of which raises on failure:
  1. device: require CUDA, print the card's name and power limit. The script
     sets no precision: the port's YOLOXModule and train step run in IEEE f32
     (TF32 off) by themselves, and phases 5 and 8 hold them to the CPU;
  2. build both kernels afresh, in parallel: basedet_tpu_torch/csrc/nms.cu
     and csrc/matching.cu, with their ptxas reports;
  3. hold the NMS kernel to its plain PyTorch version on the card, exactly,
     on random batches at the eval slice's shape and on edge cases; time both;
  4. the same for the SimOTA matching kernel, at the train slice's shape
     (8, 100, 8400) and on edge cases and one 832x832 case;
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
 10. with --profile DIR only: a torch.profiler pass over inference at both
     batch sizes, kernel tables written to DIR, busy time and idle share;
 11. print the kernel report, the card, and the result line.
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
CONFIG = "playground/yolox_s/config.py"
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


def phase_build():
    from basedet_tpu_torch.ops import _build, matching_kernel, nms_kernel

    sources = [nms_kernel.SOURCE, matching_kernel.SOURCE]
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


def phase_kernel():
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
    kept = nms_keep(b, v, SLICE_T).sum(1).tolist()
    log(f"[kernel] {n_cases} cases equal; B={SLICE_B} K={SLICE_K} t={SLICE_T} (clustered, "
        f"kept per image {min(kept)}-{max(kept)} of {SLICE_K}): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms per call")
    return dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms)


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
    return dict(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms)


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


def _timing_batch(bs):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data = torch.rand(bs, 640, 640, 3, device="cuda", generator=gen) * 255
    info = torch.tensor([[640, 640, 640, 640, 0]], dtype=torch.float32, device="cuda").repeat(bs, 1)
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR", help="also profile inference, tables into DIR")
    args = parser.parse_args()
    card = phase_device()
    phase_build()
    kernel = phase_kernel()
    matching = phase_matching(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
        cfg, model, weights = make_weights(out_dir)
        match_launches, dumped = phase_train(out_dir, weights)
        launches = phase_slice(out_dir, cfg, dumped)
        phase_card_vs_cpu(cfg, model, weights)
        phase_train_vs_cpu(weights)
        phase_train_timing(weights, card)
    totals = phase_timing(model, card)
    if args.profile:
        phase_profile(model, card, args.profile, totals)
    report = {"kernels": [{
        "name": "nms_keep", "route": "cuda", "source": "basedet_tpu_torch/csrc/nms.cu",
        "replaces": "basedet_tpu/ops/nms_pallas.py:26", "launches": launches,
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
    }, {
        "name": "dynamic_k_matching", "route": "cuda", "source": "basedet_tpu_torch/csrc/matching.cu",
        "replaces": "basedet_tpu/ops/matching_pallas.py:31", "launches": match_launches,
        "max_abs_err": matching["max_abs_err"], "ms": matching["ms"], "plain_ms": matching["plain_ms"],
    }]}
    log(json.dumps(report))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
