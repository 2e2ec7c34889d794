"""Host input-pipeline benchmark of the port (counterpart of
``basedet_tpu/tools/bench_pipeline.py``): the real YOLOX loader (mosaic,
random affine, mixup, HSV, flip, pad collate, pinning) on a synthetic set
written by ``sanity_e2e.make_synthetic_coco``.

    python -m basedet_tpu_torch.tools.bench_pipeline [--workers 0 2 4 8] [--size 640] [--batch-size 8]
        [--batches 8] [--images 200] [--device cuda]

Prints one JSON line per measurement:
- ``loader``: images/s and ms per batch at each worker count, after two
  warm-up batches;
- ``split``: one batch made serially in this process: the per-sample
  pipeline, the pack (collation) and the pinning, and the pack's share of
  the batch's host time;
- ``copy`` (CUDA only): one batch's images to the card from page-locked
  memory (``non_blocking=True``) and from pageable memory, ms by CUDA events.
"""
from __future__ import annotations

import argparse
import json
import os
import time


def _loader_rates(cfg, args, ring_pin):
    from basedet_tpu_torch.data.coco_loader import build_yolox_train_loader
    from basedet_tpu_torch.data.collators.pack import CanvasRing

    for workers in args.workers:
        cfg.DATA.NUM_WORKERS = workers
        loader = build_yolox_train_loader(cfg, args.batch_size, CanvasRing(pin=ring_pin))
        try:
            for _ in range(2):  # workers forked and warm, canvases allocated
                next(loader)
            t0 = time.perf_counter()
            n = sum(next(loader)["data"].shape[0] for _ in range(args.batches))
            dt = time.perf_counter() - t0
        finally:
            loader.close()
        yield {"bench": "loader", "workers": workers, "images_per_sec": n / dt,
               "ms_per_batch": 1000 * dt / args.batches, "host_cores": os.cpu_count()}


def _serial_split(cfg, args, ring_pin):
    """Per-sample pipeline, pack and pinning of one batch at a time, in this
    process, medians over ``args.batches`` batches."""
    import numpy as np

    from basedet_tpu_torch.data.coco_loader import build_yolox_train_loader
    from basedet_tpu_torch.data.collators.pack import CanvasRing, pin_batch

    cfg.DATA.NUM_WORKERS = 0
    loader = build_yolox_train_loader(cfg, args.batch_size, CanvasRing(pin=ring_pin))
    dataset, unpinned, ring = loader.dataset, CanvasRing(), CanvasRing(pin=ring_pin)
    loader.collator.ring = unpinned  # pack into ordinary memory, as a worker does, then pin apart
    batches = iter(loader.batch_sampler)
    times = []
    for _ in range(args.batches + 1):
        idx = next(batches)
        t0 = time.perf_counter()
        records = [dataset[i] for i in idx]
        t1 = time.perf_counter()
        batch = loader.collator(records)
        t2 = time.perf_counter()
        if ring_pin:
            pin_batch(batch, ring)
        times.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    samples, pack, pin = (float(np.median(col)) * 1000 for col in zip(*times[1:]))
    total = samples + pack + pin
    return {"bench": "split", "ms_samples": samples, "ms_pack": pack, "ms_pin": pin, "pack_share": pack / total,
            "batch": args.batch_size, "size": args.size}, batch


def _copy_times(batch, reps=20):
    import torch

    from basedet_tpu_torch.data.collators.pack import CanvasRing, pin_batch

    pinned = pin_batch(batch, CanvasRing(pin=True))["data"]
    pageable = pinned.clone()
    if not pinned.is_pinned() or pageable.is_pinned():
        raise RuntimeError("the copy bench needs one page-locked and one pageable batch")
    out = {}
    for name, src, nb in (("pinned", pinned, True), ("pageable", pageable, False)):
        for _ in range(3):
            src.to("cuda", non_blocking=nb)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            src.to("cuda", non_blocking=nb)
        end.record()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = start.elapsed_time(end) / reps
    return {"bench": "copy", "bytes": pinned.numel() * pinned.element_size(), **out,
            "pinned_gb_per_s": pinned.numel() * pinned.element_size() / out["pinned_ms"] / 1e6,
            "device": torch.cuda.get_device_name(0)}


def main(args=None):
    parser = argparse.ArgumentParser("basedet_tpu_torch pipeline bench")
    parser.add_argument("--images", type=int, default=200)
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--size", type=int, default=640)
    parser.add_argument("--workers", type=int, nargs="*", default=[0, 2, 4, 8])
    parser.add_argument("--out", type=str, default="logs/pipe_bench")
    parser.add_argument("--device", default="cuda", help="cuda: pin and time the copies; cpu: neither")
    args = parser.parse_args(args)

    import torch

    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass --device cpu explicitly")
    from basedet_tpu_torch.configs import YOLOXSConfig
    from basedet_tpu_torch.data import register_dataset
    from basedet_tpu_torch.tools.sanity_e2e import make_synthetic_coco

    (train_imgs, train_anno), _ = make_synthetic_coco(args.out, n_train=args.images, n_val=2, size=args.size)
    cfg = YOLOXSConfig()
    register_dataset("pipe_bench", train_imgs, train_anno)
    cfg.DATA.TRAIN.name = "pipe_bench"
    cfg.AUG.TRAIN_SETTING.INPUT_SIZE = (args.size, args.size)

    results = list(_loader_rates(cfg, args, cuda))
    split, batch = _serial_split(cfg, args, cuda)
    results.append(split)
    if cuda:
        results.append(_copy_times(batch))
    for rec in results:
        print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    main()
