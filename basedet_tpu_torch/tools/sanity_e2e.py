"""End-to-end sanity run of the port (counterpart of
``basedet_tpu/tools/sanity_e2e.py``): write a learnable synthetic COCO set to
disk, train a small detector on it through ``DetTrainer`` and its hooks, and
evaluate box mAP on its val split through ``EvalHook``:

    python -m basedet_tpu_torch.tools.sanity_e2e --model yolox --steps 3000 [--out DIR] [--device cuda]
    python -m basedet_tpu_torch.tools.sanity_e2e --model detr --train-images 8 --eval-on-train --steps 2000

``--model`` takes retinanet, faster_rcnn, yolox, detr or all. The recipes are
the JAX package's, key for key: YOLOX-Nano at 320 with mosaic and mixup and
a no-aug tail of a third of the steps; ResNet-18 with trainable BN for the
R-CNN family and DETR, whose recipe is 2 + 2 layers, 16 queries, dropout 0
(``--detr-dropout``), BASIC_LR 5e-5, the gradient clipped at norm 1.0, the
backbone at the full LR and the LR decay at two thirds of the run.
``--eval-on-train`` evaluates on the train images (the overfit protocol).
Prints one JSON line per model.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np

from basedet_tpu_torch.data.image_ops import fill_rect, imwrite_png


def make_synthetic_coco(root: str, n_train=200, n_val=40, size=320, seed=0):
    """Solid rectangles on noise, class = rectangle colour (3 classes): the
    JAX package's set, the same draws from ``RandomState(seed)``, written as
    uncompressed PNG. Returns ((train images, train json), (val images, val json))."""
    rng = np.random.RandomState(seed)
    colors = [(40, 40, 230), (40, 230, 40), (230, 40, 40)]  # BGR per class

    def gen_split(split, n, id_base):
        img_dir = os.path.join(root, split)
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        aid = id_base * 100000
        for i in range(n):
            img_id = id_base * 100000 + i + 1
            img = rng.randint(80, 176, (size, size, 3), np.uint8)
            for _ in range(rng.randint(1, 4)):
                w = int(rng.randint(size // 8, size // 3))
                h = int(rng.randint(size // 8, size // 3))
                x = int(rng.randint(0, size - w))
                y = int(rng.randint(0, size - h))
                cls = int(rng.randint(0, 3))
                fill_rect(img, (x, y), (x + w, y + h), colors[cls])
                aid += 1
                annotations.append(dict(id=aid, image_id=img_id, category_id=cls + 1,
                                        bbox=[float(x), float(y), float(w), float(h)], area=float(w * h),
                                        iscrowd=0))
            name = f"{img_id:012d}.png"
            imwrite_png(os.path.join(img_dir, name), img, level=0)  # noise barely compresses; reads stay a copy
            images.append(dict(id=img_id, file_name=name, height=size, width=size))
        anno = dict(images=images, annotations=annotations,
                    categories=[dict(id=c + 1, name=f"class{c}") for c in range(3)])
        anno_path = os.path.join(root, f"instances_{split}.json")
        with open(anno_path, "w") as f:
            json.dump(anno, f)
        return img_dir, anno_path

    return gen_split("train", n_train, 1), gen_split("val", n_val, 2)


def _make_cfg(model: str, args):
    """The JAX package's small from-scratch recipe per model family; then
    what the port's trainer needs to run it the way the JAX package's own
    loop does."""
    from basedet_tpu_torch import configs as C

    if model == "retinanet":
        cfg = C.RetinaNetConfig()
    elif model == "faster_rcnn":
        cfg = C.FasterRCNNConfig()
        cfg.MODEL.RPN.TRAIN_PREV_NMS_TOPK = 1000
        cfg.MODEL.RPN.TRAIN_POST_NMS_TOPK = 500
        cfg.MODEL.RCNN.NUM_ROIS = 128
    elif model == "detr":
        cfg = C.DETRConfig()
        t = cfg.MODEL.TRANSFORMER
        t.NUM_ENCODERS = t.NUM_DECODERS = 2
        cfg.MODEL.NUM_QUERIES = 16
        t.DROPOUT = args.detr_dropout if args.detr_dropout is not None else 0.0
        cfg.SOLVER.BASIC_LR = 5e-5
        cfg.TRAINER.GRAD_CLIP = dict(ENABLE=True, TYPE="norm", ARGS=dict(max_norm=1.0))
        cfg.SOLVER.BACKBONE_LR_RATIO = 1.0  # from scratch: the backbone trains at the full LR
    elif model == "yolox":
        cfg = C.YOLOXNanoConfig()
        s = cfg.AUG.TRAIN_SETTING
        s.INPUT_SIZE = (args.size, args.size)
        s.MULTISCALE_RANGE = (args.size // 32, args.size // 32)  # one size
        cfg.TEST.CLS_THRESHOLD = 0.05
        cfg.SOLVER.WARM_EPOCH = None
        cfg.SOLVER.BASIC_LR = 0.02 / 64
        cfg.SOLVER.EXTRA_LR_ARGS = dict(NO_AUG_EPOCH=1, MIN_LR_RATIO=0.05)
        if args.no_aug:
            s.MOSAIC_PROB = 0.0
            s.ENABLE_MIXUP = False
    else:
        raise ValueError(f"--model {model}: unknown")
    if model != "yolox":
        cfg.MODEL.BACKBONE.NAME = "resnet18"
        # from scratch: trainable BN (FrozenBN at its init statistics is the identity)
        cfg.MODEL.BACKBONE.NORM = "BN"
        cfg.MODEL.BACKBONE.FREEZE_AT = 0
    if model in ("retinanet", "faster_rcnn"):
        cfg.SOLVER.BASIC_LR = 0.01 / 16
        cfg.TRAINER.GRAD_CLIP = dict(ENABLE=True, TYPE="norm", ARGS=dict(max_norm=10.0))
    cfg.MODEL.BATCHSIZE = args.batch
    cfg.DATA.NUM_CLASSES = 3
    cfg.DATA.MAX_INSTANCES = 8
    cfg.SOLVER.WARM_ITERS = 100
    cfg.SOLVER.NUM_IMAGE_PER_EPOCH = 200
    cfg.SOLVER.MAX_EPOCH = max(1, args.steps * args.batch // 200)
    if model == "detr":  # the 150-epoch schedule's decay at epoch 100, scaled to the run
        cfg.SOLVER.LR_DECAY_STAGES = [max(1, int(cfg.SOLVER.MAX_EPOCH * 2 / 3))]
    cfg.TEST.CLS_THRESHOLD = 0.05
    cfg.GLOBAL.OUTPUT_DIR = args.out

    # what the JAX package's own loop does, said to the port's trainer: the
    # R-CNN family trains on the images as they are (no transform) and every
    # model evaluates at the images' own size (the test resize to
    # IMG_MIN_SIZE = IMG_MAX_SIZE = size is the identity); YOLOX's no-aug
    # tail is the last steps // 3 steps (none with --no-aug)
    cfg.AUG.TRAIN_VALUE = ()
    cfg.TEST.IMG_MIN_SIZE = cfg.TEST.IMG_MAX_SIZE = args.size
    if model == "yolox":
        per_epoch = 200 // args.batch
        tail = 0 if args.no_aug else (args.no_aug_tail if args.no_aug_tail is not None else args.steps // 3)
        cfg.AUG.TRAIN_SETTING.NO_AUG_EPOCH = math.ceil(tail / per_epoch)
    cfg.DATA.NUM_WORKERS = args.workers
    cfg.GLOBAL.CKPT_SAVE_DIR = os.path.join(args.out, model, "ckpt")
    cfg.GLOBAL.LOG_INTERVAL = 50
    return cfg


def _run_one(model_name: str, args, train, val):
    from basedet_tpu_torch import build_trainer
    from basedet_tpu_torch.data import register_dataset

    cfg = _make_cfg(model_name, args)
    register_dataset("e2e_synth_train", *train)
    register_dataset("e2e_synth_val", *val)
    cfg.DATA.TRAIN.name = "e2e_synth_train"
    cfg.DATA.TEST.name = "e2e_synth_val"
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, args.device)
    trainer.init_state()
    trainer.train()
    results = trainer.eval_results["EMA" if trainer.ema_enabled else "model"]
    out = {"model": model_name, "e2e_synthetic_AP": results.get("AP"), "AP50": results.get("AP50"),
           "weights": "EMA" if trainer.ema_enabled else "live", "steps": trainer.state.step,
           "wall_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out), flush=True)
    return out


def main(args=None):
    parser = argparse.ArgumentParser("basedet_tpu_torch e2e sanity")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--out", type=str, default="logs/sanity_e2e")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--size", type=int, default=320)
    parser.add_argument("--model", type=str, default="retinanet", help="retinanet | faster_rcnn | yolox | detr | all")
    parser.add_argument("--detr-dropout", type=float, default=None,
                        help="DETR: the transformer's dropout (the recipe's default 0)")
    parser.add_argument("--eval-on-train", action="store_true", help="evaluate on the train images (overfit protocol)")
    parser.add_argument("--no-aug", action="store_true", help="YOLOX: mosaic and mixup off throughout")
    parser.add_argument("--no-aug-tail", type=int, default=None,
                        help="YOLOX with mosaic: final steps with mosaic and mixup off and L1 on "
                             "(default steps // 3), rounded up to whole epochs")
    parser.add_argument("--train-images", type=int, default=200)
    parser.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1))
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    args = parser.parse_args(args)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass --device cpu explicitly")
    from basedet_tpu_torch.utils.logger import setup_logger

    setup_logger(args.out)
    train, val = make_synthetic_coco(args.out, n_train=args.train_images, size=args.size)
    if args.eval_on_train:
        val = train
    models = ("retinanet", "faster_rcnn", "detr", "yolox") if args.model == "all" else (args.model,)
    return [_run_one(m, args, train, val) for m in models]


if __name__ == "__main__":
    main()
