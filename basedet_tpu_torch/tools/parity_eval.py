"""One-command zoo-weight parity eval of the port (counterpart of
``basedet_tpu/tools/parity_eval.py``): reference ``.pkl`` + COCO val → mAP
table next to the BASELINE.md targets.

The command is rehearsed end-to-end with ``--rehearse``: a synthetic
reference-LAYOUT RetinaNet-R50 checkpoint (``utils/reference_layout.py``,
exact MegEngine state-dict naming and shapes) and a synthetic 80-category
COCO val written as PNG (``data/image_ops.py``) run through the identical
convert → strict load → COCO eval → table path.

Real usage (when assets exist):
  python -m basedet_tpu_torch.tools.parity_eval --model retinanet \\
      -w retinanet_res50_coco_3x_800size_36dot2.pkl \\
      --images /data/coco/val2017 \\
      --anno /data/coco/annotations/instances_val2017.json [--device cuda]
  python -m basedet_tpu_torch.tools.parity_eval --rehearse [--rehearse-images 8] [--device cuda]

The device defaults to ``cuda`` and is never swapped for another.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile

import numpy as np

# model key → (config class name, zoo box mAP target, MODEL_ZOO.md line)
ZOO_TARGETS = {
    "retinanet": ("RetinaNetConfig", 36.2, "MODEL_ZOO.md:26"),
    "fcos": ("FCOSConfig", 39.0, "MODEL_ZOO.md:28"),
    "atss": ("ATSSConfig", 39.5, "MODEL_ZOO.md:29"),
    "ota": ("OTAConfig", 41.0, "MODEL_ZOO.md:30"),
    "free_anchor": ("FreeAnchorConfig", 38.4, "MODEL_ZOO.md:27"),
    "faster_rcnn": ("FasterRCNNConfig", 37.7, "MODEL_ZOO.md:25"),
    "detr": ("DETRConfig", 39.9, "MODEL_ZOO.md:31"),
}


def build_parity_cfg(model_key: str):
    """Production eval config for the zoo weights: bs=1, f32 (AMP off —
    parity claims are made in the reference's numerics)."""
    import basedet_tpu_torch.configs as C

    cls_name, _, _ = ZOO_TARGETS[model_key]
    cfg = getattr(C, cls_name)()
    cfg.MODEL.BATCHSIZE = 1
    cfg.TRAINER.AMP.ENABLE = False
    return cfg


def load_zoo_weights(model, weights_path: str):
    """Convert a reference-layout pickle (``utils/convert_weights.py``) and
    load it strictly: every parameter and buffer of the model must find its
    source. Returns the matcher's stats."""
    from basedet_tpu_torch.utils.checkpoint import load_matched_weights
    from basedet_tpu_torch.utils.convert_weights import convert_reference_detector_state

    with open(weights_path, "rb") as f:
        state = pickle.load(f)
    matched, stats = load_matched_weights(model.module.state_dict(), convert_reference_detector_state(state),
                                          strict=True)
    model.module.load_state_dict(matched, strict=True)
    return stats


def run_parity_eval(model_key: str, weights_path: str, images_dir: str, anno_path: str, limit: int = 0,
                    device="cuda", output_dir=None):
    """→ (COCO metrics, config, the loader's matched/missing/unused stats)."""
    from basedet_tpu_torch.data.build import build_test_dataloader
    from basedet_tpu_torch.data.datasets.info import register_dataset
    from basedet_tpu_torch.utils.logger import logger
    from basedet_tpu_torch.utils.registry import build_evaluator, build_model

    cfg = build_parity_cfg(model_key)
    if output_dir:
        cfg.GLOBAL.OUTPUT_DIR = output_dir
    model = build_model(cfg, device)
    logger.info(f"[parity] loading {weights_path} (strict convert+match)")
    stats = load_zoo_weights(model, weights_path)

    register_dataset("parity_val", images_dir, anno_path)
    cfg.DATA.TEST.name = "parity_val"
    loader = build_test_dataloader(cfg, device=model.device)
    if limit:
        loader = _LimitLoader(loader, limit)
    results = build_evaluator(cfg).evaluate_model(model, loader)
    return results, cfg, stats


class _LimitLoader:
    """First-N-images view of a test loader (smoke evals)."""

    def __init__(self, inner, limit: int):
        self.inner = inner
        self.limit = limit
        self.dataset = getattr(inner, "dataset", None)

    def __iter__(self):
        n = 0
        for batch in self.inner:
            if n >= self.limit:
                return
            n += len(batch["data"])
            yield batch


def print_table(model_key: str, results: dict, limit: int = 0):
    _, target, cite = ZOO_TARGETS[model_key]
    ap = results.get("AP", float("nan"))
    delta = ap - target
    flag = "PASS" if abs(delta) <= 0.1 else "FAIL"
    if limit:
        flag += f" (UNOFFICIAL: first {limit} images only)"
    print(f"{'model':<14}{'AP':>8}{'target':>8}{'delta':>8}  verdict")
    print(f"{model_key:<14}{ap:>8.3f}{target:>8.1f}{delta:>+8.3f}  {flag}"
          f"   [{cite}]")
    keys = ("AP", "AP50", "AP75", "APs", "APm", "APl")
    print("  " + "  ".join(f"{k}={results.get(k, float('nan')):.3f}"
                           for k in keys if k in results))
    print(json.dumps({
        "model": model_key, "AP": ap, "target": target,
        "delta": float(delta), "limit": limit, **{
            k: float(v) for k, v in results.items()
        },
    }))


# -- rehearsal (no assets needed) ---------------------------------------------


def _synthetic_coco80_val(root: str, n_images: int = 8, size: int = 320):
    """Tiny 80-category COCO val (rectangles over noise, first 3 categories
    used), the JAX package's draws, written as PNG, so the full
    loader/evaluator path runs without real assets."""
    from basedet_tpu_torch.data.image_ops import fill_rect, imwrite_png

    rng = np.random.RandomState(3)
    img_dir = os.path.join(root, "val_images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    aid = 0
    for i in range(n_images):
        img_id = i + 1
        img = rng.randint(60, 196, (size, size, 3), np.uint8)
        for _ in range(int(rng.randint(1, 4))):
            w = int(rng.randint(size // 8, size // 3))
            h = int(rng.randint(size // 8, size // 3))
            x = int(rng.randint(0, size - w))
            y = int(rng.randint(0, size - h))
            cls = int(rng.randint(0, 3))
            fill_rect(img, (x, y), (x + w, y + h), [(30, 30, 220), (30, 220, 30), (220, 30, 30)][cls])
            aid += 1
            annotations.append(dict(
                id=aid, image_id=img_id, category_id=cls + 1,
                bbox=[float(x), float(y), float(w), float(h)],
                area=float(w * h), iscrowd=0,
            ))
        name = f"{img_id:012d}.png"
        imwrite_png(os.path.join(img_dir, name), img)
        images.append(dict(id=img_id, file_name=name, height=size,
                           width=size))
    categories = [dict(id=c + 1, name=f"cat{c}") for c in range(80)]
    anno_path = os.path.join(root, "instances_val80.json")
    with open(anno_path, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=categories), f)
    return img_dir, anno_path


def rehearse(out_dir=None, n_images: int = 8, device="cuda"):
    """Dry-run the ENTIRE parity path on synthetic stand-ins: reference-
    layout ckpt → pickle → convert → strict load → COCO loader → evaluator
    → table. Numbers are meaningless (random-valued weights); the exercise
    proves parity day is a single command. Returns (metrics, the loader's
    stats); raises where a parameter or buffer found no source or a
    checkpoint key went unused."""
    from basedet_tpu_torch.utils.logger import logger
    from basedet_tpu_torch.utils.reference_layout import reference_retinanet_r50_state

    out_dir = out_dir or tempfile.mkdtemp(prefix="basedet_parity_rehearsal_")
    os.makedirs(out_dir, exist_ok=True)
    state = reference_retinanet_r50_state()
    rng = np.random.RandomState(0)
    state = {k: (rng.randn(*v.shape) * 0.02).astype(np.float32)
             for k, v in state.items()}
    # BN vars must be positive; give stable stats
    for k in list(state):
        if k.endswith(".running_var"):
            state[k] = np.ones_like(state[k])
        elif k.endswith(".running_mean"):
            state[k] = np.zeros_like(state[k])
    ckpt = os.path.join(out_dir, "zoo_stand_in.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump({"model": state}, f)

    imgs, anno = _synthetic_coco80_val(out_dir, n_images)
    logger.info(f"[rehearse] ckpt={ckpt} images={imgs} anno={anno}")
    results, _, stats = run_parity_eval("retinanet", ckpt, imgs, anno, device=device, output_dir=out_dir)
    if stats["missing"] or stats["unused"]:
        raise RuntimeError(f"[rehearse] the stand-in did not load one to one: {len(stats['missing'])} missing "
                           f"(e.g. {stats['missing'][:3]}), {len(stats['unused'])} unused (e.g. {stats['unused'][:3]})")
    print_table("retinanet", results)
    print(f"[rehearse] OK — {stats['matched']} tensors loaded, none missing or unused; parity day is: python -m "
          "basedet_tpu_torch.tools.parity_eval --model <m> -w <zoo.pkl> "
          "--images <val2017/> --anno <instances_val2017.json>")
    return results, stats


def main(args=None):
    parser = argparse.ArgumentParser("basedet_tpu_torch zoo parity eval")
    parser.add_argument("--model", choices=sorted(ZOO_TARGETS), default="retinanet")
    parser.add_argument("-w", "--weights", help="reference zoo .pkl")
    parser.add_argument("--images", help="COCO val images dir")
    parser.add_argument("--anno", help="COCO instances json")
    parser.add_argument("--limit", type=int, default=0,
                        help="eval only the first N images (smoke)")
    parser.add_argument("--rehearse", action="store_true",
                        help="dry-run the full path on synthetic stand-ins")
    parser.add_argument("--rehearse-images", type=int, default=8, help="images of the rehearsal's val set")
    parser.add_argument("--out-dir", default=None, help="the rehearsal's files (default: a new temporary directory)")
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    args = parser.parse_args(args)
    from basedet_tpu_torch.tools.misc import resolve_device

    device = resolve_device(args.device)
    if args.rehearse:
        return rehearse(args.out_dir, args.rehearse_images, device)
    if not (args.weights and args.images and args.anno):
        parser.error("--weights/--images/--anno required (or --rehearse)")
    results, _, _ = run_parity_eval(
        args.model, args.weights, args.images, args.anno, limit=args.limit, device=device
    )
    print_table(args.model, results, limit=args.limit)
    return results


if __name__ == "__main__":
    main()
