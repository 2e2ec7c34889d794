"""Activation parity harness of the port (counterpart of
``basedet_tpu/tools/parity_diff.py``, in its pickle format): dump per-stage
forward activations of a model to a pickle, and diff two such dumps
layer-by-layer with tolerance reporting.

A dump of the port diffs against a dump of the JAX package (or of the
MegEngine reference, ``playground/ref_dump_activations.py``) made on the
SAME input pixels and weights, localizing any numeric divergence to the
first offending stage (stem → res2..res5 → FPN p3..p7 → head outputs).
Stages are captured with forward hooks (``layers/common/module_inspector.py``)
under the port's module names, which carry flax's, so they canonicalise to
the JAX dump's stage names; the port's rank-4 activations are NCHW and are
written transposed to NHWC, the JAX package's layout.

Usage:
  dump:  python -m basedet_tpu_torch.tools.parity_diff dump -f <config.py>
             [-w weights] [--image img.npy] [--size 512] [--device cuda] -o ours.pkl
  diff:  python -m basedet_tpu_torch.tools.parity_diff diff ours.pkl ref.pkl
             [--rtol 1e-4] [--atol 1e-4] [--order stem,res2,...]

Dump format (both sides must follow it):
  {"activations": {name: np.ndarray}, "input": np.ndarray | None,
   "meta": {...}}
Rank-4 reference arrays may be NCHW; the differ auto-transposes whichever
side is NCHW to NHWC when shapes only agree under that permutation.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Dict, Optional

import numpy as np
import torch


# -- canonicalization ----------------------------------------------------------


def canonical_name(key: str) -> str:
    """Normalize a capture path to a comparable stage name: strip flax
    ``__call__`` suffixes and container indices glue, lowercase."""
    k = key.replace("/__call__", "")
    k = k.strip("/").lower()
    if k in ("__call__", ""):  # the top module's own output
        k = "output"
    # common aliases between the two frameworks' naming
    for pre in ("backbone/bottom_up/", "bottom_up/", "backbone/"):
        if k.startswith(pre):
            k = k[len(pre):]
            break
    return k


def _flatten_containers(acts: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Expand dict/list/tuple activation values into scalar-array entries:
    ``fpn -> [p3, p4, ...]`` becomes ``fpn.0, fpn.1, ...``; dict values keep
    their own keys (``bottom_up -> {res2: ...}`` becomes ``res2...``)."""
    flat: Dict[str, np.ndarray] = {}

    def add(name, val):
        if isinstance(val, dict):
            for k, v in val.items():
                add(str(k), v)  # dict keys (res2..) ARE the stage names
        elif isinstance(val, (list, tuple)):
            for i, v in enumerate(val):
                add(f"{name}.{i}", v)
        else:
            if isinstance(val, torch.Tensor):
                val = val.detach().float().cpu().numpy() if val.is_floating_point() else val.cpu().numpy()
            arr = np.asarray(val)
            if str(arr.dtype) == "bfloat16" or arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            flat[name] = arr

    for k, v in acts.items():
        add(canonical_name(k), v)
    return flat


def _to_nhwc(a: np.ndarray, b: np.ndarray):
    """If rank-4 shapes only agree under NCHW→NHWC on one side, transpose
    that side (reference dumps are NCHW; ours NHWC)."""
    if a.ndim == b.ndim == 4 and a.shape != b.shape:
        if a.shape == (b.shape[0], b.shape[3], b.shape[1], b.shape[2]):
            return a.transpose(0, 2, 3, 1), b
        if b.shape == (a.shape[0], a.shape[3], a.shape[1], a.shape[2]):
            return a, b.transpose(0, 2, 3, 1)
    return a, b


# -- dump ----------------------------------------------------------------------


def _nhwc(value):
    """Rank-4 tensors (the port's NCHW feature maps) to NHWC, through
    containers."""
    if isinstance(value, dict):
        return {k: _nhwc(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_nhwc(v) for v in value]
    if isinstance(value, torch.Tensor) and value.dim() == 4:
        return value.permute(0, 2, 3, 1)
    return value


def dump_activations(model, image: np.ndarray,
                     capture=("bottom_up", "fpn", "head", "backbone")):
    """Forward ``image`` (B, H, W, 3 raw pixels) through the model's module
    in eval mode capturing the named top-level seams; returns {stage:
    np.ndarray}, rank-4 stages in NHWC. The module gets the image and, where
    its forward takes them, the ``img_info`` or pixel ``mask`` of the
    model's own input preparation."""
    import inspect

    from basedet_tpu_torch.layers.common.function import full_f32
    from basedet_tpu_torch.layers.common.module_inspector import feature_extract

    B, H, W = image.shape[:3]
    batch = {"data": image, "im_info": np.tile(np.float32([H, W, H, W, 0]), (B, 1))}
    prepare = getattr(model, "prepare", model.pre_process)
    inputs = prepare(batch)
    args = [inputs[name] for name in inspect.signature(model.module.forward).parameters if name in inputs]

    def filter_fn(path, _mdl):
        depth = len(path.split("/")) if path else 0
        return depth <= 1 or any(c in path for c in capture)

    model.eval()
    with torch.no_grad(), full_f32():  # IEEE f32 on a card too (TF32 off): the diff bounds numeric drift
        _, captured = feature_extract(model.module, *args, filter_fn=filter_fn)
    return _flatten_containers({k: _nhwc(v) for k, v in captured.items()})


def _cmd_dump(args):
    from basedet_tpu_torch.configs import RetinaNetConfig
    from basedet_tpu_torch.tools.misc import import_config, resolve_device
    from basedet_tpu_torch.utils.registry import build_model

    device = resolve_device(args.device)
    cfg = import_config(args.config) if args.config else RetinaNetConfig()
    if args.opts:
        cfg.merge(args.opts)
    model = build_model(cfg, device)

    if args.image:
        image = np.load(args.image)
        if image.ndim == 3:
            image = image[None]
    else:
        rng = np.random.RandomState(0)
        image = rng.randint(
            0, 256, (1, args.size, args.size, 3)
        ).astype(np.float32)

    if args.weights:
        model.load_weights(args.weights)
    acts = dump_activations(model, image)
    payload = {
        "activations": acts,
        "input": image,
        "meta": {
            "config": args.config,
            "weights": args.weights,
            "backend": "torch",
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
            "matmul_precision": "float32",
        },
    }
    with open(args.out, "wb") as f:
        pickle.dump(payload, f)
    print(f"dumped {len(acts)} stages to {args.out}:")
    for k, v in acts.items():
        print(f"  {k}: {tuple(v.shape)} {v.dtype}")
    return 0


# -- diff ----------------------------------------------------------------------


def diff_dumps(ours: Dict, ref: Dict, rtol=1e-4, atol=1e-4,
               order: Optional[list] = None):
    """Compare two {stage: array} dicts. Returns (report_rows, ok)."""
    a_all = _flatten_containers(ours)
    b_all = _flatten_containers(ref)
    common = sorted(set(a_all) & set(b_all))
    if order:
        rank = {n: i for i, n in enumerate(order)}
        common.sort(key=lambda k: (rank.get(k, len(rank)), k))
    rows, ok = [], True
    for k in common:
        a, b = _to_nhwc(a_all[k], b_all[k])
        if a.shape != b.shape:
            rows.append(dict(stage=k, status="SHAPE-MISMATCH",
                             ours=tuple(a.shape), ref=tuple(b.shape)))
            ok = False
            continue
        a64 = a.astype(np.float64)
        b64 = b.astype(np.float64)
        max_abs = float(np.max(np.abs(a64 - b64))) if a.size else 0.0
        denom = np.abs(b64) + 1e-12
        max_rel = float(np.max(np.abs(a64 - b64) / denom)) if a.size else 0.0
        # scale-aware drift: max_abs relative to the stage's own spread.
        # max_rel explodes near zero crossings; this is the per-stage
        # tolerance number parity day should budget against.
        std = float(np.std(b64)) if a.size else 0.0
        abs_over_std = max_abs / (std + 1e-12)
        close = bool(np.allclose(a64, b64, rtol=rtol, atol=atol))
        rows.append(dict(stage=k, status="OK" if close else "DIVERGED",
                         max_abs=max_abs, max_rel=max_rel,
                         abs_over_std=abs_over_std, shape=tuple(a.shape)))
        ok = ok and close
    for k in sorted(set(a_all) - set(b_all)):
        rows.append(dict(stage=k, status="OURS-ONLY"))
    for k in sorted(set(b_all) - set(a_all)):
        rows.append(dict(stage=k, status="REF-ONLY"))
    return rows, ok


def _cmd_diff(args):
    with open(args.ours, "rb") as f:
        ours = pickle.load(f)
    with open(args.ref, "rb") as f:
        ref = pickle.load(f)
    meta_a = ours.get("meta", {}) if isinstance(ours, dict) else {}
    meta_b = ref.get("meta", {}) if isinstance(ref, dict) else {}
    if meta_a.get("device") or meta_b.get("device"):
        print(f"ours: backend={meta_a.get('backend')} "
              f"device={meta_a.get('device')}")
        print(f"ref:  backend={meta_b.get('backend')} "
              f"device={meta_b.get('device')}")
        if meta_a.get("device") and meta_a.get("device") == meta_b.get("device"):
            print("WARNING: both dumps were produced on the SAME device — "
                  "a cross-backend diff needs one dump per backend "
                  "(dump with --device cpu for the host side)")
    if ours.get("input") is not None and ref.get("input") is not None:
        if not np.array_equal(np.asarray(ours["input"]),
                              np.asarray(ref["input"])):
            print("WARNING: the two dumps were made on DIFFERENT input "
                  "pixels — stage diffs are not meaningful")
    order = args.order.split(",") if args.order else None
    rows, ok = diff_dumps(
        ours.get("activations", ours), ref.get("activations", ref),
        rtol=args.rtol, atol=args.atol, order=order,
    )
    first_bad = None
    for r in rows:
        if r["status"] == "OK":
            print(f"  OK        {r['stage']:40s} max_abs={r['max_abs']:.3e} "
                  f"abs/std={r['abs_over_std']:.3e} "
                  f"max_rel={r['max_rel']:.3e} {r['shape']}")
        elif r["status"] == "DIVERGED":
            first_bad = first_bad or r["stage"]
            print(f"  DIVERGED  {r['stage']:40s} max_abs={r['max_abs']:.3e} "
                  f"abs/std={r['abs_over_std']:.3e} "
                  f"max_rel={r['max_rel']:.3e} {r['shape']}")
        else:
            print(f"  {r['status']:9s} {r['stage']}")
    n_cmp = sum(r["status"] in ("OK", "DIVERGED") for r in rows)
    print(f"{'PARITY OK' if ok else 'PARITY FAILED'}: "
          f"{n_cmp} stages compared"
          + (f"; first divergent stage: {first_bad}" if first_bad else ""))
    return 0 if ok else 1


def main(argv=None):
    p = argparse.ArgumentParser("basedet_tpu_torch activation parity harness")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("-f", "--config", default=None)
    d.add_argument("-w", "--weights", default=None)
    d.add_argument("--image", default=None, help=".npy (H,W,3) raw pixels")
    d.add_argument("--size", type=int, default=512)
    d.add_argument("-o", "--out", required=True)
    d.add_argument("--device", default="cuda", help="torch device to run on")
    d.add_argument("opts", nargs="*", default=[])
    c = sub.add_parser("diff")
    c.add_argument("ours")
    c.add_argument("ref")
    c.add_argument("--rtol", type=float, default=1e-4)
    c.add_argument("--atol", type=float, default=1e-4)
    c.add_argument("--order", default=None,
                   help="comma list fixing report order, e.g. stem,res2,...")
    args = p.parse_args(argv)
    if args.cmd == "dump":
        return _cmd_dump(args)
    return _cmd_diff(args)


if __name__ == "__main__":
    raise SystemExit(main())
