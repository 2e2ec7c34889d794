"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to the cell's limit (``limits/<cell>.json``)."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Set, Tuple

import torch

# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under the solver: they are left out of the change
NEGLIGIBLE_GRAD = 1e-3
# a detection counts as matched only by one of its class at this IoU or more
MATCH_IOU = 0.9


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: Optional[Set[str]] = None) -> List[float]:
    """Per leaf (or image) |‖prog‖ - ‖ref‖| over the larger of its
    reference norm and the median leaf's (one the program lacks reads nan)."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return [math.nan]
    med = statistics.median(ref[n] for n in names)
    return [abs(prog.get(n, math.nan) - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def worst(gaps: List[float]) -> float:
    return math.nan if any(math.isnan(g) for g in gaps) else max(gaps)


def median(gaps: List[float]) -> float:
    return math.nan if any(math.isnan(g) for g in gaps) else statistics.median(gaps)


def moving_leaves(ref_grad: Dict[str, float]) -> Set[str]:
    med = statistics.median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= NEGLIGIBLE_GRAD * med}


def output_gap(prog: List[torch.Tensor], ref: List[torch.Tensor]) -> float:
    """The worst output tensor's ‖prog - ref‖ / ‖ref‖; 1 (nothing right)
    where the program's outputs are missing or of another shape."""
    if len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return 1.0
    gaps = [torch.linalg.vector_norm(p.to(r.device, torch.float32) - r) / torch.linalg.vector_norm(r).clamp(min=1e-30)
            for p, r in zip(prog, ref)]
    return float(torch.stack(gaps).max())


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (the total loss of each of
    the first three steps), ``grad`` (per leaf the norm of the first
    gradient as the optimizer got it), ``update`` (per leaf the norm of the
    parameters' change after three steps), with an EMA ``ema_move`` (per
    leaf the norm of the EMA's change after three steps) and, where the
    configuration names modules of the network, ``outputs`` (by module,
    what it put out in the first step: ``output_gap.<module>``) and
    ``image_grad`` (per image the norm of the first step's loss gradient at
    the outputs of the modules the losses read: ``image_grad_gap``). Each
    per-leaf number is read at the worst leaf and at the median leaf; the
    change and the EMA's only over the leaves that the reference's gradient
    moves; the per-image one at the worst image and the median image."""
    out = {"loss_gap": max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))}
    moving = moving_leaves(ref["grad"])
    for key, keep in (("grad", None), ("update", moving), ("ema_move", moving)):
        if key in ref:
            gaps = _leaf_gaps(prog.get(key, {}), ref[key], keep)
            out[f"{key}_gap"], out[f"{key}_gap_med"] = worst(gaps), median(gaps)
    if ref.get("image_grad"):
        images = {str(i): v for i, v in enumerate(ref["image_grad"])}
        gaps = _leaf_gaps({str(i): v for i, v in enumerate(prog.get("image_grad") or [])}, images)
        out["image_grad_gap"], out["image_grad_gap_med"] = worst(gaps), median(gaps)
    for module, tensors in ref.get("outputs", {}).items():
        out[f"output_gap.{module}"] = output_gap(prog.get("outputs", {}).get(module, []), tensors)
    return out


def _area(x: torch.Tensor) -> torch.Tensor:
    return (x[:, 2] - x[:, 0]).clamp(min=0) * (x[:, 3] - x[:, 1]).clamp(min=0)


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(a)[:, None] + _area(b)[None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)


def infer_readings(prog: List[Dict[str, torch.Tensor]], ref: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Over every image of the sampled batches (padded detections on the
    host): ``score_gap``, the widest gap between the two sorted score lists
    slot by slot (empty slots 0); ``unmatched``, the share of the two sides'
    detections with no detection of the same class on the other side at
    IoU ``MATCH_IOU`` or more; ``box_gap``, the largest 1 - IoU between a
    detection and its best match of the same class on the other side, over
    those whose best match reaches IoU 0.5; ``score_gap_med``, the median
    over images of each image's score gap."""
    score_gaps, box_gap, unmatched, total = [], 0.0, 0, 0
    for p, r in zip(prog, ref):
        for i in range(p["valid"].shape[0]):
            ps = torch.where(p["valid"][i], p["box_scores"][i].float(), 0.0).sort(descending=True).values
            rs = torch.where(r["valid"][i], r["box_scores"][i].float(), 0.0).sort(descending=True).values
            score_gaps.append(float((ps - rs).abs().max()))
            pv, rv = p["valid"][i], r["valid"][i]
            pb, rb = p["boxes"][i][pv].float(), r["boxes"][i][rv].float()
            pl, rl = p["box_labels"][i][pv], r["box_labels"][i][rv]
            if len(pb) and len(rb):
                # a box that clipping left with no area matches one within 0.01 px of it
                flat = (_area(pb)[:, None] <= 0) | (_area(rb)[None, :] <= 0)
                near = (pb[:, None] - rb[None, :]).abs().amax(-1) <= 0.01
                iou = torch.where(flat, near.float(), _iou(pb, rb))
                iou = torch.where(pl[:, None] == rl[None, :], iou, 0.0)
                same = iou >= MATCH_IOU
                unmatched += int((~same.any(1)).sum()) + int((~same.any(0)).sum())
                best = torch.cat([iou.amax(1), iou.amax(0)])
                if bool((best >= 0.5).any()):
                    box_gap = max(box_gap, float(1.0 - best[best >= 0.5].min()))
            else:
                unmatched += len(pb) + len(rb)
            total += len(pb) + len(rb)
    return {"score_gap": max(score_gaps), "score_gap_med": statistics.median(score_gaps), "box_gap": box_gap,
            "unmatched": unmatched / max(total, 1)}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Dict]]:
    """(correct, [{name, value, limit}]) over the numbers that the cell's
    limits name: each must have been read, be finite and be at most its
    limit. A reading with no limit is not compared; a cell with no limits
    is never correct."""
    numbers = [{"name": k, "value": readings.get(k, math.nan), "limit": v} for k, v in limits.items()]
    ok = bool(numbers) and all(math.isfinite(n["value"]) and n["value"] <= n["limit"] for n in numbers)
    return ok, numbers
