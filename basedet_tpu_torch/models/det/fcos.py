"""FCOS in PyTorch (counterpart of ``basedet_tpu/models/det/fcos.py``).

ResNet (FrozenBN, ``FREEZE_AT`` 2) → FPN P3-P5 with the ``p6p7`` top block
on ``res5`` → the point head shared over P3-P7 → per level logits, decoded
ltrb offsets and centerness, flattened in the point generator's order
(row-major per level, levels in order).

Training, the batch at once where the JAX package vmaps over images: each
point against each padded gt, (B, K, R). A point is a gt's candidate where
its largest ltrb distance lies in its level's size of interest (``inf``
becomes 1e8) and it lies in the gt's centre region (``CENTER_SAMPLING_RADIUS``
strides around the box centre, cut to the box; radius 0: in the box); it
takes the candidate gt of least area, the lowest gt index among equal areas
(a point of no gt has all areas ``inf`` and goes to gt 0, background). The
losses: focal over every point, GIoU on the ltrb offsets weighted by the
target centerness, BCE of the centerness, over the foreground count.
Targets are computed without gradient.

Inference, per image and level: the top 1000 of sqrt(sigmoid(class) ·
sigmoid(centerness)) over (point, class) by a stable sort (ties to the lower
index, as ``lax.top_k``), scores at or below ``TEST.CLS_THRESHOLD`` masked to
``NEG_INF``, decoded; all levels' candidates (5000 at 800x1344) go through
class-aware NMS (the NMS kernel) and are rescaled to the original image.

Nothing is sampled (``draws_per_step`` False). Under the bf16 policy
(``--amp``) the backbone, FPN and head convolutions run in bf16; GroupNorm
and the learnt scales give f32, and ``_flatten_level`` casts the rest to f32,
so the assignment and the losses run in f32.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from basedet_tpu_torch.layers.common.anchor_generator import AnchorPointGenerator
from basedet_tpu_torch.layers.common.function import first_argmax, topk_scores
from basedet_tpu_torch.layers.common.post_processing import post_processing
from basedet_tpu_torch.layers.head.point_head import PointHead
from basedet_tpu_torch.layers.losses import binary_cross_entropy, iou_loss, sigmoid_focal_loss
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.models.det.retinanet import RetinaNetModule, _flatten_level
from basedet_tpu_torch.ops.nms import NEG_INF, gather_rows
from basedet_tpu_torch.parallel import global_normaliser
from basedet_tpu_torch.structures import PointCoder
from basedet_tpu_torch.utils.registry import registers


class FCOSModule(RetinaNetModule):
    """``bottom_up`` → ``fpn`` → ``head`` (a :class:`PointHead`), the flax
    names; ``forward`` gives the head's per-level NCHW (logits, offsets,
    centerness) in IEEE f32."""

    def __init__(self, cfg, decode_mode: str = "relu_scale", device=None):
        self.decode_mode = decode_mode
        super().__init__(cfg, cfg.MODEL.ANCHOR.NUM_ANCHORS, device)

    def make_head(self, cfg, num_anchors: int, device) -> nn.Module:
        m = cfg.MODEL
        return PointHead(m.FPN.OUT_CHANNELS, cfg.DATA.NUM_CLASSES, tuple(m.FPN.STRIDES), num_anchors,
                         m.HEAD.NUM_CONVS, m.HEAD.CLS_PRIOR_PROB, m.HEAD.get("WITH_NORM", True),
                         m.HEAD.get("SHARE_PARAM", True), self.decode_mode, device=device)


def centerness(offsets: torch.Tensor) -> torch.Tensor:
    """(..., 4) ltrb → (...): sqrt of min/max of (l, r) times min/max of (t, b),
    each ratio at least 0."""
    lr, tb = offsets[..., [0, 2]], offsets[..., [1, 3]]
    return torch.sqrt((lr.amin(-1) / lr.amax(-1).clamp(min=1e-12)).clamp(min=0)
                      * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-12)).clamp(min=0))


def in_centre_region(points: torch.Tensor, radii: torch.Tensor, gt_xyxy: torch.Tensor) -> torch.Tensor:
    """points (R, 2), radii (R,) in pixels, gt (B, K, 4) → (B, K, R): the point
    lies strictly inside the square of that radius around the gt's centre,
    cut to the gt."""
    centers = (gt_xyxy[..., :2] + gt_xyxy[..., 2:4]) * 0.5
    r = radii[None, None, :, None]
    lo = torch.maximum(centers[:, :, None, :] - r, gt_xyxy[:, :, None, :2])
    hi = torch.minimum(centers[:, :, None, :] + r, gt_xyxy[:, :, None, 2:4])
    return torch.cat([points - lo, hi - points], dim=-1).amin(-1) > 0


@registers.models.register()
class FCOS(BaseNet):
    def __init__(self, cfg, device, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device)
        m = cfg.MODEL
        self.strides = tuple(m.FPN.STRIDES)
        self.point_gen = AnchorPointGenerator(self.strides, m.ANCHOR.OFFSET)
        self.box_coder = PointCoder()
        self._points: Dict[tuple, List[torch.Tensor]] = {}
        module = FCOSModule(cfg, self.head_decode_mode(cfg), device="meta")
        self.module = module.to_empty(device=self.device).eval()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.module.init_weights(generator)

    @staticmethod
    def head_decode_mode(cfg) -> str:
        return "relu_scale"

    def points(self, head_out: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per level (H·W, 2) points for the sizes of these (N, ·, H, W) head
        outputs, made once per size and device."""
        key = (tuple(tuple(x.shape[-2:]) for x in head_out), head_out[0].device)
        if key not in self._points:
            self._points[key] = self.point_gen(list(key[0]), key[1])
        return self._points[key]

    def level_strides(self, points_l: List[torch.Tensor]) -> torch.Tensor:
        """(R,) f32: each point's level stride."""
        return torch.cat([torch.full((p.shape[0],), float(s), device=p.device)
                          for p, s in zip(points_l, self.strides)])

    def flatten(self, logits_l, offsets_l, ctr_l):
        """Per level NCHW head outputs → per level (B, R_l, C) logits, (B, R_l, 4)
        offsets and (B, R_l) centerness."""
        return ([_flatten_level(x, self.num_classes) for x in logits_l],
                [_flatten_level(x, 4) for x in offsets_l],
                [_flatten_level(x, 1)[..., 0] for x in ctr_l])

    @torch.no_grad()
    def ground_truth(self, points_l: List[torch.Tensor], gt_boxes: torch.Tensor,
                     num_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """gt_boxes (B, K, 5) padded, num_valid (B,) → labels (B, R) int64 (0
        background, else the 1-based class), ltrb targets (B, R, 4) of the
        matched gt and their centerness (B, R)."""
        points = torch.cat(points_l)
        soi = []
        for p, (lo, hi) in zip(points_l, self.cfg.MODEL.HEAD.OBJECT_SIZES_OF_INTEREST):
            hi = 1e8 if hi == float("inf") else hi
            soi.append(torch.tensor([lo, hi], dtype=torch.float32, device=p.device).expand(p.shape[0], 2))
        soi = torch.cat(soi)
        K = gt_boxes.shape[1]
        gt_valid = torch.arange(K, device=gt_boxes.device)[None, :] < num_valid[:, None]
        gt_xyxy = gt_boxes[..., :4]
        offsets = self.box_coder.encode(points[None, None], gt_xyxy[:, :, None])  # (B, K, R, 4)
        max_off = offsets.amax(-1)
        cared = (max_off >= soi[:, 0]) & (max_off <= soi[:, 1])
        radius = self.cfg.MODEL.HEAD.CENTER_SAMPLING_RADIUS
        if radius > 0:
            in_boxes = in_centre_region(points, self.level_strides(points_l) * radius, gt_xyxy)
        else:
            in_boxes = offsets.amin(-1) > 0
        areas = (gt_xyxy[..., 2] - gt_xyxy[..., 0]) * (gt_xyxy[..., 3] - gt_xyxy[..., 1])
        areas = torch.where(cared & in_boxes & gt_valid[:, :, None], areas[:, :, None], torch.inf)
        match = first_argmax(-areas, dim=1)
        matched = gather_rows(gt_boxes, match)
        labels = torch.where(torch.isinf(areas.amin(1)), 0, matched[..., 4].to(torch.int64))
        gt_offsets = self.box_coder.encode(points[None], matched[..., :4])
        return labels, gt_offsets, centerness(gt_offsets)

    def losses(self, logits: torch.Tensor, offsets: torch.Tensor, ctrness: torch.Tensor, labels: torch.Tensor,
               gt_offsets: torch.Tensor, gt_ctr: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, R, ·) head outputs of every level and their targets → focal,
        centerness-weighted IoU and centerness losses."""
        fg = labels > 0
        num_fg = global_normaliser(fg.sum(), 1.0)
        weight = torch.where(fg, gt_ctr, 0.0)
        lcfg = self.cfg.MODEL.LOSSES
        cls_loss = (sigmoid_focal_loss(logits, self.one_hot(labels, logits.dtype), alpha=lcfg.FOCAL_LOSS_ALPHA,
                                       gamma=lcfg.FOCAL_LOSS_GAMMA)).sum() / num_fg
        reg_loss = ((iou_loss(offsets, gt_offsets, box_mode="ltrb", loss_type=lcfg.IOU_LOSS_TYPE) * weight).sum()
                    / global_normaliser(weight.sum(), 1e-6) * lcfg.REG_LOSS_WEIGHT)
        ctr_loss = (binary_cross_entropy(ctrness, gt_ctr, with_logits=True) * fg).sum() / num_fg
        total = cls_loss + reg_loss + ctr_loss
        return {"total_loss": total, "cls_loss": cls_loss, "reg_loss": reg_loss, "ctr_loss": ctr_loss}

    def one_hot(self, labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, R) labels (0 background) → (B, R, C) one-hot of the foreground."""
        classes = torch.arange(1, self.num_classes + 1, device=labels.device)
        return ((labels[..., None] == classes) & (labels > 0)[..., None]).to(dtype)

    def get_losses(self, batch):
        """→ (total, {total_loss, cls_loss, reg_loss, ctr_loss}), differentiable
        in the trainable parameters."""
        inputs = self.pre_process(batch, train=True)
        head_out = self.module(inputs["image"])
        points_l = self.points(head_out[0])
        logits, offsets, ctrness = (torch.cat(x, dim=1) for x in self.flatten(*head_out))
        labels, gt_offsets, gt_ctr = self.ground_truth(points_l, inputs["gt_boxes"],
                                                       inputs["img_info"][:, 4].to(torch.int64))
        losses = self.losses(logits, offsets, ctrness, labels, gt_offsets, gt_ctr)
        return losses["total_loss"], losses

    def candidates(self, logits_l, offsets_l, ctr_l, points_l):
        """Per level (B, R_l, ·) head outputs and (R_l, 2) points → the top 1000
        (point, class) pairs of each level and image: decoded boxes (B, P, 4),
        scores (B, P) with those at or below the threshold at ``NEG_INF``,
        labels (B, P)."""
        thresh = self.cfg.TEST.CLS_THRESHOLD
        boxes, scores, labels = [], [], []
        for logits, offsets, ctr, points in zip(logits_l, offsets_l, ctr_l, points_l):
            B, R, C = logits.shape
            score = torch.sqrt(torch.sigmoid(logits) * torch.sigmoid(ctr)[..., None]).reshape(B, -1)
            top_scores, top_idx = topk_scores(score, min(1000, R * C))
            pt_idx = top_idx // C
            boxes.append(self.box_coder.decode(points[pt_idx], gather_rows(offsets, pt_idx)))
            scores.append(torch.where(top_scores > thresh, top_scores, NEG_INF))
            labels.append(top_idx % C)
        return torch.cat(boxes, dim=1), torch.cat(scores, dim=1), torch.cat(labels, dim=1)

    def post_process(self, logits_l, offsets_l, ctr_l, img_info: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The module's NCHW head outputs → padded detections in original-image
        coordinates: candidates, class-aware NMS, rescale and clip."""
        points_l = self.points(logits_l)
        boxes, scores, labels = self.candidates(*self.flatten(logits_l, offsets_l, ctr_l), points_l)
        test_cfg = self.cfg.TEST
        out_boxes, out_scores, out_labels, valid = post_processing(
            boxes, scores, labels, img_info, iou_threshold=test_cfg.IOU_THRESHOLD,
            max_detections=test_cfg.MAX_BOXES_PER_IMAGE)
        return {"boxes": out_boxes, "box_scores": out_scores, "box_labels": out_labels, "valid": valid}

    @torch.inference_mode()
    def inference(self, batch):
        inputs = self.pre_process(batch)
        return self.post_process(*self.module(inputs["image"]), inputs["img_info"])

