"""ATSS in PyTorch (counterpart of ``basedet_tpu/models/det/atss.py``): FCOS
with adaptive training sample selection.

Each point carries a square pseudo-anchor of ``ANCHOR.SCALE`` strides. Per
gt and level the ``ANCHOR.TOPK`` points nearest its centre are candidates
(the lowest index first among equal distances, which the symmetric grid
makes common); a candidate is foreground where its IoU with the gt reaches
the mean plus the (population) standard deviation of the gt's candidate
IoUs and the point lies inside the gt; a point goes to its foreground gt of
largest IoU, the lowest gt index among ties. The (B, K, 4) gts against the
(R, 4) pseudo-anchors shared by every image go through kernel #10's wrapper
(``ops/iou_kernel.py::box_iou``) once a step. Losses and inference are
FCOS's.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from basedet_tpu_torch.layers.common.function import extract_topk_mask, first_argmax
from basedet_tpu_torch.models.det.fcos import FCOS, centerness
from basedet_tpu_torch.ops.iou_kernel import box_iou
from basedet_tpu_torch.ops.nms import gather_rows
from basedet_tpu_torch.utils.registry import registers


@registers.models.register()
class ATSS(FCOS):
    @torch.no_grad()
    def ground_truth(self, points_l: List[torch.Tensor], gt_boxes: torch.Tensor,
                     num_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        scale, topk = self.cfg.MODEL.ANCHOR.SCALE, self.cfg.MODEL.ANCHOR.TOPK
        anchors = torch.cat([torch.cat([p - s * scale / 2.0, p + s * scale / 2.0], dim=1)
                             for p, s in zip(points_l, self.strides)])
        points = torch.cat(points_l)
        K = gt_boxes.shape[1]
        gt_valid = torch.arange(K, device=gt_boxes.device)[None, :] < num_valid[:, None]
        gt_xyxy = gt_boxes[..., :4]
        centers = (gt_xyxy[..., :2] + gt_xyxy[..., 2:4]) * 0.5
        ious = box_iou(gt_xyxy.contiguous(), anchors)  # (B, K, R)

        masks, n_cand = [], 0
        for p in points_l:
            d = torch.sqrt(((centers[:, :, None, :] - p[None, None]) ** 2).sum(-1))
            k = min(topk, p.shape[0])
            masks.append(extract_topk_mask(-d, k)[1])
            n_cand += k
        is_candidate = torch.cat(masks, dim=-1)
        s1 = torch.where(is_candidate, ious, 0.0).sum(-1, keepdim=True)
        s2 = torch.where(is_candidate, ious.square(), 0.0).sum(-1, keepdim=True)
        mean = s1 / n_cand
        thr = mean + torch.sqrt((s2 / n_cand - mean.square()).clamp(min=0.0))
        is_fg = is_candidate & (ious >= thr)
        in_boxes = self.box_coder.encode(points[None, None], gt_xyxy[:, :, None]).amin(-1) > 0

        masked = torch.where(is_fg & in_boxes & gt_valid[:, :, None], ious, -1.0)
        matched = gather_rows(gt_boxes, first_argmax(masked, dim=1))
        labels = torch.where(masked.amax(1) <= -1.0, 0, matched[..., 4].to(torch.int64))
        gt_offsets = self.box_coder.encode(points[None], matched[..., :4])
        return labels, gt_offsets, centerness(gt_offsets)
