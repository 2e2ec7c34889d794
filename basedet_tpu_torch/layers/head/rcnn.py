"""R-CNN box head (counterpart of ``basedet_tpu/layers/head/rcnn.py``): the
predictor, flatten → fc1 (1024) → fc2 (1024) → class logits (C + 1) and
class-specific deltas (C, 4); the sampling of a fixed number of RoIs from
proposals and gt boxes; and the losses. Batched over images where the JAX
package vmaps.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision, remat
from basedet_tpu_torch.layers.common.function import first_argmax, topk_scores
from basedet_tpu_torch.layers.common.sampling import sample_mask
from basedet_tpu_torch.layers.losses import smooth_l1_loss
from basedet_tpu_torch.ops.iou_kernel import box_iou
from basedet_tpu_torch.ops.nms import gather_rows
from basedet_tpu_torch.parallel import global_normaliser
from basedet_tpu_torch.structures import BoxCoder


class RCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = nn.Linear(in_features, 1024, device=device)
        self.fc2 = nn.Linear(1024, 1024, device=device)
        self.pred_cls = nn.Linear(1024, num_classes + 1, device=device)
        self.pred_delta = nn.Linear(1024, num_classes * 4, device=device)

    def forward(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled (R, ph, pw, C), channels last as the JAX package pools →
        (logits (R, C + 1), deltas (R, C, 4)). The flatten is in (h, w, c)
        order, the order of the flax ``fc1`` kernel's rows. The layers follow
        the compute policy (``layers/precision.py``), one segment under
        ``TRAINER.REMAT`` (``layers/remat.py``)."""
        return remat.segment(self._forward, pooled)

    def _forward(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(precision.linear(self.fc1, x))
        x = F.relu(precision.linear(self.fc2, x))
        return (precision.linear(self.pred_cls, x),
                precision.linear(self.pred_delta, x).reshape(-1, self.num_classes, 4))


@torch.no_grad()
def rcnn_sample(
    noise_fg: torch.Tensor,
    noise_bg: torch.Tensor,
    noise_tie: torch.Tensor,
    proposals: torch.Tensor,
    proposal_valid: torch.Tensor,
    gt: torch.Tensor,
    num_valid: torch.Tensor,
    num_rois: int,
    fg_ratio: float,
    fg_thresh: float,
    bg_thresh_high: float,
    bg_thresh_low: float,
    box_coder: BoxCoder,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """proposals (B, P, 4) with proposal_valid (B, P), gt (B, K, 5) padded
    with num_valid (B,), and three (B, P + K) uniform noises → rois
    (B, num_rois, 4), labels (B, num_rois) (class 1-based, 0 background, -1
    an unfilled row), box targets (B, num_rois, 4), zero off the foreground,
    and loss weights (B, num_rois) (``rcnn_sample_single``, batched).

    Candidates are the proposals and the gt boxes. Foreground is sampled up
    to ``num_rois * fg_ratio``, background fills the rest, and the rows are
    compacted by priority (foreground, then background, then the rest, by
    ``noise_tie`` within a tier) with the stable top-k, so that the slots
    keep the JAX package's order. An image without gt has neither foreground
    nor background, and all of its rows weigh 0."""
    K = gt.shape[1]
    gt_valid = torch.arange(K, device=gt.device)[None, :] < num_valid[:, None]
    all_rois = torch.cat([proposals, gt[..., :4]], dim=1)  # (B, P + K, 4)
    roi_valid = torch.cat([proposal_valid, gt_valid], dim=1)

    overlaps = box_iou(all_rois, gt[..., :4])  # (B, P + K, K)
    overlaps = torch.where(gt_valid[:, None, :], overlaps, -1.0)
    max_ov = overlaps.amax(dim=2)
    assignment = first_argmax(overlaps, dim=2)

    fg_mask = (max_ov >= fg_thresh) & roi_valid
    bg_mask = (max_ov >= bg_thresh_low) & (max_ov < bg_thresh_high) & roi_valid
    sel_fg = sample_mask(noise_fg, fg_mask, int(num_rois * fg_ratio), cap=num_rois)
    sel_bg = sample_mask(noise_bg, bg_mask, num_rois - sel_fg.sum(1), cap=num_rois)

    priority = sel_fg * 2.0 + sel_bg * 1.0 + noise_tie * 0.5
    _, order = topk_scores(priority, num_rois)
    rois = gather_rows(all_rois, order)
    assigned = gather_rows(gather_rows(gt, assignment), order)  # (B, num_rois, 5)
    chosen_fg, chosen_bg = sel_fg.gather(1, order), sel_bg.gather(1, order)
    labels = torch.where(chosen_fg, assigned[..., 4].long(), torch.where(chosen_bg, 0, -1))
    targets = box_coder.encode(rois, assigned[..., :4])
    targets = torch.where(chosen_fg[..., None], targets, 0.0)
    return rois, labels, targets, (chosen_fg | chosen_bg).to(torch.float32)


def rcnn_losses(
    logits: torch.Tensor,
    deltas: torch.Tensor,
    labels: torch.Tensor,
    targets: torch.Tensor,
    weight: torch.Tensor,
    smooth_l1_beta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (N, C + 1), deltas (N, C, 4), labels (N,) with -1 for unfilled
    rows, targets (N, 4), weight (N,) → (softmax cross-entropy, box L1 on the
    foreground's own class), each summed over all rows of the batch and
    divided by the sum of the weights over the global batch (at least 1; this
    rank's share of it, ``parallel.global_normaliser``)."""
    num = global_normaliser(weight.sum(), 1.0)
    log_probs = F.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(1, labels.clamp(min=0)[:, None])[:, 0]
    cls_loss = (nll * weight).sum() / num

    fg = labels > 0
    cls_idx = (labels - 1).clamp(min=0)
    fg_deltas = deltas.float().gather(1, cls_idx[:, None, None].expand(-1, 1, 4))[:, 0, :]
    reg_loss = (smooth_l1_loss(fg_deltas, targets, smooth_l1_beta) * fg[:, None]).sum() / num
    return cls_loss, reg_loss
