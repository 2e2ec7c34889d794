"""Region Proposal Network (counterpart of ``basedet_tpu/models/det/rpn.py``):
the shared conv head; the per-level top-k, decode, clip and level-wise NMS
into a fixed number of proposal slots; the anchors' ground truth with its
sampling; and the losses. Batched over images where the JAX package vmaps.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision, remat
from basedet_tpu_torch.layers.common.function import topk_scores
from basedet_tpu_torch.layers.common.matcher import Matcher
from basedet_tpu_torch.layers.common.sampling import sample_mask
from basedet_tpu_torch.layers.losses import binary_cross_entropy, smooth_l1_loss
from basedet_tpu_torch.ops.iou_kernel import box_iou
from basedet_tpu_torch.ops.nms import NEG_INF, batched_nms_padded, gather_rows
from basedet_tpu_torch.parallel import global_normaliser
from basedet_tpu_torch.structures import BoxCoder, clip_boxes, nonempty_mask


class RPNHead(nn.Module):
    """3x3 conv + ReLU, then 1x1 objectness logits (A) and box offsets (4A),
    shared over the levels. Per level it returns logits (B, H*W*A) and
    offsets (B, H*W*A, 4) in the JAX package's (h, w, a) order, in the
    compute policy's dtype (``layers/precision.py``); each level a segment
    under ``TRAINER.REMAT`` (``layers/remat.py``)."""

    def __init__(self, in_channels: int, channels: int = 256, num_cell_anchors: int = 3,
                 device=None):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, channels, 3, padding=1, device=device)
        self.rpn_cls_score = nn.Conv2d(channels, num_cell_anchors, 1, device=device)
        self.rpn_bbox_offsets = nn.Conv2d(channels, num_cell_anchors * 4, 1, device=device)

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        outs = [remat.segment(self._forward_level, f) for f in features]
        return [lg for lg, _ in outs], [of for _, of in outs]

    def _forward_level(self, f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t = F.relu(precision.conv2d(self.rpn_conv, f))
        b = t.shape[0]
        return (precision.conv2d(self.rpn_cls_score, t).permute(0, 2, 3, 1).reshape(b, -1),
                precision.conv2d(self.rpn_bbox_offsets, t).permute(0, 2, 3, 1).reshape(b, -1, 4))


def find_top_proposals(
    logits_l: Sequence[torch.Tensor],
    offsets_l: Sequence[torch.Tensor],
    anchors_l: Sequence[torch.Tensor],
    img_hw: torch.Tensor,
    box_coder: BoxCoder,
    prev_nms_topk: int,
    post_nms_topk: int,
    nms_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per level (B, R_l) logits, (B, R_l, 4) offsets and (R_l, 4) anchors,
    img_hw (B, 2) [cur_h, cur_w] → proposals (B, P, 4), scores (B, P), valid
    (B, P) with P = post_nms_topk (``find_top_proposals_single``, batched).
    Ties in the top-k go to the lower index, as ``lax.top_k`` gives them.
    Under the bf16 policy the scores stay bf16 and the offsets decode against
    the f32 anchors, which promotes the proposals to f32."""
    cand_boxes, cand_scores, cand_levels = [], [], []
    for level, (scores, offsets, anchors) in enumerate(zip(logits_l, offsets_l, anchors_l)):
        k = min(prev_nms_topk, scores.shape[1])
        top_scores, idx = topk_scores(scores, k)
        props = box_coder.decode(anchors[idx], gather_rows(offsets, idx))
        props = clip_boxes(props, img_hw[:, 0], img_hw[:, 1])
        cand_boxes.append(props)
        cand_scores.append(torch.where(nonempty_mask(props), top_scores, NEG_INF))
        cand_levels.append(torch.full_like(idx, level))
    _, boxes, scores, valid = batched_nms_padded(
        torch.cat(cand_boxes, 1), torch.cat(cand_scores, 1), torch.cat(cand_levels, 1),
        nms_threshold, post_nms_topk,
    )
    return boxes, scores, valid


@torch.no_grad()
def rpn_ground_truth(
    noise_pos: torch.Tensor,
    noise_neg: torch.Tensor,
    anchors: torch.Tensor,
    gt: torch.Tensor,
    num_valid: torch.Tensor,
    matcher: Matcher,
    box_coder: BoxCoder,
    num_sample_anchors: int,
    num_pos_anchor: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """anchors (R, 4), gt (B, K, 5) padded, num_valid (B,), noise_pos and
    noise_neg (B, R) uniform → labels (B, R) (1 foreground, 0 background,
    -1 ignored or not sampled) and offsets (B, R, 4), zero off the foreground
    (``rpn_ground_truth_single``, batched). At most ``num_pos_anchor``
    positives are kept and negatives fill up to ``num_sample_anchors``, a
    quota per image that depends on its positives."""
    K = gt.shape[1]
    gt_valid = torch.arange(K, device=gt.device)[None, :] < num_valid[:, None]
    overlaps = box_iou(gt[..., :4], anchors)  # (B, K, R), the anchors shared by every image
    match_idx, labels = matcher(overlaps, gt_valid)
    offsets = box_coder.encode(anchors[None], gather_rows(gt[..., :4], match_idx))
    offsets = torch.where((labels == 1)[..., None], offsets, 0.0)

    pos_keep = sample_mask(noise_pos, labels == 1, num_pos_anchor, cap=num_sample_anchors)
    labels = torch.where((labels == 1) & ~pos_keep, -1, labels)
    num_neg = num_sample_anchors - (labels == 1).sum(1)
    neg_keep = sample_mask(noise_neg, labels == 0, num_neg, cap=num_sample_anchors)
    labels = torch.where((labels == 0) & ~neg_keep, -1, labels)
    return labels, offsets


def rpn_losses(
    logits: torch.Tensor,
    offsets: torch.Tensor,
    labels: torch.Tensor,
    gt_offsets: torch.Tensor,
    smooth_l1_beta: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, R), offsets (B, R, 4), labels (B, R), gt_offsets (B, R, 4)
    → (objectness BCE, box L1), each summed over the batch and divided by the
    global batch's count of sampled anchors (at least 1; this rank's share of
    it, ``parallel.global_normaliser``). As in the JAX package, the
    BCE runs in the logits' dtype (bf16 under the policy, the labels cast to
    it) and the box loss promotes against the f32 targets."""
    valid = labels >= 0
    fg = labels > 0
    num_valid = global_normaliser(valid.sum(), 1.0)
    cls_loss = (binary_cross_entropy(logits, labels.to(logits.dtype), with_logits=True) * valid).sum() / num_valid
    reg_loss = (smooth_l1_loss(offsets, gt_offsets, smooth_l1_beta) * fg[..., None]).sum() / num_valid
    return cls_loss, reg_loss
