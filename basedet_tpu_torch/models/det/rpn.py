"""Region Proposal Network, inference (counterpart of ``basedet_tpu/models/det/rpn.py``):
the shared conv head, and the per-level top-k, decode, clip and level-wise
NMS into a fixed number of proposal slots, batched over images where the JAX
package vmaps. The ground truth and losses come with training.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers.common.function import topk_scores
from basedet_tpu_torch.ops.nms import NEG_INF, batched_nms_padded, gather_rows
from basedet_tpu_torch.structures import BoxCoder, clip_boxes, nonempty_mask


class RPNHead(nn.Module):
    """3x3 conv + ReLU, then 1x1 objectness logits (A) and box offsets (4A),
    shared over the levels. Per level it returns logits (B, H*W*A) and
    offsets (B, H*W*A, 4) in the JAX package's (h, w, a) order."""

    def __init__(self, in_channels: int, channels: int = 256, num_cell_anchors: int = 3,
                 device=None):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, channels, 3, padding=1, device=device)
        self.rpn_cls_score = nn.Conv2d(channels, num_cell_anchors, 1, device=device)
        self.rpn_bbox_offsets = nn.Conv2d(channels, num_cell_anchors * 4, 1, device=device)

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, offsets = [], []
        for f in features:
            t = F.relu(self.rpn_conv(f))
            b = t.shape[0]
            logits.append(self.rpn_cls_score(t).permute(0, 2, 3, 1).reshape(b, -1))
            offsets.append(self.rpn_bbox_offsets(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return logits, offsets


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
    Ties in the top-k go to the lower index, as ``lax.top_k`` gives them."""
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
