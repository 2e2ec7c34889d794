"""FreeAnchor in PyTorch (counterpart of ``basedet_tpu/models/det/free_anchor.py``):
RetinaNet with the learning-to-match bag loss, in the JAX package's default
"rows + dense" form.

Per image, without gradient: the predicted boxes (anchors decoded by the
predicted offsets) against the gts through kernel #10's wrapper (the
per-image (B, N, 4) form), each gt's IoUs mapped to a box probability
clip((IoU - t1) / (t2 - t1), 0, 1), t2 its largest IoU; each gt's 128 largest
probabilities land on (anchor, gt class) by a scatter-max (two gts of one
class on one anchor: the larger); and the gts against the anchors (the
shared (R, 4) form of kernel #10), each gt's ``BUCKET_SIZE`` best anchors
its bag. Both top-k are exact, the lowest index first among ties (a stable
sort), as ``lax.top_k`` gives them: ties decide the bag's edge and which
zeros of the box probability are taken. The positive loss is the -log of
each gt's mean-max of its bag's class score times exp(-L1 of the offsets);
the negative loss is the focal term of every score times (1 - box
probability).

The ``BASEDET_FA_GATHER``/``BASEDET_FA_NEG`` variants of the JAX package are
not ported; inference is RetinaNet's.
"""
from __future__ import annotations

from typing import Dict

import torch

from basedet_tpu_torch.layers.common.function import topk_scores
from basedet_tpu_torch.layers.losses import smooth_l1_loss
from basedet_tpu_torch.models.det.retinanet import RetinaNet
from basedet_tpu_torch.ops.iou_kernel import box_iou
from basedet_tpu_torch.ops.nms import gather_rows
from basedet_tpu_torch.parallel import global_normaliser
from basedet_tpu_torch.utils.registry import registers


def _safelog(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return torch.log(x.clamp(min=eps))


@registers.models.register()
class FreeAnchor(RetinaNet):
    @torch.no_grad()
    def box_prob(self, anchors: torch.Tensor, offsets: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """→ (B, R, C): each (anchor, class)'s largest box probability over the
        gts of that class, from each gt's top 128."""
        B, R, _ = offsets.shape
        C, eps, t1 = self.num_classes, 1e-7, self.cfg.MODEL.BUCKET.BOX_IOU_THRESH
        pred_box = self.box_coder.decode(anchors[None], offsets)
        overlaps = torch.where(gt_valid[..., None], box_iou(gt_boxes[..., :4].contiguous(), pred_box), 0.0)
        t2 = overlaps.amax(-1, keepdim=True).clamp(t1 + eps, 1.0)
        gt_prob = torch.where(gt_valid[..., None], ((overlaps - t1) / (t2 - t1)).clamp(0.0, 1.0), 0.0)
        top_prob, top_idx = topk_scores(gt_prob, min(128, R))  # (B, K, P)
        flat = (top_idx * C + labels[..., None]).reshape(B, -1)
        return (torch.zeros(B, R * C, device=offsets.device)
                .scatter_reduce_(1, flat, top_prob.reshape(B, -1), "amax").view(B, R, C))

    @torch.no_grad()
    def assign(self, anchors: torch.Tensor, offsets: torch.Tensor, gt_boxes: torch.Tensor,
               num_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """anchors (R, 4), offsets (B, R, 4), padded gts → gt_valid (B, K), the
        gts' 0-based classes (B, K), the box probability (B, R, C) and each
        gt's bag of anchors (B, K, BUCKET_SIZE)."""
        C = self.num_classes
        K = gt_boxes.shape[1]
        gt_valid = torch.arange(K, device=gt_boxes.device)[None, :] < num_valid[:, None]
        labels = (gt_boxes[..., 4].to(torch.int64) - 1).clamp(0, C - 1)
        box_prob = self.box_prob(anchors, offsets, gt_boxes, gt_valid, labels)
        quality = torch.where(gt_valid[..., None], box_iou(gt_boxes[..., :4].contiguous(), anchors), -1.0)
        bag = topk_scores(quality, int(self.cfg.MODEL.BUCKET.BUCKET_SIZE))[1]
        return {"gt_valid": gt_valid, "labels": labels, "box_prob": box_prob, "bag": bag}

    def bag_losses(self, anchors: torch.Tensor, scores: torch.Tensor, offsets: torch.Tensor,
                   gt_boxes: torch.Tensor, num_valid: torch.Tensor, a: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """anchors (R, 4), scores (B, R, C) sigmoid, offsets (B, R, 4), padded
        gts and their ``assign`` → the positive and negative losses."""
        lcfg = self.cfg.MODEL.LOSSES
        gamma, alpha, eps = lcfg.FOCAL_LOSS_GAMMA, lcfg.FOCAL_LOSS_ALPHA, 1e-7
        B, R, C = scores.shape
        matched = a["bag"]
        K, bag_size = matched.shape[1:]
        matched_score = torch.gather(scores.reshape(B, -1), 1,
                                     (matched * C + a["labels"][..., None]).reshape(B, -1)).view(B, K, bag_size)
        m_offsets = gather_rows(offsets, matched.reshape(B, -1)).view(B, K, bag_size, 4)
        target = self.box_coder.encode(anchors[matched], gt_boxes[:, :, None, :4].expand(-1, -1, bag_size, -1))
        reg_loss = smooth_l1_loss(m_offsets, target, beta=lcfg.SMOOTH_L1_BETA).sum(-1) * lcfg.REG_LOSS_WEIGHT
        bag = matched_score * torch.exp(-reg_loss)
        w = 1.0 / (1.0 - bag).clamp(min=eps)
        w = w / w.sum(-1, keepdim=True)
        pos_losses = -_safelog((w * bag).sum(-1)) * a["gt_valid"]

        # the gt count over the global batch, as this rank's share; at least 1, so the JAX package's
        # floor of num_fg · bag_size at 1 never acts
        num_fg = global_normaliser(num_valid.sum(), 1.0)
        pos_loss = pos_losses.sum() / num_fg * alpha
        neg_scores = scores * (1.0 - a["box_prob"])
        neg_loss = ((neg_scores ** gamma * -_safelog(1.0 - neg_scores)).sum()
                    / (num_fg * bag_size) * (1 - alpha))
        total = pos_loss + neg_loss
        return {"total_loss": total, "pos_loss": pos_loss, "neg_loss": neg_loss}

    def get_losses(self, batch):
        """→ (total, {total_loss, pos_loss, neg_loss}), differentiable in the
        trainable parameters. Two IoUs a step go through kernel #10's
        wrapper."""
        inputs = self.pre_process(batch, train=True)
        logits_l, offsets_l = self.module(inputs["image"])
        anchors = torch.cat(self.anchors(logits_l), dim=0)
        logits, offsets = (torch.cat(x, dim=1) for x in self.flatten(logits_l, offsets_l))
        gt_boxes, num_valid = inputs["gt_boxes"], inputs["img_info"][:, 4].to(torch.int64)
        losses = self.bag_losses(anchors, torch.sigmoid(logits), offsets, gt_boxes, num_valid,
                                 self.assign(anchors, offsets.detach(), gt_boxes, num_valid))
        return losses["total_loss"], losses
