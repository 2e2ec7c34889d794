"""OTA in PyTorch (counterpart of ``basedet_tpu/models/det/ota.py``): FCOS with
optimal-transport label assignment; the centerness branch predicts the IoU.

The assignment, without gradient, over (B, K, R):
  * a point is a gt's candidate where it lies in the gt (every ltrb distance
    above 0.01) and in its centre region (2.5 strides);
  * the cost of (gt, point) is the focal loss of the point's class scores
    against the gt's class in closed form, Σ_c FL(p_c, 0) − FL(p_y, 0) +
    FL(p_y, 1), plus ``COST_REG_WEIGHTS`` times the -log IoU of the predicted
    offsets against the gt's, plus 1e6 off the candidates and 1e9 on padded
    gts;
  * ``MATCHING "topk"`` (the default): the dynamic-k matching of
    ``layers/common/matcher.py``, kernel #2 on the card, once per step over
    the batch; foreground also needs a candidate gt. ``"sinkhorn"``: the
    Sinkhorn matcher with the background cost Σ_c FL(p_c, 0).
The losses: focal over every point, the IoU loss (``IOU_LOSS_TYPE``) on the
foreground times 2, BCE of the predicted IoU against the matched IoU on the
foreground times 0.5, each over the foreground count. ``NORM_REG_TARGETS``
False decodes the offsets by ``exp`` (``exp_scale``). Inference is FCOS's,
the IoU branch in place of centerness.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from basedet_tpu_torch.layers.common.matcher import SinkhornMatcher, topk_dynamic_k_matching
from basedet_tpu_torch.layers.losses import binary_cross_entropy, iou_loss, sigmoid_focal_loss
from basedet_tpu_torch.models.det.fcos import FCOS, in_centre_region
from basedet_tpu_torch.ops.nms import gather_rows
from basedet_tpu_torch.parallel import global_normaliser
from basedet_tpu_torch.utils.registry import registers


@registers.models.register()
class OTA(FCOS):
    def __init__(self, cfg, device, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device, generator)
        self.matching = cfg.MODEL.get("MATCHING", "topk")
        if self.matching not in ("topk", "sinkhorn"):
            raise ValueError(f"MODEL.MATCHING {self.matching!r} is not topk or sinkhorn")
        self.reg_weight = cfg.MODEL.HEAD.get("COST_REG_WEIGHTS", 1.5)
        self.sinkhorn = SinkhornMatcher(eps=0.1, n_iters=50)

    @staticmethod
    def head_decode_mode(cfg) -> str:
        return "relu_scale" if cfg.MODEL.HEAD.get("NORM_REG_TARGETS", True) else "exp_scale"

    def costs(self, points_l: List[torch.Tensor], gt_boxes: torch.Tensor, num_valid: torch.Tensor,
              pred_offsets: torch.Tensor, cls_logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The matching's inputs: cost (B, K, R), the candidates' ious (0 off
        them), the background cost (B, R), gt_valid (B, K), the candidate mask
        and the gts' ltrb targets (B, K, R, 4)."""
        points = torch.cat(points_l)
        K = gt_boxes.shape[1]
        gt_valid = torch.arange(K, device=gt_boxes.device)[None, :] < num_valid[:, None]
        gt_xyxy = gt_boxes[..., :4]
        lcfg = self.cfg.MODEL.LOSSES
        alpha, gamma = lcfg.FOCAL_LOSS_ALPHA, lcfg.FOCAL_LOSS_GAMMA

        deltas = self.box_coder.encode(points[None, None], gt_xyxy[:, :, None])  # (B, K, R, 4)
        in_boxes = deltas.amin(-1) > 0.01
        in_centers = in_centre_region(points, self.level_strides(points_l) * 2.5, gt_xyxy)
        both = in_boxes & in_centers & gt_valid[:, :, None]

        eps = 1e-12
        p = torch.sigmoid(cls_logits)  # (B, R, C)
        s0 = (-(1 - alpha) * p ** gamma * torch.log((1 - p).clamp(min=eps))).sum(-1)  # (B, R)
        labels0 = (gt_boxes[..., 4].to(torch.int64) - 1).clamp(0, self.num_classes - 1)
        p_y = torch.gather(p, 2, labels0[:, None, :].expand(-1, p.shape[1], -1)).transpose(1, 2)  # (B, K, R)
        fl1_y = -alpha * (1 - p_y) ** gamma * torch.log(p_y.clamp(min=eps))
        fl0_y = -(1 - alpha) * p_y ** gamma * torch.log((1 - p_y).clamp(min=eps))
        loss_cls = s0[:, None, :] - fl0_y + fl1_y

        loss_delta, ious = iou_loss(pred_offsets[:, None].expand(deltas.shape), deltas, box_mode="ltrb",
                                    loss_type="iou", return_iou=True)
        cost = loss_cls + self.reg_weight * loss_delta + 1e6 * (~both) + 1e9 * (~gt_valid)[:, :, None]
        return {"cost": cost, "ious": torch.where(both, ious, 0.0), "bg_cost": s0, "gt_valid": gt_valid,
                "both": both, "deltas": deltas}

    @torch.no_grad()
    def ground_truth(self, points_l: List[torch.Tensor], gt_boxes: torch.Tensor, num_valid: torch.Tensor,
                     pred_offsets: torch.Tensor, cls_logits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ labels (B, R) int64 (0 background), ltrb targets (B, R, 4) and
        matched IoUs (B, R), both 0 off the foreground."""
        c = self.costs(points_l, gt_boxes, num_valid, pred_offsets, cls_logits)
        if self.matching == "sinkhorn":
            matched, fg = self.sinkhorn(c["cost"], c["bg_cost"], c["gt_valid"], c["ious"])
        else:
            matched, fg = topk_dynamic_k_matching(c["cost"], c["ious"], c["gt_valid"],
                                                  candidate_topk=self.cfg.MODEL.HEAD.get("CANDIDATE_K", 10))
            matched, fg = matched.to(torch.int64), fg & c["both"].any(dim=1)
        labels = torch.where(fg, gather_rows(gt_boxes, matched)[..., 4].to(torch.int64), 0)
        B, K, R, _ = c["deltas"].shape
        gt_deltas = torch.gather(c["deltas"], 1, matched[:, None, :, None].expand(B, 1, R, 4))[:, 0]
        gt_ious = torch.gather(c["ious"], 1, matched[:, None, :])[:, 0]
        return labels, torch.where(fg[..., None], gt_deltas, 0.0), torch.where(fg, gt_ious, 0.0)

    def losses(self, logits: torch.Tensor, offsets: torch.Tensor, pred_ious: torch.Tensor, labels: torch.Tensor,
               gt_deltas: torch.Tensor, gt_ious: torch.Tensor) -> Dict[str, torch.Tensor]:
        fg = labels > 0
        num_fg = global_normaliser(fg.sum(), 1.0)
        lcfg = self.cfg.MODEL.LOSSES
        loss_cls = sigmoid_focal_loss(logits, self.one_hot(labels, logits.dtype), alpha=lcfg.FOCAL_LOSS_ALPHA,
                                      gamma=lcfg.FOCAL_LOSS_GAMMA).sum() / num_fg
        loss_reg = ((iou_loss(offsets, gt_deltas, box_mode="ltrb", loss_type=lcfg.IOU_LOSS_TYPE) * fg).sum()
                    / num_fg * 2.0)
        loss_ious = (binary_cross_entropy(pred_ious, gt_ious, with_logits=True) * fg).sum() / num_fg * 0.5
        total = loss_cls + loss_reg + loss_ious
        return {"total_loss": total, "loss_cls": loss_cls, "loss_offsets": loss_reg, "loss_ious": loss_ious}

    def get_losses(self, batch):
        """→ (total, {total_loss, loss_cls, loss_offsets, loss_ious}),
        differentiable in the trainable parameters."""
        inputs = self.pre_process(batch, train=True)
        head_out = self.module(inputs["image"])
        points_l = self.points(head_out[0])
        logits, offsets, pred_ious = (torch.cat(x, dim=1) for x in self.flatten(*head_out))
        labels, gt_deltas, gt_ious = self.ground_truth(points_l, inputs["gt_boxes"],
                                                       inputs["img_info"][:, 4].to(torch.int64),
                                                       offsets.detach(), logits.detach())
        losses = self.losses(logits, offsets, pred_ious, labels, gt_deltas, gt_ious)
        return losses["total_loss"], losses
