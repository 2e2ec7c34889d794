"""YOLOX in PyTorch (counterpart of ``basedet_tpu/models/det/yolox.py``):
inference, and training with SimOTA assignment, the IoU, objectness, class
and L1 losses and the step-seeded multiscale resize.

The batch is written out where the JAX package vmaps over images, and
``torch.gather`` takes the place of the one-hot matmul gathers
(``onehot_gather_rows``, ``onehot_pick_per_column``); both are exact.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers.backbone.yolo_pafpn import YOLOPAFPN
from basedet_tpu_torch.layers.common.anchor_generator import FastPointGenerator
from basedet_tpu_torch.layers.common.function import full_f32, topk_scores
from basedet_tpu_torch.layers.common.matcher import topk_dynamic_k_matching
from basedet_tpu_torch.layers.common.post_processing import post_processing
from basedet_tpu_torch.layers.head.yolo_head import YOLOXHead
from basedet_tpu_torch.layers.losses import binary_cross_entropy, iou_loss, smooth_l1_loss
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.models.cls.csp_darknet import CSPDarknet
from basedet_tpu_torch.ops.nms import NEG_INF, gather_rows
from basedet_tpu_torch.structures import box_iou, convert_boxes
from basedet_tpu_torch.utils.registry import registers


def _flatten_level(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, A*k, H, W) → (N, H*W*A, k) f32 in the JAX package's (h, w, a)
    order: the channels move last before the flatten. As in the JAX package,
    this is where the bf16 policy's head outputs become f32: the decode, the
    assignment and the losses run in f32."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w * (c // k), k).float()


class YOLOXModule(nn.Module):
    def __init__(self, num_classes=80, depth_factor=1.0, width_factor=1.0, depthwise=False,
                 act="silu", device=None):
        super().__init__()
        self.backbone = CSPDarknet(depth_factor, width_factor, depthwise=depthwise, act=act,
                                   device=device)
        self.pafpn = YOLOPAFPN(depth_factor, width_factor, depthwise=depthwise, act=act,
                               device=device)
        self.head = YOLOXHead(
            num_classes, [int(c * width_factor) for c in (256, 512, 1024)],
            mid_channels=int(256 * width_factor), act=act, depthwise=depthwise, device=device,
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Conv kernels lecun-normal (std sqrt(1/fan_in)), biases 0, BN the
        identity, then the head's prior-prob bias."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, math.sqrt(1.0 / fan_in), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        self.head.init_prior_bias()

    @full_f32()
    def forward(self, image: torch.Tensor):
        feats = self.backbone(image)
        pan_outs = self.pafpn([feats["dark3"], feats["dark4"], feats["dark5"]])
        return self.head(pan_outs)


@registers.models.register()
class YOLOX(BaseNet):
    follows_compute_policy = True

    def __init__(self, cfg, device, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device)
        self.strides = (8, 16, 32)
        self.point_gen = FastPointGenerator(self.strides)
        self.img_mean = None  # YOLOX consumes raw pixels
        self.img_std = None
        self.use_l1 = bool(cfg.MODEL.get("USE_L1", False))
        m = cfg.MODEL
        module = YOLOXModule(self.num_classes, m.DEPTH_FACTOR, m.WIDTH_FACTOR, m.DEPTHWISE,
                             m.ACTIVATION, device="meta")
        self.module = module.to_empty(device=self.device).eval()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.module.init_weights(generator)

    # -- multiscale -------------------------------------------------------------
    def target_size_for_step(self, step: int) -> Tuple[int, int]:
        """Every SYNC_ITER steps a size from 32·[lo, hi], seeded by the step,
        as the JAX package draws it."""
        setting = self.cfg.AUG.TRAIN_SETTING
        lo, hi = setting.MULTISCALE_RANGE
        rng = np.random.RandomState(int(step) // setting.get("SYNC_ITER", 10))
        k = rng.randint(lo, hi + 1)
        return (32 * k, 32 * k)

    def resize_batch(self, batch: Dict[str, Any], target_size: Tuple[int, int]) -> Dict[str, Any]:
        """Bilinear resize of the images on the model's device, and of the gt
        boxes, to target_size. Downscaling antialiases, as
        ``jax.image.resize`` does; a batch already at that size comes back
        as it is."""
        images = torch.as_tensor(batch["data"]).to(self.device, torch.float32)
        h, w = images.shape[1:3]
        th, tw = target_size
        if (h, w) == (th, tw):
            return batch
        resized = F.interpolate(images.permute(0, 3, 1, 2), size=(th, tw), mode="bilinear",
                                align_corners=False, antialias=th < h or tw < w)
        gt = torch.as_tensor(batch["gt_boxes"]).to(self.device, torch.float32).clone()
        gt[..., :4] *= torch.tensor([tw / w, th / h, tw / w, th / h], device=self.device)
        info = torch.as_tensor(batch["im_info"]).to(self.device, torch.float32).clone()
        info[:, 0], info[:, 1] = th, tw
        return {**batch, "data": resized.permute(0, 2, 3, 1), "gt_boxes": gt, "im_info": info}

    def train_batch_mapper(self, batch: Dict[str, Any], step: int) -> Dict[str, Any]:
        """The trainer's per-step hook: the multiscale resize for ``step``
        (the trainer's 1-based iteration)."""
        size = self.target_size_for_step(step)
        self.extra_meter = {"img_size": size[0]}
        return self.resize_batch(batch, size)

    # -- assignment ---------------------------------------------------------------
    @torch.no_grad()
    def assign(
        self,
        anchors: torch.Tensor,
        strides_vec: torch.Tensor,
        gt: torch.Tensor,
        num_valid: torch.Tensor,
        pred_xcycwh: torch.Tensor,
        cls_logits: torch.Tensor,
        obj_logits: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """SimOTA over the batch (``_assign_single``, vmapped in the JAX
        package): anchors (R, 2), strides_vec (R,), gt (B, K, 5), num_valid
        (B,), pred_xcycwh (B, R, 4), cls_logits (B, R, C), obj_logits
        (B, R, 1), all detached → fg_mask (B, R), matched_gt (B, R) int32,
        pred_iou (B, R). No gradient flows, as under ``stop_gradient``."""
        K, R, C = gt.shape[1], anchors.shape[0], self.num_classes
        gt_valid = torch.arange(K, device=gt.device)[None, :] < num_valid[:, None]  # (B, K)
        x1, y1, x2, y2 = (gt[..., i, None] for i in range(4))  # (B, K, 1)
        ax, ay = anchors[:, 0], anchors[:, 1]

        in_boxes = torch.minimum(torch.minimum(ax - x1, ay - y1), torch.minimum(x2 - ax, y2 - ay)) > 0
        cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
        radius = 2.5 * strides_vec
        in_centers = torch.minimum(
            torch.minimum(ax - (cx - radius), ay - (cy - radius)),
            torch.minimum((cx + radius) - ax, (cy + radius) - ay),
        ) > 0
        in_boxes &= gt_valid[..., None]
        in_centers &= gt_valid[..., None]
        candidate = in_boxes.any(dim=1) | in_centers.any(dim=1)  # (B, R)
        both = in_boxes & in_centers

        ious = box_iou(gt[..., :4], convert_boxes(pred_xcycwh, "xcycwh", "xyxy"))  # (B, K, R)
        ious = torch.where(gt_valid[..., None] & candidate[:, None, :], ious, 0.0)

        # classification cost via the closed-form one-hot BCE:
        # sum_c BCE(p_c, 0) + log(1 - p_y) - log(p_y)
        p = torch.sqrt(torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits))  # (B, R, C)
        eps = 1e-8
        s0 = (-torch.log((1 - p).clamp(min=eps))).sum(dim=-1)  # (B, R)
        labels0 = (gt[..., 4].to(torch.int32) - 1).clamp(0, C - 1).long()  # (B, K)
        p_y = torch.gather(p, 2, labels0[:, None, :].expand(-1, R, -1)).transpose(1, 2)  # (B, K, R)
        cls_cost = s0[:, None, :] + torch.log((1 - p_y).clamp(min=eps)) - torch.log(p_y.clamp(min=eps))

        cost = (
            cls_cost
            + 3.0 * -torch.log(ious + 1e-8)
            + 100000.0 * ~both
            + 1e9 * ~candidate[:, None, :]
            + 1e9 * ~gt_valid[..., None]
        )
        matched_gt, fg_mask = topk_dynamic_k_matching(cost, ious, gt_valid, candidate_topk=10)
        fg_mask &= candidate
        pred_iou = torch.gather(ious, 1, matched_gt[:, None, :].long())[:, 0]  # (B, R)
        return fg_mask, matched_gt, pred_iou

    # -- train ----------------------------------------------------------------------
    def get_losses(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch → (total_loss, {total_loss, iou_loss, obj_loss, cls_loss,
        l1_loss}). In train mode the BN running statistics update in place,
        as the JAX package returns its new ``batch_stats``."""
        inputs = self.pre_process(batch, train=True)
        logits_l, offsets_l, objs_l = self.module(inputs["image"])
        grids_l, strides_l = self.point_gen([tuple(x.shape[2:]) for x in logits_l], self.device)
        anchors = torch.cat(grids_l, dim=0)  # (R, 2) pixels
        strides_vec = torch.cat(strides_l, dim=0)  # (R,)

        C = self.num_classes
        cls_logits = torch.cat([_flatten_level(x, C) for x in logits_l], dim=1)  # (B, R, C)
        raw_offsets = torch.cat([_flatten_level(x, 4) for x in offsets_l], dim=1)  # (B, R, 4)
        obj_logits = torch.cat([_flatten_level(x, 1) for x in objs_l], dim=1)[..., 0]  # (B, R)

        xy = raw_offsets[..., :2] * strides_vec[None, :, None] + anchors[None]
        wh = torch.exp(raw_offsets[..., 2:4]) * strides_vec[None, :, None]
        pred_xcycwh = torch.cat([xy, wh], dim=-1)

        gt_boxes = inputs["gt_boxes"]
        num_valid = inputs["img_info"][:, 4].to(torch.int32)
        fg_mask, matched_gt, pred_iou = self.assign(
            anchors, strides_vec, gt_boxes, num_valid, pred_xcycwh.detach(),
            cls_logits.detach(), obj_logits.detach()[..., None],
        )

        matched = gather_rows(gt_boxes, matched_gt.long())  # (B, R, 5)
        num_fg = fg_mask.sum().to(torch.float32).clamp(min=1.0)

        gt_xcycwh = convert_boxes(matched[..., :4], "xyxy", "xcycwh")
        loss_iou = (
            torch.sum(iou_loss(pred_xcycwh, gt_xcycwh, box_mode="xcycwh", loss_type="square_iou")
                      * fg_mask) / num_fg * 5.0
        )
        loss_obj = torch.sum(binary_cross_entropy(obj_logits, fg_mask.to(obj_logits.dtype))) / num_fg
        labels0 = (matched[..., 4].to(torch.int32) - 1).clamp(0, C - 1).long()
        cls_target = F.one_hot(labels0, C).to(cls_logits.dtype) * pred_iou[..., None]
        loss_cls = torch.sum(
            binary_cross_entropy(cls_logits, cls_target) * fg_mask[..., None]
        ) / num_fg

        if self.use_l1:
            cx_t = ((matched[..., 0] + matched[..., 2]) * 0.5 - anchors[None, :, 0]) / strides_vec
            cy_t = ((matched[..., 1] + matched[..., 3]) * 0.5 - anchors[None, :, 1]) / strides_vec
            w_t = torch.log((matched[..., 2] - matched[..., 0]).clamp(min=1e-8) / strides_vec)
            h_t = torch.log((matched[..., 3] - matched[..., 1]).clamp(min=1e-8) / strides_vec)
            l1_target = torch.stack([cx_t, cy_t, w_t, h_t], dim=-1)
            loss_l1 = torch.sum(
                smooth_l1_loss(raw_offsets, l1_target, beta=0.0) * fg_mask[..., None]
            ) / num_fg
        else:
            loss_l1 = torch.zeros((), device=self.device)

        total = loss_iou + loss_obj + loss_cls + loss_l1
        return total, {"total_loss": total, "iou_loss": loss_iou, "obj_loss": loss_obj,
                       "cls_loss": loss_cls, "l1_loss": loss_l1}

    # -- eval -----------------------------------------------------------------------
    def post_process(
        self,
        logits_l: List[torch.Tensor],
        offsets_l: List[torch.Tensor],
        objs_l: List[torch.Tensor],
        img_info: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        """Head outputs (NCHW per level) → decoded, top-k per level,
        class-aware NMS, rescaled detections."""
        test_cfg = self.cfg.TEST
        C = self.num_classes
        feat_sizes = [tuple(x.shape[2:]) for x in logits_l]
        grids_l, strides_l = self.point_gen(feat_sizes, img_info.device)
        cand_boxes, cand_scores, cand_labels = [], [], []
        for logits, offsets, obj, grid, stride in zip(
            logits_l, offsets_l, objs_l, grids_l, self.strides
        ):
            logits, offsets, obj = _flatten_level(logits, C), _flatten_level(offsets, 4), _flatten_level(obj, 1)
            score = torch.sqrt(torch.sigmoid(logits) * torch.sigmoid(obj)).flatten(1)  # (B, R_l*C)
            xy = offsets[..., :2] * stride + grid
            wh = torch.exp(offsets[..., 2:4]) * stride
            boxes = convert_boxes(torch.cat([xy, wh], dim=-1), "xcycwh", "xyxy")
            top_scores, top_idx = topk_scores(score, min(1000, score.shape[1]))
            cand_boxes.append(gather_rows(boxes, top_idx // C))
            cand_scores.append(torch.where(top_scores > test_cfg.CLS_THRESHOLD, top_scores, NEG_INF))
            cand_labels.append(top_idx % C)
        boxes, scores, labels, valid = post_processing(
            torch.cat(cand_boxes, dim=1), torch.cat(cand_scores, dim=1),
            torch.cat(cand_labels, dim=1), img_info,
            iou_threshold=test_cfg.IOU_THRESHOLD, max_detections=test_cfg.MAX_BOXES_PER_IMAGE,
        )
        return {"boxes": boxes, "box_scores": scores, "box_labels": labels, "valid": valid}

    @torch.inference_mode()
    def inference(self, batch):
        inputs = self.pre_process(batch)
        logits_l, offsets_l, objs_l = self.module(inputs["image"])
        return self.post_process(logits_l, offsets_l, objs_l, inputs["img_info"])
