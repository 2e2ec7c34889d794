"""Faster R-CNN inference in PyTorch (counterpart of ``basedet_tpu/models/det/faster_rcnn.py``):
ResNet + FPN (P2-P6) → RPN head → per-level top-k, decode, clip, level-wise
NMS (the NMS kernel) → multilevel RoIAlign over P2-P5 (the RoIAlign kernel)
→ 2-FC box predictor → softmax and class-specific decode → top-2000 →
class-aware NMS (the NMS kernel) → rescaled detections. The batch is written
out where the JAX package vmaps over images. Training (RPN and R-CNN ground
truth, sampling, losses) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from basedet_tpu_torch.layers.backbone.build import make_backbone
from basedet_tpu_torch.layers.backbone.fpn import FPN
from basedet_tpu_torch.layers.common.anchor_generator import DefaultAnchorGenerator
from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm
from basedet_tpu_torch.layers.common.function import full_f32, topk_scores
from basedet_tpu_torch.layers.common.post_processing import post_processing
from basedet_tpu_torch.layers.head.rcnn import RCNNPredictor
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.models.cls.resnet import resnet_feature_channels
from basedet_tpu_torch.models.det.rpn import RPNHead, find_top_proposals
from basedet_tpu_torch.ops.nms import NEG_INF, gather_rows
from basedet_tpu_torch.ops.roi_align_kernel import pool_rois_multilevel
from basedet_tpu_torch.structures import BoxCoder
from basedet_tpu_torch.utils.registry import registers


class FasterRCNNModule(nn.Module):
    """The eval branch of the JAX package's ``FasterRCNNModule``, split into
    its stages (``features``, ``proposals``, ``pool``, ``box_head``) so that
    each can be run and timed alone; ``forward`` runs them all."""

    def __init__(self, cfg, device=None):
        super().__init__()
        m = cfg.MODEL
        self.num_classes = cfg.DATA.NUM_CLASSES
        out_features = tuple(m.BACKBONE.OUT_FEATURES)
        channels = resnet_feature_channels(m.BACKBONE.NAME)
        self.bottom_up = make_backbone(m.BACKBONE.NAME, out_features, m.BACKBONE.NORM,
                                       m.BACKBONE.FREEZE_AT, device=device)
        self.fpn = FPN(out_features, [channels[f] for f in out_features],
                       m.FPN.STRIDES[: len(out_features)], m.FPN.OUT_CHANNELS, m.FPN.NORM,
                       device=device)
        self.level_names = [f"p{int(math.log2(s))}" for s in m.FPN.STRIDES]
        self.anchor_gen = DefaultAnchorGenerator(
            tuple(map(tuple, m.ANCHOR.SCALES)), tuple(map(tuple, m.ANCHOR.RATIOS)),
            tuple(m.FPN.STRIDES), m.ANCHOR.OFFSET)
        self._anchors: Dict[tuple, List[torch.Tensor]] = {}
        self.rpn = RPNHead(m.FPN.OUT_CHANNELS, m.RPN.CHANNELS, self.anchor_gen.num_anchors,
                           device=device)
        self.rpn_coder = BoxCoder(tuple(m.RPN_BOX_REG.MEAN), tuple(m.RPN_BOX_REG.STD))
        self.rcnn_coder = BoxCoder(tuple(m.RCNN_BOX_REG.MEAN), tuple(m.RCNN_BOX_REG.STD))
        self.rpn_cfg = m.RPN
        self.pool_features = tuple(m.RCNN.IN_FEATURES)
        self.pool_strides = tuple(m.RCNN.STRIDES)
        self.pool_size = tuple(m.ROI_POOLER.SIZE)
        self.rcnn = RCNNPredictor(self.pool_size[0] * self.pool_size[1] * m.FPN.OUT_CHANNELS,
                                  self.num_classes, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the flax initialisers draw them (normal in place of truncated
        normal): backbone convs lecun-normal, FPN convs He-normal (fan in),
        RPN convs and the fc layers normal(0.01), ``pred_delta`` normal(0.001),
        biases 0, frozen BN the identity."""
        def normal(w, std):
            w.normal_(0.0, std, generator=generator)

        for m in self.bottom_up.modules():
            if isinstance(m, nn.Conv2d):
                normal(m.weight, math.sqrt(1.0 / (m.weight[0].numel())))
            elif isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0), m.bias.zero_(), m.running_mean.zero_(), m.running_var.fill_(1.0)
        for m in self.fpn.modules():
            if isinstance(m, nn.Conv2d):
                normal(m.weight, math.sqrt(2.0 / (m.weight[0].numel())))
        for m in list(self.rpn.modules()) + list(self.rcnn.modules()):
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                normal(m.weight, 0.001 if m is self.rcnn.pred_delta else 0.01)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
                m.bias.zero_()

    def anchors(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per level (H*W*A, 4) anchors for these feature sizes, made once per
        size and device."""
        key = (tuple(tuple(f.shape[-2:]) for f in features), features[0].device)
        if key not in self._anchors:
            self._anchors[key] = self.anchor_gen([k for k in key[0]], key[1])
        return self._anchors[key]

    def features(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image (B, 3, H, W) → FPN levels {p2..p6: (B, C, H_l, W_l)}."""
        return self.fpn(self.bottom_up(image))

    def proposals(self, feats: Dict[str, torch.Tensor], img_info: torch.Tensor):
        """RPN head, then top-k, decode, clip and NMS per image → (proposals
        (B, P, 4), valid (B, P))."""
        features = [feats[n] for n in self.level_names]
        logits_l, offsets_l = self.rpn(features)
        r = self.rpn_cfg
        proposals, _, valid = find_top_proposals(
            logits_l, offsets_l, self.anchors(features), img_info[:, :2], self.rpn_coder,
            r.TEST_PREV_NMS_TOPK, r.TEST_POST_NMS_TOPK, r.NMS_THRESHOLD)
        return proposals, valid

    def pool(self, feats: Dict[str, torch.Tensor], proposals: torch.Tensor) -> torch.Tensor:
        """Multilevel RoIAlign → (B, P, ph, pw, C)."""
        return pool_rois_multilevel([feats[n] for n in self.pool_features], proposals,
                                    self.pool_strides, self.pool_size)

    def box_head(self, pooled: torch.Tensor, proposals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled (B, P, ph, pw, C) → class-specific boxes (B, P, C, 4) and
        foreground scores (B, P, C)."""
        B, P = proposals.shape[:2]
        logits, deltas = self.rcnn(pooled.reshape(B * P, *pooled.shape[2:]))
        scores = torch.softmax(logits, dim=-1)[:, 1:]
        boxes = self.rcnn_coder.decode(proposals.reshape(-1, 4)[:, None, :], deltas)
        return boxes.reshape(B, P, self.num_classes, 4), scores.reshape(B, P, self.num_classes)

    @full_f32()
    def forward(self, image: torch.Tensor, img_info: torch.Tensor):
        """→ (boxes (B, P, C, 4), scores (B, P, C), proposal valid (B, P))."""
        feats = self.features(image)
        proposals, valid = self.proposals(feats, img_info)
        boxes, scores = self.box_head(self.pool(feats, proposals), proposals)
        return boxes, scores, valid


@registers.models.register()
class FasterRCNN(BaseNet):
    def __init__(self, cfg, device, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device)
        module = FasterRCNNModule(cfg, device="meta")
        self.module = module.to_empty(device=self.device).eval()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.module.init_weights(generator)

    def get_losses(self, batch):
        raise NotImplementedError(
            "Faster R-CNN training is not ported to basedet_tpu_torch yet: it comes with the "
            "next slice (RPN/R-CNN ground truth and losses, RoIAlign backward kernels)")

    def post_process(self, boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                     img_info: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per image: top-2000 of the (proposal, class) scores, the score
        threshold, class-aware NMS, rescale and clip to the original image."""
        test_cfg = self.cfg.TEST
        B, P, C = scores.shape
        flat = torch.where(valid[..., None], scores, 0.0).reshape(B, -1)
        top_scores, top_idx = topk_scores(flat, min(2000, P * C))
        keep = top_scores > test_cfg.get("CLS_THRESHOLD", 0.05)
        out_boxes, out_scores, labels, out_valid = post_processing(
            gather_rows(boxes.reshape(B, -1, 4), top_idx),
            torch.where(keep, top_scores, NEG_INF), top_idx % C, img_info,
            iou_threshold=test_cfg.IOU_THRESHOLD, max_detections=test_cfg.MAX_BOXES_PER_IMAGE)
        return {"boxes": out_boxes, "box_scores": out_scores, "box_labels": labels, "valid": out_valid}

    @torch.inference_mode()
    def inference(self, batch):
        inputs = self.pre_process(batch)
        boxes, scores, valid = self.module(inputs["image"], inputs["img_info"])
        return self.post_process(boxes, scores, valid, inputs["img_info"])
