"""Faster R-CNN in PyTorch (counterpart of ``basedet_tpu/models/det/faster_rcnn.py``).

Inference: ResNet + FPN (P2-P6) → RPN head → per-level top-k, decode, clip,
level-wise NMS (the NMS kernel) → multilevel RoIAlign over P2-P5 (the
RoIAlign kernel) → 2-FC box predictor → softmax and class-specific decode →
top-2000 → class-aware NMS (the NMS kernel) → rescaled detections.

Training: the same features and RPN head → the anchors' ground truth, sampled,
and the RPN losses → proposals from the detached RPN outputs (NMS kernel, no
gradient) → sampling of a fixed number of RoIs from proposals and gt boxes →
multilevel RoIAlign (forward kernel, and on the way back the backward kernel)
→ box predictor → R-CNN losses. Targets and proposals are computed without
gradient. The sampling noise is an argument (``layers/common/sampling.py``).

The batch is written out where the JAX package vmaps over images.
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
from basedet_tpu_torch.layers.common.matcher import Matcher
from basedet_tpu_torch.layers.common.post_processing import post_processing
from basedet_tpu_torch.layers.common.sampling import draw_sampling_noise
from basedet_tpu_torch.layers.head.rcnn import RCNNPredictor, rcnn_losses, rcnn_sample
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.models.cls.resnet import resnet_feature_channels
from basedet_tpu_torch.models.det.rpn import (
    RPNHead,
    find_top_proposals,
    rpn_ground_truth,
    rpn_losses,
)
from basedet_tpu_torch.ops.nms import NEG_INF, gather_rows
from basedet_tpu_torch.ops.roi_align_kernel import pool_rois_multilevel
from basedet_tpu_torch.structures import BoxCoder
from basedet_tpu_torch.utils.registry import registers


class FasterRCNNModule(nn.Module):
    """The JAX package's ``FasterRCNNModule``, split into its stages so that
    each can be run and timed alone and fed another run's inputs:
    ``features``, ``proposals``, ``pool`` and ``box_head``, which ``forward``
    runs for inference, and ``rpn_targets``, ``rpn_loss``, ``sample`` and
    ``head_losses``, which ``losses`` runs with them for training. The frozen
    BN and the frozen stages stay frozen in train mode."""

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
        self.rcnn_cfg = m.RCNN
        self.matcher = Matcher(tuple(m.MATCHER.THRESHOLDS), tuple(m.MATCHER.LABELS),
                               m.MATCHER.ALLOW_LOW_QUALITY)
        self.rpn_beta = m.LOSSES.RPN_SMOOTH_L1_BETA
        self.rcnn_beta = m.LOSSES.RCNN_SMOOTH_L1_BETA
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

    def rpn_head(self, feats: Dict[str, torch.Tensor]):
        """→ per level objectness logits (B, R_l) and offsets (B, R_l, 4)."""
        return self.rpn([feats[n] for n in self.level_names])

    @torch.no_grad()
    def proposals(self, feats: Dict[str, torch.Tensor], img_info: torch.Tensor,
                  train: bool = False, rpn_out=None):
        """RPN head (or its outputs ``rpn_out``, detached here), then top-k,
        decode, clip and NMS per image → (proposals (B, P, 4), valid (B, P)),
        with the train or the test top-k budgets. No gradient: the NMS
        kernel has none, and the JAX package stops it here too."""
        logits_l, offsets_l = self.rpn_head(feats) if rpn_out is None else rpn_out
        r = self.rpn_cfg
        prev_k, post_k = ((r.TRAIN_PREV_NMS_TOPK, r.TRAIN_POST_NMS_TOPK) if train
                          else (r.TEST_PREV_NMS_TOPK, r.TEST_POST_NMS_TOPK))
        proposals, _, valid = find_top_proposals(
            [x.detach() for x in logits_l], [x.detach() for x in offsets_l],
            self.anchors([feats[n] for n in self.level_names]), img_info[:, :2], self.rpn_coder,
            prev_k, post_k, r.NMS_THRESHOLD)
        return proposals, valid

    def rpn_targets(self, feats: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                    num_gt: torch.Tensor, noise_pos: torch.Tensor, noise_neg: torch.Tensor):
        """Labels (B, R) and offsets (B, R, 4) of all anchors of all levels,
        positives and negatives sampled with the two (B, R) noises."""
        r = self.rpn_cfg
        anchors = torch.cat(self.anchors([feats[n] for n in self.level_names]), dim=0)
        return rpn_ground_truth(noise_pos, noise_neg, anchors, gt_boxes, num_gt, self.matcher,
                                self.rpn_coder, r.NUM_SAMPLE_ANCHORS,
                                int(r.POSITIVE_ANCHOR_RATIO * r.NUM_SAMPLE_ANCHORS))

    def rpn_loss(self, rpn_out, labels: torch.Tensor, offsets: torch.Tensor):
        """→ (objectness loss, box loss) of the RPN head's outputs."""
        logits_l, offsets_l = rpn_out
        return rpn_losses(torch.cat(logits_l, dim=1), torch.cat(offsets_l, dim=1), labels, offsets,
                          self.rpn_beta)

    def sample(self, proposals: torch.Tensor, valid: torch.Tensor, gt_boxes: torch.Tensor,
               num_gt: torch.Tensor, noise_fg: torch.Tensor, noise_bg: torch.Tensor,
               noise_tie: torch.Tensor):
        """→ rois (B, N, 4), labels (B, N), targets (B, N, 4), weights (B, N)
        with N = RCNN.NUM_ROIS, from the proposals and the gt boxes."""
        c = self.rcnn_cfg
        return rcnn_sample(noise_fg, noise_bg, noise_tie, proposals, valid, gt_boxes, num_gt,
                           c.NUM_ROIS, c.FG_RATIO, c.FG_THRESHOLD, c.BG_THRESHOLD_HIGH,
                           c.BG_THRESHOLD_LOW, self.rcnn_coder)

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

    def head_losses(self, pooled: torch.Tensor, labels: torch.Tensor, targets: torch.Tensor,
                    weights: torch.Tensor):
        """pooled (B, N, ph, pw, C) and the sampled labels, targets and
        weights → (classification loss, box loss)."""
        logits, deltas = self.rcnn(pooled.flatten(0, 1))
        return rcnn_losses(logits, deltas, labels.flatten(), targets.flatten(0, 1), weights.flatten(),
                           self.rcnn_beta)

    @full_f32()
    def losses(self, image: torch.Tensor, img_info: torch.Tensor, gt_boxes: torch.Tensor,
               noise: Optional[Dict[str, torch.Tensor]] = None, seed: int = 42,
               step: int = 0) -> Dict[str, torch.Tensor]:
        """The train branch: the four losses and their sum. The sampling
        noise is ``noise`` when given (as ``draw_sampling_noise`` returns it
        for this batch's anchors and its proposals plus gt rows), else drawn
        on the image's device from (seed, step)."""
        num_gt = img_info[:, 4].to(torch.int64)
        feats = self.features(image)
        rpn_out = self.rpn_head(feats)
        if noise is None:
            noise = draw_sampling_noise(
                seed, step, image.shape[0], sum(x.shape[1] for x in rpn_out[0]),
                self.rpn_cfg.TRAIN_POST_NMS_TOPK + gt_boxes.shape[1], image.device)
        labels, offsets = self.rpn_targets(feats, gt_boxes, num_gt, noise["rpn_pos"], noise["rpn_neg"])
        rpn_cls, rpn_reg = self.rpn_loss(rpn_out, labels, offsets)
        proposals, valid = self.proposals(feats, img_info, train=True, rpn_out=rpn_out)
        rois, roi_labels, targets, weights = self.sample(
            proposals, valid, gt_boxes, num_gt, noise["rcnn_fg"], noise["rcnn_bg"], noise["rcnn_tie"])
        rcnn_cls, rcnn_reg = self.head_losses(self.pool(feats, rois), roi_labels, targets, weights)
        return {"total_loss": rpn_cls + rpn_reg + rcnn_cls + rcnn_reg, "rpn_cls_loss": rpn_cls,
                "rpn_reg_loss": rpn_reg, "rcnn_cls_loss": rcnn_cls, "rcnn_reg_loss": rcnn_reg}

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

    draws_per_step = True

    def get_losses(self, batch, noise: Optional[Dict[str, torch.Tensor]] = None, seed: int = 42,
                   step: int = 0):
        """→ (total, {total_loss, rpn_cls_loss, rpn_reg_loss, rcnn_cls_loss,
        rcnn_reg_loss}), differentiable in the trainable parameters. The
        sampling noise is ``noise`` when given, else drawn from (seed,
        step): see ``FasterRCNNModule.losses``."""
        inputs = self.pre_process(batch, train=True)
        losses = self.module.losses(inputs["image"], inputs["img_info"], inputs["gt_boxes"],
                                    noise, seed, step)
        return losses["total_loss"], losses

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
