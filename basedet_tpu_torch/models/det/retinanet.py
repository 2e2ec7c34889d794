"""RetinaNet in PyTorch (counterpart of ``basedet_tpu/models/det/retinanet.py``).

ResNet (FrozenBN, ``FREEZE_AT`` 2) → FPN P3-P5 with the ``p6p7`` top block
on ``res5`` → the RetinaNet head shared over P3-P7 → per level logits
(N, H·W·A, C) and offsets (N, H·W·A, 4) in the anchor generator's order:
grid-major, anchor-minor. ``MODEL.BACKBONE.NAME`` may name any backbone of
``layers/backbone/build.py`` (``darknet21``/``53`` or ``csp_darknet`` with
their ``dark*`` features, ``FPN.TOP_BLOCK_IN_FEATURE`` naming one of them;
``hf_<preset>`` with ``res3``-``res5``, as ``auto_convert_cfg_to_hf`` writes),
whose widths ``feature_channels`` gives the FPN, as in the JAX package;
FCOS, ATSS, OTA and FreeAnchor build this module too.

Training: every anchor of every level against the padded gts through the
pairwise-IoU kernel (``ops/iou_kernel.py``), the IoU ``Matcher`` with
low-quality matches, the matched gt's class and ``BoxCoder`` offsets
(zero off the foreground); the focal loss over the anchors that are not
ignored and the L1 loss over the foreground, each divided by the batch's
foreground count (at least 1). Targets are computed without gradient.

Inference, per image and level: the top 1000 of the sigmoid scores over
(anchor, class) by a stable sort (ties to the lower index, as
``lax.top_k``), scores at or below ``TEST.CLS_THRESHOLD`` masked to
``NEG_INF``, decoded; the candidates of all levels go through class-aware
NMS (the NMS kernel) and are rescaled to the original image.

The batch is written out where the JAX package vmaps over images. Nothing
is sampled (``draws_per_step`` False). Under the bf16 policy (``--amp``) the
network runs in bf16 and ``_flatten_level`` casts its outputs to f32: the
assignment (its IoU through kernel #10) and the losses run in f32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from basedet_tpu_torch.layers.backbone.build import feature_channels, make_backbone
from basedet_tpu_torch.layers.backbone.fpn import FPN
from basedet_tpu_torch.layers.common.anchor_generator import DefaultAnchorGenerator
from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm
from basedet_tpu_torch.layers.common.function import full_f32, topk_scores
from basedet_tpu_torch.layers.common.matcher import Matcher
from basedet_tpu_torch.layers.common.post_processing import post_processing
from basedet_tpu_torch.layers.head.retina_head import RetinaNetHead
from basedet_tpu_torch.layers.losses import sigmoid_focal_loss, smooth_l1_loss
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.ops.iou_kernel import box_iou
from basedet_tpu_torch.ops.nms import NEG_INF, gather_rows
from basedet_tpu_torch.parallel import global_normaliser
from basedet_tpu_torch.structures import BoxCoder
from basedet_tpu_torch.utils.registry import registers


class RetinaNetModule(nn.Module):
    """``bottom_up`` → ``fpn`` → ``head``, the flax names. ``forward`` gives the
    head's per-level NCHW outputs (logits (N, A·C, H, W), offsets (N, A·4, H,
    W)) in IEEE f32 whatever TF32 setting the process has (a backward outside
    the train step needs its own ``full_f32``)."""

    def __init__(self, cfg, num_anchors: int, device=None):
        super().__init__()
        m = cfg.MODEL
        out_features = tuple(m.BACKBONE.OUT_FEATURES)
        channels = feature_channels(m.BACKBONE.NAME)
        self.bottom_up = make_backbone(m.BACKBONE.NAME, out_features, m.BACKBONE.NORM,
                                       m.BACKBONE.FREEZE_AT, device=device)
        self.fpn = FPN(out_features, [channels[f] for f in out_features], m.FPN.STRIDES[:3],
                       m.FPN.OUT_CHANNELS, m.FPN.NORM, top_block="p6p7",
                       top_block_in_feature=m.FPN.TOP_BLOCK_IN_FEATURE, device=device)
        self.level_names = [f"p{int(math.log2(s))}" for s in m.FPN.STRIDES]
        self.head = self.make_head(cfg, num_anchors, device)

    def make_head(self, cfg, num_anchors: int, device) -> nn.Module:
        m = cfg.MODEL
        return RetinaNetHead(m.FPN.OUT_CHANNELS, num_anchors, cfg.DATA.NUM_CLASSES, len(self.level_names),
                             m.HEAD.NUM_CONVS, m.HEAD.CLS_PRIOR_PROB, m.HEAD.get("SHARE_PARAM", True),
                             device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the flax initialisers draw them (normal in place of truncated
        normal): backbone convs lecun-normal, frozen and trainable BN the
        identity, FPN convs He-normal (fan in) with zero biases, the head
        normal(0.01) with the class bias at the prior."""
        if hasattr(self.bottom_up, "init_weights"):  # the HF zoo draws as its Flax modules do
            self.bottom_up.init_weights(generator)
        else:
            for m in self.bottom_up.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, math.sqrt(1.0 / m.weight[0].numel()), generator=generator)
                elif isinstance(m, FrozenBatchNorm):
                    m.weight.fill_(1.0), m.bias.zero_(), m.running_mean.zero_(), m.running_var.fill_(1.0)
                elif isinstance(m, nn.BatchNorm2d):  # NORM "BN"
                    m.reset_parameters()
        for m in self.fpn.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, math.sqrt(2.0 / m.weight[0].numel()), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        self.fpn.reset_norms()
        self.head.init_weights(generator)

    def features(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image (B, 3, H, W) → the pyramid levels P3-P7, (B, C, H_l, W_l) each."""
        feats = self.fpn(self.bottom_up(image))
        return [feats[n] for n in self.level_names]

    @full_f32()
    def forward(self, image: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        return self.head(self.features(image))


def _flatten_level(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, A·k, H, W) → (N, H·W·A, k) in the anchor generator's order (grid-major,
    anchor-minor), in f32."""
    n, ak, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w * (ak // k), k).float()


@registers.models.register()
class RetinaNet(BaseNet):
    def __init__(self, cfg, device, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device)
        m = cfg.MODEL
        self.anchor_gen = DefaultAnchorGenerator(
            tuple(map(tuple, m.ANCHOR.SCALES)), tuple(map(tuple, m.ANCHOR.RATIOS)),
            tuple(m.FPN.STRIDES), m.ANCHOR.OFFSET)
        self.box_coder = BoxCoder(tuple(m.BOX_REG.MEAN), tuple(m.BOX_REG.STD))
        self.matcher = Matcher(tuple(m.MATCHER.THRESHOLDS), tuple(m.MATCHER.LABELS),
                               m.MATCHER.ALLOW_LOW_QUALITY)
        self._anchors: Dict[tuple, List[torch.Tensor]] = {}
        module = RetinaNetModule(cfg, self.anchor_gen.num_anchors, device="meta")
        self.module = module.to_empty(device=self.device).eval()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.module.init_weights(generator)

    def anchors(self, head_out: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per level (H·W·A, 4) anchors for the sizes of these (N, ·, H, W) head
        outputs, made once per size and device."""
        key = (tuple(tuple(x.shape[-2:]) for x in head_out), head_out[0].device)
        if key not in self._anchors:
            self._anchors[key] = self.anchor_gen(list(key[0]), key[1])
        return self._anchors[key]

    def flatten(self, logits_l: List[torch.Tensor], offsets_l: List[torch.Tensor]):
        """Per level NCHW head outputs → per level (B, R_l, C) logits and (B, R_l,
        4) offsets."""
        return ([_flatten_level(x, self.num_classes) for x in logits_l],
                [_flatten_level(x, 4) for x in offsets_l])

    @torch.no_grad()
    def ground_truth(self, anchors: torch.Tensor, gt_boxes: torch.Tensor,
                     num_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """anchors (R, 4), gt_boxes (B, K, 5) padded, num_valid (B,) → labels
        (B, R) int64 (-1 ignored, 0 background, else the 1-based class) and
        offsets (B, R, 4), zero off the foreground (``_assign_single``,
        batched). The (B, K, R) IoU goes through the kernel on the card."""
        K = gt_boxes.shape[1]
        gt_valid = torch.arange(K, device=gt_boxes.device)[None, :] < num_valid[:, None]
        overlaps = box_iou(gt_boxes[..., :4].contiguous(), anchors)
        match_idx, labels = self.matcher(overlaps, gt_valid)
        matched = gather_rows(gt_boxes, match_idx)
        fg = labels == 1
        labels = torch.where(fg, matched[..., 4].to(torch.int64), labels)
        offsets = self.box_coder.encode(anchors[None], matched[..., :4])
        return labels, torch.where(fg[..., None], offsets, 0.0)

    def losses(self, logits: torch.Tensor, offsets: torch.Tensor, labels: torch.Tensor,
               gt_offsets: torch.Tensor) -> Dict[str, torch.Tensor]:
        """logits (B, R, C), offsets (B, R, 4) of every level, and their
        ground truth → the focal loss over the anchors not ignored and the L1
        loss over the foreground, each over the batch's foreground count."""
        valid = labels >= 0
        fg = labels > 0
        num_fg = global_normaliser(fg.sum(), 1.0)
        classes = torch.arange(1, self.num_classes + 1, device=labels.device)
        targets = ((labels[..., None] == classes) & fg[..., None]).to(logits.dtype)
        lcfg = self.cfg.MODEL.LOSSES
        cls_loss = (sigmoid_focal_loss(logits, targets, alpha=lcfg.FOCAL_LOSS_ALPHA,
                                       gamma=lcfg.FOCAL_LOSS_GAMMA) * valid[..., None]).sum() / num_fg
        reg_loss = ((smooth_l1_loss(offsets, gt_offsets, beta=lcfg.SMOOTH_L1_BETA) * fg[..., None]).sum()
                    / num_fg * lcfg.REG_LOSS_WEIGHT)
        total = cls_loss + reg_loss
        return {"total_loss": total, "cls_loss": cls_loss, "reg_loss": reg_loss}

    def get_losses(self, batch):
        """→ (total, {total_loss, cls_loss, reg_loss}), differentiable in the
        trainable parameters."""
        inputs = self.pre_process(batch, train=True)
        logits_l, offsets_l = self.module(inputs["image"])
        anchors = torch.cat(self.anchors(logits_l), dim=0)
        logits, offsets = (torch.cat(x, dim=1) for x in self.flatten(logits_l, offsets_l))
        labels, gt_offsets = self.ground_truth(anchors, inputs["gt_boxes"],
                                               inputs["img_info"][:, 4].to(torch.int64))
        losses = self.losses(logits, offsets, labels, gt_offsets)
        return losses["total_loss"], losses

    def candidates(self, logits_l: List[torch.Tensor], offsets_l: List[torch.Tensor],
                   anchors_l: List[torch.Tensor]):
        """Per level (B, R_l, C) logits, (B, R_l, 4) offsets and (R_l, 4) anchors
        → the top 1000 (anchor, class) pairs of each level and image: decoded
        boxes (B, P, 4), scores (B, P) with those at or below the threshold at
        ``NEG_INF``, labels (B, P)."""
        thresh = self.cfg.TEST.CLS_THRESHOLD
        boxes, scores, labels = [], [], []
        for logits, offsets, anchors in zip(logits_l, offsets_l, anchors_l):
            B, R, C = logits.shape
            top_scores, top_idx = topk_scores(torch.sigmoid(logits).reshape(B, -1), min(1000, R * C))
            anchor_idx = top_idx // C
            boxes.append(self.box_coder.decode(anchors[anchor_idx], gather_rows(offsets, anchor_idx)))
            scores.append(torch.where(top_scores > thresh, top_scores, NEG_INF))
            labels.append(top_idx % C)
        return torch.cat(boxes, dim=1), torch.cat(scores, dim=1), torch.cat(labels, dim=1)

    def post_process(self, logits_l: List[torch.Tensor], offsets_l: List[torch.Tensor],
                     img_info: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The module's NCHW head outputs → padded detections in original-image
        coordinates: candidates, class-aware NMS, rescale and clip."""
        anchors = self.anchors(logits_l)
        boxes, scores, labels = self.candidates(*self.flatten(logits_l, offsets_l), anchors)
        test_cfg = self.cfg.TEST
        out_boxes, out_scores, out_labels, valid = post_processing(
            boxes, scores, labels, img_info, iou_threshold=test_cfg.IOU_THRESHOLD,
            max_detections=test_cfg.MAX_BOXES_PER_IMAGE)
        return {"boxes": out_boxes, "box_scores": out_scores, "box_labels": out_labels, "valid": valid}

    @torch.inference_mode()
    def inference(self, batch):
        inputs = self.pre_process(batch)
        return self.post_process(*self.module(inputs["image"]), inputs["img_info"])
