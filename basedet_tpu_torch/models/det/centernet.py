"""CenterNet in PyTorch (counterpart of ``basedet_tpu/models/det/centernet.py``).

ResNet (train-mode BN, ``FREEZE_AT`` 0) → ``res5`` → three DCNv2 + 4x4
deconvolution stages to stride 4 (the DCN's input gradient through the
row-scatter kernel) → ``cls`` (sigmoid), ``wh`` and ``reg`` heads.

Training builds its targets inside the model (``centernet_targets``: a
gaussian per gt box, scatter-maxed into its class's map), so that the
synthetic loader can train it, then the modified focal loss and the L1 size
and offset losses at the gt centres. Inference keeps the peaks of a 3x3
max-pool, the top ``MAX_BOXES_PER_IMAGE`` scores over the (y, x, c)-major
flatten, decodes and rescales them to the original image. The head outputs
are channels-last, the JAX package's layout, so that the losses and the
decode index them as it does.

Nothing is sampled (``draws_per_step`` False), and the layers have no bf16
path (``follows_compute_policy`` False: ``--amp`` is refused).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers.backbone.build import make_backbone
from basedet_tpu_torch.layers.common.function import full_f32
from basedet_tpu_torch.layers.head.center_head import CenterHead, CenternetDeconv
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.models.cls.resnet import resnet_feature_channels
from basedet_tpu_torch.structures import clip_boxes
from basedet_tpu_torch.utils.registry import registers


def gaussian_radius(w: torch.Tensor, h: torch.Tensor, min_overlap: float = 0.7) -> torch.Tensor:
    """CornerNet's radius, with the reference's mistake in r3 kept for
    parity (``basedet_tpu/models/det/centernet.py::gaussian_radius``)."""
    a1 = 1.0
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp_min(b1 ** 2 - 4 * a1 * c1, 0))) / 2
    a2 = 4.0
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp_min(b2 ** 2 - 4 * a2 * c2, 0))) / 2
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3 ** 2 - 4 * a3 * c3, 0))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


@torch.no_grad()
def centernet_targets(gt: torch.Tensor, num_valid: torch.Tensor, out_hw: Tuple[int, int],
                      num_classes: int, down_scale: float, min_overlap: float):
    """gt (B, K, 5) ``[x1, y1, x2, y2, class]`` (classes 1-based), num_valid
    (B,) → score_map (B, H, W, C), wh (B, K, 2), reg (B, K, 2), mask (B, K)
    f32 and index (B, K) int64, as ``CenterNet._gt_single`` per image. A gt
    row counts when it is one of the first ``num_valid``, has positive size
    and its centre cell (truncated toward zero) lies on the map."""
    H, W = out_hw
    B, K = gt.shape[:2]
    device = gt.device
    valid = torch.arange(K, device=device)[None] < num_valid[:, None]
    boxes = gt[..., :4] * (1.0 / down_scale)
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    valid &= (w > 0) & (h > 0)
    cls = torch.clamp(gt[..., 4].to(torch.int32) - 1, 0, num_classes - 1).to(torch.int64)

    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    cxi = cx.to(torch.int32)
    cyi = cy.to(torch.int32)
    valid &= (cxi >= 0) & (cxi < W) & (cyi >= 0) & (cyi < H)

    index = torch.where(valid, cyi * W + cxi, 0).to(torch.int64)
    fvalid = valid.to(torch.float32)
    reg = torch.stack([cx - cxi, cy - cyi], dim=-1) * fvalid[..., None]
    wh = torch.stack([w, h], dim=-1) * fvalid[..., None]

    radius = torch.clamp_min(torch.floor(gaussian_radius(w, h, min_overlap)), 0.0)
    sigma = (2 * radius + 1) / 6.0
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    dy = ys[None, None] - cyi[..., None, None].to(torch.float32)  # (B, K, H, 1)
    dx = xs[None, None] - cxi[..., None, None].to(torch.float32)  # (B, K, 1, W)
    g = torch.exp(-(dx ** 2 + dy ** 2)
                  / torch.clamp_min(2 * sigma[..., None, None] ** 2, 1e-6))
    r = radius[..., None, None]
    within = (dy.abs() <= r) & (dx.abs() <= r)
    g = torch.where(within & valid[..., None, None], g, 0.0).reshape(B, K, H * W)
    score_map = torch.zeros(B, num_classes, H * W, device=device).scatter_reduce(
        1, cls[..., None].expand(B, K, H * W), g, "amax", include_self=True)
    score_map = score_map.reshape(B, num_classes, H, W).permute(0, 2, 3, 1)
    return score_map, wh, reg, fvalid, index


def focal_loss(pred: torch.Tensor, gtmap: torch.Tensor) -> torch.Tensor:
    """CenterNet's modified focal loss over the (B, H, W, C) maps; a location
    is positive where its target is exactly 1 (a gt centre: exp(0))."""
    p = torch.clamp(pred.float(), 1e-12, 1 - 1e-7)
    pos = (gtmap == 1.0).to(torch.float32)
    neg = 1.0 - pos
    neg_w = (1 - gtmap) ** 4
    pos_loss = torch.sum(torch.log(p) * (1 - p) ** 2 * pos)
    neg_loss = torch.sum(torch.log(1 - p) * p ** 2 * neg_w * neg)
    num_pos = torch.sum(pos)
    return torch.where(num_pos == 0, -neg_loss, -(pos_loss + neg_loss) / torch.clamp_min(num_pos, 1))


def gather_at(featmap: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """featmap (B, H, W, c), index (B, K) flat cells → (B, K, c)."""
    B, c = featmap.shape[0], featmap.shape[-1]
    return torch.gather(featmap.reshape(B, -1, c), 1, index[..., None].expand(-1, -1, c))


class CenterNetModule(nn.Module):
    """``bottom_up`` (ResNet, ``res5``), ``upsample`` (the deconvolution
    stages) and ``head``, the flax names. ``forward`` gives the head maps
    channels-last: cls (B, H, W, C), wh and reg (B, H, W, 2), in IEEE f32
    whatever TF32 setting the process has (a backward outside the train step
    needs its own ``full_f32``)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        m = cfg.MODEL
        channels = list(m.HEAD.DECONV_CHANNEL)
        channels[0] = resnet_feature_channels(m.BACKBONE.NAME)["res5"]
        self.bottom_up = make_backbone(m.BACKBONE.NAME, ("res5",), m.BACKBONE.NORM,
                                       m.BACKBONE.FREEZE_AT, device=device)
        self.upsample = CenternetDeconv(channels, tuple(m.HEAD.DECONV_KERNEL),
                                        m.HEAD.MODULATE_DEFORM, device=device)
        self.head = CenterHead(channels[-1], cfg.DATA.NUM_CLASSES, m.HEAD.CLS_PRIOR_PROB,
                               device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the flax initialisers draw them (normal in place of truncated
        normal): backbone convs lecun-normal, BN the identity, the DCN offset
        branch zero and its mix He-normal, the deconvolutions bilinear, the
        head convs lecun-normal with the class bias at the prior."""
        for m in self.bottom_up.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.weight[0].numel()), generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for stage in self.upsample.stages():
            stage.init_weights(generator)
        for head in (self.head.cls_head, self.head.wh_head, self.head.reg_head):
            head.init_weights(generator)

    def features(self, image: torch.Tensor) -> torch.Tensor:
        return self.bottom_up(image)["res5"]

    def heads(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: v.permute(0, 2, 3, 1) for k, v in self.head(x).items()}

    @full_f32()
    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.heads(self.upsample(self.features(image)))


@registers.models.register()
class CenterNet(BaseNet):
    def __init__(self, cfg, device, generator: torch.Generator = None):
        super().__init__(cfg, device)
        module = CenterNetModule(cfg, device="meta")
        self.module = module.to_empty(device=self.device).eval()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.module.init_weights(generator)

    def losses(self, pred: Dict[str, torch.Tensor], img_info: torch.Tensor,
               gt_boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The head maps of a train-mode forward and the batch's gt → the
        weighted losses and their sum."""
        head = self.cfg.MODEL.HEAD
        score_map, wh_t, reg_t, mask, index = centernet_targets(
            gt_boxes, img_info[:, 4].to(torch.int32), tuple(pred["cls"].shape[1:3]),
            self.num_classes, head.DOWN_SCALE, head.MIN_OVERLAP)
        loss_cls = focal_loss(pred["cls"], score_map)
        norm = torch.sum(mask) * 2 + 1e-4
        loss_wh = torch.sum(torch.abs(gather_at(pred["wh"], index) - wh_t) * mask[..., None]) / norm
        loss_reg = torch.sum(torch.abs(gather_at(pred["reg"], index) - reg_t) * mask[..., None]) / norm
        w = self.cfg.MODEL.LOSS
        loss_cls, loss_wh, loss_reg = (loss_cls * w.CLS_WEIGHT, loss_wh * w.WH_WEIGHT,
                                       loss_reg * w.REG_WEIGHT)
        return {"total_loss": loss_cls + loss_wh + loss_reg, "loss_cls": loss_cls,
                "loss_box_wh": loss_wh, "loss_center_reg": loss_reg}

    def get_losses(self, batch):
        """→ (total, {total_loss, loss_cls, loss_box_wh, loss_center_reg}),
        differentiable in the parameters; the BN running statistics update
        when the module is in train mode."""
        inputs = self.pre_process(batch, train=True)
        losses = self.losses(self.module(inputs["image"]), inputs["img_info"], inputs["gt_boxes"])
        return losses["total_loss"], losses

    def post_process(self, pred: Dict[str, torch.Tensor], img_info: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
        """Peaks of a 3x3 max-pool (by equality), the top
        ``MAX_BOXES_PER_IMAGE`` of the (y, x, c)-major scores (a stable
        descending sort: ties go to the lower index, as ``lax.top_k``),
        decoded, rescaled from the current to the original size and
        clipped."""
        fmap = pred["cls"]
        B, H, W, C = fmap.shape
        fmax = F.max_pool2d(fmap.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
        scores = torch.where(fmax == fmap, fmap, 0.0).reshape(B, -1)
        top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
        D = self.cfg.TEST.MAX_BOXES_PER_IMAGE
        top_scores, top_idx = top_scores[:, :D], top_idx[:, :D]
        cell = top_idx // C
        ys = (cell // W).to(torch.float32)
        xs = (cell % W).to(torch.float32)
        reg = gather_at(pred["reg"], cell)
        size = gather_at(pred["wh"], cell)
        xs = xs + reg[..., 0]
        ys = ys + reg[..., 1]
        boxes = torch.stack([xs - size[..., 0] / 2, ys - size[..., 1] / 2,
                             xs + size[..., 0] / 2, ys + size[..., 1] / 2], dim=-1)
        boxes = boxes * float(self.cfg.MODEL.HEAD.DOWN_SCALE)
        scale_y = img_info[:, 2] / img_info[:, 0]
        scale_x = img_info[:, 3] / img_info[:, 1]
        boxes = boxes * torch.stack([scale_x, scale_y, scale_x, scale_y], dim=-1)[:, None]
        boxes = clip_boxes(boxes, img_info[:, 2], img_info[:, 3])
        valid = top_scores > self.cfg.TEST.get("CLS_THRESHOLD", 0.05)
        return {"boxes": boxes, "box_scores": top_scores, "box_labels": top_idx % C,
                "valid": valid}

    @torch.inference_mode()
    def inference(self, batch):
        inputs = self.pre_process(batch)
        return self.post_process(self.module(inputs["image"]), inputs["img_info"])
