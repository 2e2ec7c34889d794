"""DETR in PyTorch (counterpart of ``basedet_tpu/models/det/detr.py``).

ResNet ``res5`` (``make_backbone``; FrozenBN and ``FREEZE_AT`` 2 in the
config; or an ``hf_<preset>`` backbone, whose width ``feature_channels``
gives) → ``input_proj`` (1x1 conv to the transformer width) → the
transformer with the sine (or learned) position embedding of the pixel mask
downsampled to the feature grid → per decoder layer ``class_embed`` logits
(C + 1, the last the background) and ``bbox_embed`` boxes (sigmoid,
normalised xcycwh). The pixel mask (B, H, W), 1 = valid, comes from the
batch (the DETR collator's ``mask``) or from ``im_info`` where the batch has
none.

Training: every (decoder layer, image) problem matched at once by the auction
(``hungarian_match_owner``) on the cost ``SET_WEIGHT_CLASS``·(-p(class)) +
``SET_WEIGHT_BBOX``·L1 + ``SET_WEIGHT_GIOU``·(-GIoU), detached, as the JAX
package vmaps it over layers and images; then per layer the cross-entropy
with the background weighted by ``EOS_COEF``, and the L1 and GIoU losses
over the matched pairs, divided by the batch's valid target count. The total
sums every layer's (with ``AUX_LOSS``); the reported losses are the last
layer's. Dropout draws from a generator seeded by (``cfg.SEED`` or 42, the
step) (``draws_per_step``), as Faster R-CNN's sampling.

Inference: the last layer's softmax without the background, its max and the
first class that reaches it, the boxes scaled to the original image and
clipped. No NMS, and no kernel on either path.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.layers.backbone.build import feature_channels, make_backbone
from basedet_tpu_torch.layers.blocks.transformer import (MLP, LearnedPositionEmbedding, Transformer,
                                                         sine_position_embedding)
from basedet_tpu_torch.layers.common.blocks import FrozenBatchNorm
from basedet_tpu_torch.layers.common.function import first_argmax, full_f32
from basedet_tpu_torch.layers.common.matcher import hungarian_match_owner
from basedet_tpu_torch.layers.common.pre_processing import to_device
from basedet_tpu_torch.layers.common.sampling import step_generator
from basedet_tpu_torch.layers.losses import iou_loss
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.parallel import global_normaliser
from basedet_tpu_torch.structures import convert_boxes
from basedet_tpu_torch.structures.box_ops import clip_boxes
from basedet_tpu_torch.utils.registry import registers


class DETRModule(nn.Module):
    """``bottom_up``, ``input_proj``, ``query_embed``, ``pos_embed`` (learned
    embedding only), ``transformer``, ``class_embed`` and ``bbox_embed``: the
    flax names."""

    def __init__(self, cfg, device=None):
        super().__init__()
        m = cfg.MODEL
        t = m.TRANSFORMER
        dim = t.DIM
        self.bottom_up = make_backbone(m.BACKBONE.NAME, ("res5",), m.BACKBONE.NORM, m.BACKBONE.FREEZE_AT,
                                       device=device)
        self.input_proj = nn.Conv2d(feature_channels(m.BACKBONE.NAME)["res5"], dim, 1, device=device)
        self.query_embed = nn.Parameter(torch.empty(m.NUM_QUERIES, dim, device=device))
        self.sine = m.POS_EMBED == "sine"
        if not self.sine:
            self.pos_embed = LearnedPositionEmbedding(dim // 2, device=device)
        self.transformer = Transformer(dim, t.NUM_HEADS, t.NUM_ENCODERS, t.NUM_DECODERS, t.DIM_FFN, t.DROPOUT,
                                       t.PRE_NORM, return_intermediate_dec=True, device=device)
        self.class_embed = nn.Linear(dim, cfg.DATA.NUM_CLASSES + 1, device=device)
        self.bbox_embed = MLP(dim, dim, 4, 3, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the flax initialisers draw them (normal in place of truncated
        normal): conv and dense kernels lecun-normal, biases 0, frozen and
        trainable BN and LayerNorm the identity, ``query_embed`` normal(1),
        the learned embeddings uniform in [0, 1)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.weight[0].numel()), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0), m.bias.zero_(), m.running_mean.zero_(), m.running_var.fill_(1.0)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, LearnedPositionEmbedding):
                m.row_embed.uniform_(0.0, 1.0, generator=generator)
                m.col_embed.uniform_(0.0, 1.0, generator=generator)
        self.query_embed.normal_(0.0, 1.0, generator=generator)
        if hasattr(self.bottom_up, "init_weights"):  # the HF zoo draws as its Flax modules do
            self.bottom_up.init_weights(generator)

    def features(self, image: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """image (B, 3, H, W), mask (B, H, W) 1 = valid → the projected
        ``res5`` as a sequence (B, L, D), its key padding (B, L) True =
        padding, and the position embedding (B, L, D), in (h, w) order."""
        src = self.bottom_up(image)["res5"]
        B, _, H, W = src.shape
        fh, fw = image.shape[2] // H, image.shape[3] // W
        feat_mask = mask[:, ::fh, ::fw][:, :H, :W] < 0.5
        pos = sine_position_embedding(feat_mask, self.query_embed.shape[1] // 2) if self.sine \
            else self.pos_embed(feat_mask)
        proj = precision.promoted(self.input_proj, src)  # a plain nn.Conv: f32 from a bf16 backbone
        D = proj.shape[1]
        return proj.permute(0, 2, 3, 1).reshape(B, H * W, D), feat_mask.reshape(B, H * W), pos.reshape(B, H * W, D)

    def heads(self, hs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(layers, B, Q, D) → logits (layers, B, Q, C + 1), boxes (layers, B, Q, 4)."""
        return self.class_embed(hs), torch.sigmoid(self.bbox_embed(hs))

    @full_f32()
    def forward(self, image: torch.Tensor, mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        src, key_padding, pos = self.features(image, mask)
        hs, _ = self.transformer(src, key_padding, self.query_embed, pos, generator)
        return self.heads(hs)


@registers.models.register()
class DETR(BaseNet):
    draws_per_step = True

    def __init__(self, cfg, device, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device)
        module = DETRModule(cfg, device="meta")
        self.module = module.to_empty(device=self.device).eval()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.module.init_weights(generator)

    def prepare(self, batch: Dict[str, Any], train: bool = False) -> Dict[str, torch.Tensor]:
        """``pre_process`` and the pixel mask (B, H, W) f32 at the padded
        input's size: the batch's ``mask`` (uint8 from the collator, padded
        with 0 past its edge), or 1 inside each image's ``im_info`` size."""
        inputs = self.pre_process(batch, train=train)
        B, _, H, W = inputs["image"].shape
        if "mask" in batch:
            mask = to_device(batch["mask"], self.device, torch.float32)
            inputs["mask"] = F.pad(mask, (0, W - mask.shape[2], 0, H - mask.shape[1]))
        else:
            info = inputs["img_info"]
            ys = torch.arange(H, device=self.device)[None, :, None]
            xs = torch.arange(W, device=self.device)[None, None, :]
            inputs["mask"] = ((ys < info[:, 0, None, None]) & (xs < info[:, 1, None, None])).to(torch.float32)
        return inputs

    def targets(self, gt: torch.Tensor, info: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """gt (B, K, 5), im_info → normalised xcycwh boxes (B, K, 4), 0-based
        classes (B, K), validity (B, K) (within ``num_inst`` and of positive
        size), and the valid count over the global batch (at least 1) as this
        rank's share of it (``parallel.global_normaliser``)."""
        K = gt.shape[1]
        wh = torch.stack([info[:, 1], info[:, 0]], dim=-1)
        tgt_xyxy = gt[..., :4] / torch.cat([wh, wh], dim=-1)[:, None, :]
        tgt_boxes = convert_boxes(tgt_xyxy, "xyxy", "xcycwh")
        tgt_cls = (gt[..., 4].to(torch.int32) - 1).clamp(0, self.num_classes - 1).long()
        tgt_valid = ((torch.arange(K, device=gt.device)[None] < info[:, 4:5].to(torch.int32))
                     & (tgt_xyxy[..., 2] > tgt_xyxy[..., 0]) & (tgt_xyxy[..., 3] > tgt_xyxy[..., 1]))
        num_boxes = global_normaliser(tgt_valid.sum(), 1.0)
        return tgt_boxes, tgt_cls, tgt_valid, num_boxes

    def matching_cost(self, logits: torch.Tensor, coords: torch.Tensor, tgt_boxes: torch.Tensor,
                      tgt_cls: torch.Tensor) -> torch.Tensor:
        """logits (P, Q, C + 1), coords (P, Q, 4), targets (P, K, ...) → the
        cost (P, Q, K) of ``_match_single``."""
        m = self.cfg.MODEL.MATCHER
        probs = torch.softmax(logits, dim=-1)
        P, Q, K = probs.shape[0], probs.shape[1], tgt_cls.shape[1]
        cost_class = -torch.gather(probs, 2, tgt_cls[:, None, :].expand(P, Q, K))
        cost_bbox = (coords[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(dim=-1)
        giou = -(iou_loss(coords[:, :, None, :].expand(P, Q, K, 4), tgt_boxes[:, None, :, :].expand(P, Q, K, 4),
                          box_mode="xcycwh", loss_type="giou") - 1.0)
        return m.SET_WEIGHT_CLASS * cost_class + m.SET_WEIGHT_BBOX * cost_bbox + m.SET_WEIGHT_GIOU * (-giou)

    @torch.no_grad()
    def match(self, logits_all: torch.Tensor, coords_all: torch.Tensor, tgt_boxes: torch.Tensor,
              tgt_cls: torch.Tensor, tgt_valid: torch.Tensor) -> torch.Tensor:
        """Every (layer, image) problem through one batched auction:
        (layers, B, Q, ·) outputs and (B, K) targets → owners (layers, B, K),
        the query of each valid target, -2 for an invalid one."""
        L, B = logits_all.shape[:2]
        flat = lambda t: t.expand(L, *t.shape).reshape(L * B, *t.shape[1:])
        cost = self.matching_cost(logits_all.reshape(L * B, *logits_all.shape[2:]),
                                  coords_all.reshape(L * B, *coords_all.shape[2:]), flat(tgt_boxes), flat(tgt_cls))
        return hungarian_match_owner(cost, flat(tgt_valid)).reshape(L, B, -1)

    def layer_losses(self, logits_all, coords_all, owner, tgt_boxes, tgt_cls, tgt_valid,
                     num_boxes) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The three losses of every decoder layer, each (layers,)."""
        L, B, Q = logits_all.shape[:3]
        C = self.num_classes
        K = owner.shape[2]
        pair = tgt_valid & (owner >= 0)
        safe_owner = torch.where(pair, owner, Q)
        target_classes = torch.full((L, B, Q + 1), C, dtype=torch.long, device=owner.device)
        target_classes = target_classes.scatter(2, safe_owner, tgt_cls.expand(L, B, K))[..., :Q]
        eos = self.cfg.LOSSES.EOS_COEF
        weight = torch.cat([torch.ones(C, device=owner.device), torch.full((1,), float(eos), device=owner.device)])
        nll = -torch.gather(F.log_softmax(logits_all, dim=-1), 3, target_classes[..., None])[..., 0]
        w = weight[target_classes]
        loss_ce = (nll * w).sum(dim=(1, 2)) / global_normaliser(w.sum(dim=(1, 2)), 1e-12)
        matched = torch.gather(coords_all, 2, safe_owner.clamp(0, Q - 1)[..., None].expand(L, B, K, 4))
        pair = pair.to(torch.float32)
        loss_bbox = ((matched - tgt_boxes).abs() * pair[..., None]).sum(dim=(1, 2, 3)) / num_boxes
        loss_giou = (iou_loss(matched, tgt_boxes.expand(L, B, K, 4), box_mode="xcycwh", loss_type="giou")
                     * pair).sum(dim=(1, 2)) / num_boxes
        return loss_ce, loss_bbox, loss_giou

    def losses(self, logits_all: torch.Tensor, coords_all: torch.Tensor, gt: torch.Tensor,
               info: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The decoder's outputs and the batch's gts → {loss_ce, loss_bbox,
        loss_giou (the last layer's), total_loss (every layer's with
        AUX_LOSS)}."""
        lcfg = self.cfg.LOSSES
        if not lcfg.AUX_LOSS:
            logits_all, coords_all = logits_all[-1:], coords_all[-1:]
        tgt_boxes, tgt_cls, tgt_valid, num_boxes = self.targets(gt, info)
        owner = self.match(logits_all.detach(), coords_all.detach(), tgt_boxes, tgt_cls, tgt_valid)
        ce, bbox, giou = self.layer_losses(logits_all, coords_all, owner, tgt_boxes, tgt_cls, tgt_valid, num_boxes)
        total = torch.sum(lcfg.CE_LOSS_COEF * ce + lcfg.BBOX_LOSS_COEF * bbox + lcfg.GIOU_LOSS_COEF * giou)
        return {"loss_ce": ce[-1], "loss_bbox": bbox[-1], "loss_giou": giou[-1], "total_loss": total}

    def dropout_generator(self, seed: int, step: int) -> Optional[torch.Generator]:
        """The step's dropout generator in train mode with dropout, else None."""
        if self.module.training and self.cfg.MODEL.TRANSFORMER.DROPOUT > 0:
            return step_generator(seed, step, self.device)
        return None

    def get_losses(self, batch, seed: int = 42, step: int = 0):
        """batch → (total, {loss_ce, loss_bbox, loss_giou, total_loss}), its
        dropout drawn from (seed, step)."""
        inputs = self.prepare(batch, train=True)
        logits_all, coords_all = self.module(inputs["image"], inputs["mask"], self.dropout_generator(seed, step))
        losses = self.losses(logits_all, coords_all, inputs["gt_boxes"], inputs["img_info"])
        return losses["total_loss"], losses

    def post_process(self, logits: torch.Tensor, coords: torch.Tensor, info: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The last layer's logits (B, Q, C + 1) and boxes → detections in
        original-image coordinates, one per query."""
        prob = torch.softmax(logits, dim=-1)[..., :-1]
        scores = prob.amax(dim=-1)
        labels = first_argmax(prob, dim=-1)
        scale = torch.stack([info[:, 3], info[:, 2], info[:, 3], info[:, 2]], dim=-1)[:, None, :]
        boxes = clip_boxes(convert_boxes(coords, "xcycwh", "xyxy") * scale, info[:, 2], info[:, 3])
        return {"boxes": boxes, "box_scores": scores, "box_labels": labels,
                "valid": scores > self.cfg.TEST.get("CLS_THRESHOLD", 0.0)}

    @torch.inference_mode()
    def inference(self, batch):
        inputs = self.prepare(batch)
        logits_all, coords_all = self.module(inputs["image"], inputs["mask"])
        return self.post_process(logits_all[-1], coords_all[-1], inputs["img_info"])
