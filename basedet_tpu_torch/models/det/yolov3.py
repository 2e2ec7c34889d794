"""YOLOv3 in PyTorch (counterpart of ``basedet_tpu/models/det/yolov3.py``).

Darknet-53 (train-mode BN, LeakyReLU 0.1) → ``YOLOFPN`` → three raw
prediction maps, coarse to fine (strides 32, 16, 8), A·(5 + C) channels each
with A = 3 (w, h) anchors a level; a level's predictions flatten to (h, w, a)
order, as the JAX package's ``_flatten_level``.

Training, over the levels concatenated (R rows in all):
  * each valid gt's anchor: the centred (0, 0, w, h) box against the 9
    anchors through the pairwise-IoU kernel (``ops/iou_kernel.py``, kernel
    #10 on the card), the first of the best (``first_argmax``); its level is
    the anchor's;
  * the targets: one batched scatter into the R rows of every level at the
    gt's cell and anchor, ``(gj·W + gi)·A + a`` past the level's first row,
    gts off the grid dropped. Two gts of one image on the same row write the
    same slot: the highest gt index wins, as XLA:CPU's ``.at[].set`` (updates
    in order, the last kept) gives it. Chosen explicitly, through a
    ``scatter_reduce`` of the gt index, because ``index_put_`` on CUDA keeps
    no defined one. The class target is set at (row, class) for every
    writing gt, so colliding gts of other classes both count, as in the JAX
    package;
  * the ignore mask: the decoded boxes of every level, detached, against
    each image's gts through kernel #10 in one call, (B, R, 4) × (B, K, 4)
    in the JAX package's operand order; a row is ignored where its best IoU
    over the valid gts passes ``IGNORE_THRESHOLD``. So a step launches #10
    twice: the anchor match and the ignore mask;
  * the losses over the batch size: BCE-with-logits on x and y and L1 on w
    and h, both weighted by 2 - wh/size²; objectness BCE where positive or
    not ignored; class BCE where positive.

Inference, per level: the decode (the JAX package's fix of the reference's
decode bug kept), a stable top-1000 of conf·cls over (anchor, class)
(``topk_scores``), then class-aware NMS over the three levels' 3000
candidates (the NMS kernel) and the rescale, through ``post_processing``.

Nothing is sampled. Under the bf16 policy (``--amp``) Darknet and the FPN's
ConvBNActs run in bf16 and the prediction convs promote to f32, so the
targets and losses run in f32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from basedet_tpu_torch.layers.backbone.yolo_fpn import YOLOFPN
from basedet_tpu_torch.layers.common.function import first_argmax, full_f32, topk_scores
from basedet_tpu_torch.layers.common.post_processing import post_processing
from basedet_tpu_torch.layers.losses import binary_cross_entropy
from basedet_tpu_torch.models.base_net import BaseNet
from basedet_tpu_torch.models.cls.darknet import DEPTH2BLOCKS, Darknet, darknet_feature_channels
from basedet_tpu_torch.models.det.retinanet import _flatten_level
from basedet_tpu_torch.ops.iou_kernel import box_iou
from basedet_tpu_torch.ops.nms import NEG_INF, gather_rows
from basedet_tpu_torch.structures import convert_boxes
from basedet_tpu_torch.utils.registry import registers


class YOLOv3Module(nn.Module):
    """``bottom_up`` (Darknet) → ``fpn`` (YOLOFPN), the flax names. The
    branches' widths follow Darknet's width (32 in the JAX package)."""

    def __init__(self, num_classes: int = 80, depth: int = 53, width: int = 32,
                 anchors_per_level=(3, 3, 3), device=None):
        super().__init__()
        self.bottom_up = Darknet(depth, width, ("dark3", "dark4", "dark5"), device=device)
        chans = darknet_feature_channels(width)
        mids = [(chans["dark4"], chans["dark5"]), (chans["dark3"], chans["dark4"]),
                (chans["dark2"], chans["dark3"])]
        self.fpn = YOLOFPN([chans["dark3"], chans["dark4"], chans["dark5"]],
                           [a * (5 + num_classes) for a in anchors_per_level], mids, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the flax initialisers draw them (normal in place of truncated
        normal): conv kernels lecun-normal, biases 0, BN the identity."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, math.sqrt(1.0 / m.weight[0].numel()), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    @full_f32()
    def forward(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image (B, 3, H, W) → the raw maps coarse to fine, (B, A·(5+C), H_l, W_l)."""
        feats = self.bottom_up(image)
        return self.fpn([feats["dark3"], feats["dark4"], feats["dark5"]])


def darknet_depth(name: str) -> int:
    """The depth in a ``MODEL.BACKBONE.NAME`` such as ``darknet53``."""
    depth = name[len("darknet"):]
    if not (name.startswith("darknet") and depth.isdigit() and int(depth) in DEPTH2BLOCKS):
        raise NotImplementedError(f"YOLOv3 backbone {name!r}: the port has darknet21 and darknet53")
    return int(depth)


@registers.models.register()
class YOLOv3(BaseNet):
    def __init__(self, cfg, device, generator: Optional[torch.Generator] = None):
        super().__init__(cfg, device)
        m = cfg.MODEL
        self.anchors = torch.tensor(m.ANCHOR.SCALES, dtype=torch.float32)  # (levels, A, 2) wh, coarse to fine
        self.ignore_threshold = m.IGNORE_THRESHOLD
        self.strides = (32, 16, 8)
        self.img_mean = [v * 255.0 for v in m.BACKBONE.IMG_MEAN]
        self.img_std = [v * 255.0 for v in m.BACKBONE.IMG_STD]
        self._grids: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        # the width is a knob of the port (the JAX package's is 32), for small test models
        module = YOLOv3Module(self.num_classes, darknet_depth(m.BACKBONE.NAME), m.BACKBONE.get("OUT_CHANNELS", 32),
                              [len(a) for a in m.ANCHOR.SCALES], device="meta")
        self.module = module.to_empty(device=self.device).eval()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.module.init_weights(generator)

    def grids(self, preds: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Per row of the levels concatenated (R rows, each level in (h, w, a)
        order): grid x and y, anchor w and h, stride, all (R,) f32; made once
        per set of map sizes and device."""
        key = (tuple(tuple(p.shape[-2:]) for p in preds), preds[0].device)
        if key not in self._grids:
            device = key[1]
            cols = [[] for _ in range(5)]
            for (h, w), anchors, stride in zip(key[0], self.anchors, self.strides):
                A = anchors.shape[0]
                gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                                        indexing="ij")
                for col, v in zip(cols, (gx.reshape(-1).repeat_interleave(A), gy.reshape(-1).repeat_interleave(A),
                                         anchors[:, 0].repeat(h * w), anchors[:, 1].repeat(h * w),
                                         torch.full((h * w * A,), float(stride)))):
                    col.append(v)
            self._grids[key] = tuple(torch.cat(c).to(device) for c in cols)
        return self._grids[key]

    def flatten(self, preds: List[torch.Tensor]) -> torch.Tensor:
        """The raw maps → (B, R, 5 + C) over the levels concatenated."""
        return torch.cat([_flatten_level(p, 5 + self.num_classes) for p in preds], dim=1)

    def decode(self, pred: torch.Tensor, grid: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """(B, R, ≥4) raw predictions → xyxy boxes in input pixels."""
        gx, gy, aw, ah, stride = grid
        dec = torch.stack([(torch.sigmoid(pred[..., 0]) + gx) * stride, (torch.sigmoid(pred[..., 1]) + gy) * stride,
                           torch.exp(pred[..., 2]) * aw, torch.exp(pred[..., 3]) * ah], dim=-1)
        return convert_boxes(dec, "xcycwh", "xyxy")

    # -- train ----------------------------------------------------------------------
    @torch.no_grad()
    def targets(self, gt: torch.Tensor, num_valid: torch.Tensor, level_hw: List[Tuple[int, int]],
                target_size: float) -> Dict[str, torch.Tensor]:
        """gt (B, K, 5) padded, num_valid (B,), the levels' (h, w), the input
        height → per row (B, R): ``mask`` (1 where a gt writes), ``tx``, ``ty``,
        ``tw``, ``th``, ``tscale`` (0 elsewhere) and ``tcls`` (B, R, C)."""
        B, K = gt.shape[:2]
        device, C = gt.device, self.num_classes
        A = self.anchors.shape[1]
        all_anchors = self.anchors.reshape(-1, 2).to(device)  # (9, 2)
        gt_w, gt_h = gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]
        gt_wh = torch.stack([gt_w, gt_h], dim=-1)
        anchors_xyxy = torch.cat([-all_anchors / 2, all_anchors / 2], dim=1)
        anchor_ious = box_iou(torch.cat([-gt_wh / 2, gt_wh / 2], dim=-1), anchors_xyxy)  # (B, K, 9)
        best_n = first_argmax(anchor_ious, dim=-1)
        best_a, best_level = best_n % 3, best_n // 3

        sizes = [h * w * A for h, w in level_hw]
        R = sum(sizes)
        per_level = lambda values: torch.tensor(values, device=device)[best_level]
        stride = per_level([float(s) for s in self.strides])
        W_l, H_l = per_level([w for _, w in level_hw]), per_level([h for h, _ in level_hw])
        first_row = per_level([sum(sizes[:i]) for i in range(len(sizes))])

        gt_cx, gt_cy = (gt[..., 0] + gt[..., 2]) * 0.5, (gt[..., 1] + gt[..., 3]) * 0.5
        gi, gj = (gt_cx / stride).to(torch.int32), (gt_cy / stride).to(torch.int32)
        k_valid = torch.arange(K, device=device)[None, :] < num_valid[:, None]
        write = k_valid & (gi >= 0) & (gi < W_l) & (gj >= 0) & (gj < H_l)
        slot = torch.where(write, first_row + (gj * W_l + gi) * A + best_a, R).long()  # row R: dropped

        # the highest writing gt index per row (-1: none), then each target gathered from it
        k_idx = torch.arange(K, device=device).expand(B, K)
        winner = torch.full((B, R + 1), -1, dtype=torch.long, device=device)
        winner = winner.scatter_reduce(1, slot, k_idx, reduce="amax")[:, :R]
        has = winner >= 0
        take = lambda v: torch.where(has, torch.gather(v, 1, winner.clamp(min=0)), 0.0)
        anchor_wh = all_anchors[best_n]  # (B, K, 2)
        out = {
            "mask": has.float(),
            "tx": take(gt_cx / stride - gi), "ty": take(gt_cy / stride - gj),
            "tw": take(torch.log(torch.clamp(gt_w / anchor_wh[..., 0], min=1e-9))),
            "th": take(torch.log(torch.clamp(gt_h / anchor_wh[..., 1], min=1e-9))),
            "tscale": take(2.0 - gt_w * gt_h / (target_size * target_size)),
        }
        gt_cls = (gt[..., 4].to(torch.int32) - 1).clamp(0, C - 1).long()
        tcls = torch.zeros((B, R + 1, C), dtype=torch.float32, device=device)
        tcls[torch.arange(B, device=device)[:, None].expand(B, K), slot, gt_cls] = 1.0
        out["tcls"] = tcls[:, :R]
        return out

    @torch.no_grad()
    def ignore_mask(self, boxes: torch.Tensor, gt: torch.Tensor, num_valid: torch.Tensor) -> torch.Tensor:
        """Decoded xyxy boxes (B, R, 4), detached, gt (B, K, 5) → (B, R) bool:
        the best IoU over the valid gts above ``IGNORE_THRESHOLD``."""
        K = gt.shape[1]
        k_valid = torch.arange(K, device=gt.device)[None, :] < num_valid[:, None]
        ious = torch.where(k_valid[:, None, :], box_iou(boxes, gt[..., :4].contiguous()), 0.0)  # (B, R, K)
        return ious.amax(dim=2) > self.ignore_threshold

    def losses(self, pred: torch.Tensor, t: Dict[str, torch.Tensor], ignore: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pred (B, R, 5 + C) raw, the targets and ignore mask → the four
        losses, each summed over the rows and divided by the batch size."""
        bsz = float(pred.shape[0])
        mask = t["mask"]
        w_xy = mask * t["tscale"]
        obj_mask = torch.where(mask > 0, 1.0, (~ignore).float())
        loss_xy = torch.sum(w_xy * (binary_cross_entropy(pred[..., 0], t["tx"])
                                    + binary_cross_entropy(pred[..., 1], t["ty"]))) / bsz
        loss_wh = torch.sum(w_xy * ((pred[..., 2] - t["tw"]).abs() + (pred[..., 3] - t["th"]).abs())) / bsz
        loss_conf = torch.sum(obj_mask * binary_cross_entropy(pred[..., 4], mask)) / bsz
        loss_cls = torch.sum(mask[..., None] * binary_cross_entropy(pred[..., 5:], t["tcls"])) / bsz
        total = loss_xy + loss_wh + loss_conf + loss_cls
        return {"total_loss": total, "loss_xy": loss_xy, "loss_wh": loss_wh, "loss_conf": loss_conf,
                "loss_cls": loss_cls}

    def get_losses(self, batch):
        """batch → (total, {total_loss, loss_xy, loss_wh, loss_conf, loss_cls});
        the BN running statistics update in place in train mode."""
        inputs = self.pre_process(batch, train=True)
        preds = self.module(inputs["image"])
        gt, num_valid = inputs["gt_boxes"], inputs["img_info"][:, 4].to(torch.int32)
        pred = self.flatten(preds)
        grid = self.grids(preds)
        t = self.targets(gt, num_valid, [tuple(p.shape[-2:]) for p in preds], float(inputs["image"].shape[2]))
        ignore = self.ignore_mask(self.decode(pred.detach(), grid), gt, num_valid)
        losses = self.losses(pred, t, ignore)
        return losses["total_loss"], losses

    # -- eval -----------------------------------------------------------------------
    def candidates(self, preds: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The raw maps → per level the top 1000 (anchor, class) pairs of
        conf·cls, by a stable sort, decoded: boxes (B, P, 4), scores (B, P)
        at or below ``TEST.CLS_THRESHOLD`` at ``NEG_INF``, labels (B, P)."""
        C, thresh = self.num_classes, self.cfg.TEST.CLS_THRESHOLD
        grid = self.grids(preds)
        sizes = [p.shape[-2] * p.shape[-1] * (p.shape[1] // (5 + C)) for p in preds]
        boxes, scores, labels = [], [], []
        for pred, g in zip(self.flatten(preds).split(sizes, dim=1), zip(*(v.split(sizes) for v in grid))):
            B, R = pred.shape[:2]
            score = (torch.sigmoid(pred[..., 4:5]) * torch.sigmoid(pred[..., 5:])).reshape(B, -1)
            top_scores, top_idx = topk_scores(score, min(1000, R * C))
            boxes.append(gather_rows(self.decode(pred, g), top_idx // C))
            scores.append(torch.where(top_scores > thresh, top_scores, NEG_INF))
            labels.append(top_idx % C)
        return torch.cat(boxes, dim=1), torch.cat(scores, dim=1), torch.cat(labels, dim=1)

    def post_process(self, preds: List[torch.Tensor], img_info: torch.Tensor) -> Dict[str, torch.Tensor]:
        test_cfg = self.cfg.TEST
        boxes, scores, labels, valid = post_processing(
            *self.candidates(preds), img_info, iou_threshold=test_cfg.IOU_THRESHOLD,
            max_detections=test_cfg.MAX_BOXES_PER_IMAGE)
        return {"boxes": boxes, "box_scores": scores, "box_labels": labels, "valid": valid}

    @torch.inference_mode()
    def inference(self, batch):
        inputs = self.pre_process(batch)
        return self.post_process(self.module(inputs["image"]), inputs["img_info"])
