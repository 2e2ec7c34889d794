"""Faster R-CNN R50-FPN in plain PyTorch: ResNet-50 (v1.5) with frozen BN
and its first two stages frozen, FPN P2-P6, the RPN with its anchors'
ground truth, sampling and losses, proposals by per-level top-k and NMS, the
R-CNN sampling, multilevel RoIAlign, the 2-fc box head and its losses, and
inference's class-aware post-processing.

Follows Detectron2's ``faster_rcnn_R_50_FPN_1x`` as the port restates it: a
frozen copy of the port's plain code, with the port's parameter names, so
that one state dict loads into both. Departures from Detectron2, the port's
too: a fixed number of proposal slots (NMS output padded), sampling by
seeded uniform noise with a quota per image, and bilinear top-down
upsampling in the FPN (the JAX package's ``jax.image.resize``).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (NEG_INF, BoxCoder, FrozenBN, QConv2d, QLinear, batched_nms, bce_with_logits, box_iou,
                     clip_boxes, first_argmax, gather_rows, l1, matcher, nonempty, post_processing, roi_align,
                     sample_mask, topk_stable)

FPN_STRIDES = (4, 8, 16, 32, 64)
POOL_STRIDES = (4, 8, 16, 32)


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride):
        super().__init__()
        out = width * 4
        self.conv1 = QConv2d(cin, width, 1, bias=False)
        self.conv2 = QConv2d(width, width, 3, stride, 1, bias=False)
        self.conv3 = QConv2d(width, out, 1, bias=False)
        self.down = cin != out or stride != 1
        if self.down:
            self.downsample_conv = QConv2d(cin, out, 1, stride, bias=False)
        for i, c in enumerate([width, width, out] + ([out] if self.down else [])):
            self.add_module(f"FrozenBatchNorm_{i}", FrozenBN(c))

    def forward(self, x):
        y = F.relu(self.FrozenBatchNorm_0(self.conv1(x)))
        y = F.relu(self.FrozenBatchNorm_1(self.conv2(y)))
        y = self.FrozenBatchNorm_2(self.conv3(y))
        idn = self.FrozenBatchNorm_3(self.downsample_conv(x)) if self.down else x
        return F.relu(y + idn)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = QConv2d(3, 64, 7, 2, 3, bias=False)
        self.FrozenBatchNorm_0 = FrozenBN(64)
        self.stages = []
        cin = 64
        for s, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            names = []
            for b in range(n):
                self.add_module(f"layer{s + 1}_{b}", Bottleneck(cin, width, 2 if s > 0 and b == 0 else 1))
                cin = width * 4
                names.append(f"layer{s + 1}_{b}")
            self.stages.append(names)
        for m in [self.conv1] + [getattr(self, n) for n in self.stages[0]]:  # FREEZE_AT 2
            m.requires_grad_(False)

    def forward(self, x):
        y = F.max_pool2d(F.relu(self.FrozenBatchNorm_0(self.conv1(x))), 3, 2, 1).detach()
        feats = {}
        for s, names in enumerate(self.stages):
            for n in names:
                y = getattr(self, n)(y)
            if s == 0:
                y = y.detach()
            feats[f"res{s + 2}"] = y
        return feats


class FPN(nn.Module):
    names = ("res2", "res3", "res4", "res5")

    def __init__(self, channels=(256, 512, 1024, 2048), out=256):
        super().__init__()
        for n, c in zip(self.names, channels):
            self.add_module(f"fpn_lateral_{n}", QConv2d(c, out, 1))
            self.add_module(f"fpn_output_{n}", QConv2d(out, out, 3, padding=1))

    def forward(self, bottom_up):
        results, prev = [], None
        for n in self.names[::-1]:
            lat = getattr(self, f"fpn_lateral_{n}")(bottom_up[n])
            if prev is not None:
                lat = lat + F.interpolate(prev, size=lat.shape[-2:], mode="bilinear", align_corners=False)
            prev = lat
            results.append(getattr(self, f"fpn_output_{n}")(lat))
        p = results[::-1]
        return p + [p[-1][:, :, ::2, ::2]]  # P2..P5, P6


class RPNHead(nn.Module):
    def __init__(self, cin=256, ch=256, a=3):
        super().__init__()
        self.rpn_conv = QConv2d(cin, ch, 3, padding=1)
        self.rpn_cls_score = QConv2d(ch, a, 1)
        self.rpn_bbox_offsets = QConv2d(ch, a * 4, 1)

    def forward(self, feats):
        logits, offsets = [], []
        for f in feats:
            t = F.relu(self.rpn_conv(f))
            b = t.shape[0]
            logits.append(self.rpn_cls_score(t).permute(0, 2, 3, 1).reshape(b, -1))
            offsets.append(self.rpn_bbox_offsets(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return logits, offsets


class Predictor(nn.Module):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = QLinear(cin, 1024)
        self.fc2 = QLinear(1024, 1024)
        self.pred_cls = QLinear(1024, num_classes + 1)
        self.pred_delta = QLinear(1024, num_classes * 4)

    def forward(self, pooled):
        x = F.relu(self.fc1(pooled.reshape(pooled.shape[0], -1)))
        x = F.relu(self.fc2(x))
        return self.pred_cls(x), self.pred_delta(x).reshape(-1, self.num_classes, 4)


class Network(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.bottom_up = ResNet50()
        self.fpn = FPN()
        self.rpn = RPNHead()
        self.rcnn = Predictor(7 * 7 * 256, num_classes)


def anchors_for(sizes, device):
    """Per level (H*W*3, 4) anchors: sizes 32..512, ratios 0.5, 1, 2,
    centres at (grid + 0.5) * stride."""
    out = []
    for (h, w), stride, scale in zip(sizes, FPN_STRIDES, (32, 64, 128, 256, 512)):
        base = []
        for r in (0.5, 1, 2):
            aw = math.sqrt(float(scale) ** 2 / r)
            ah = r * aw
            base.append([-aw / 2.0, -ah / 2.0, aw / 2.0, ah / 2.0])
        base = np.asarray(base, np.float32)
        gx, gy = np.meshgrid(0.5 * stride + stride * np.arange(w, dtype=np.float32),
                             0.5 * stride + stride * np.arange(h, dtype=np.float32))
        grid = np.stack([gx.reshape(-1), gy.reshape(-1)] * 2, axis=1)
        out.append(torch.from_numpy((grid[:, None, :] + base[None]).reshape(-1, 4)).to(device))
    return out


def sampling_noise(seed: int, step: int, batch: int, num_anchors: int, num_candidates: int, device):
    """One step's uniform noises, from a generator seeded by (seed, step)."""
    g = torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63))
    draw = lambda n: torch.rand((batch, n), generator=g, device=device)  # noqa: E731
    return {k: draw(n) for k, n in (("rpn_pos", num_anchors), ("rpn_neg", num_anchors),
                                     ("rcnn_fg", num_candidates), ("rcnn_bg", num_candidates),
                                     ("rcnn_tie", num_candidates))}


class FasterRCNN(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        self.num_classes = cfg["num_classes"]
        self.module = Network(self.num_classes)
        self.rpn_coder = BoxCoder()
        self.rcnn_coder = BoxCoder(std=(0.1, 0.1, 0.2, 0.2))

    def features(self, data):
        h, w = data.shape[1:3]
        ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
        x = F.pad(data.float(), (0, 0, 0, pw - w, 0, ph - h))
        x = (x - torch.tensor(self.cfg["img_mean"], device=x.device)) / torch.tensor(self.cfg["img_std"], device=x.device)
        return self.module.fpn(self.module.bottom_up(x.permute(0, 3, 1, 2)))

    @torch.no_grad()
    def proposals(self, logits_l, offsets_l, anchors_l, img_info, prev_k, post_k):
        cb, cs, cl = [], [], []
        for lv, (scores, offsets, anchors) in enumerate(zip(logits_l, offsets_l, anchors_l)):
            top, idx = topk_stable(scores.detach(), min(prev_k, scores.shape[1]))
            props = clip_boxes(self.rpn_coder.decode(anchors[idx], gather_rows(offsets.detach(), idx)),
                               img_info[:, 0], img_info[:, 1])
            cb.append(props)
            cs.append(torch.where(nonempty(props), top, NEG_INF))
            cl.append(torch.full_like(idx, lv))
        _, boxes, _, valid = batched_nms(torch.cat(cb, 1), torch.cat(cs, 1), torch.cat(cl, 1),
                                         self.cfg["rpn_nms_threshold"], post_k)
        return boxes, valid

    def losses(self, batch, seed: int, step: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        img_info = batch["im_info"].float()
        gt = batch["gt_boxes"].float()
        num_gt = img_info[:, 4].long()
        feats = self.features(batch["data"])
        logits_l, offsets_l = self.module.rpn(feats)
        anchors_l = anchors_for([tuple(f.shape[-2:]) for f in feats], gt.device)
        B, K = gt.shape[:2]
        noise = sampling_noise(seed, step, B, sum(x.shape[1] for x in logits_l), c["rpn_post_nms_topk_train"] + K,
                               gt.device)
        gt_valid = torch.arange(K, device=gt.device)[None, :] < num_gt[:, None]
        # RPN targets
        with torch.no_grad():
            anchors = torch.cat(anchors_l)
            midx, labels = matcher(box_iou(gt[..., :4], anchors), gt_valid)
            targets = self.rpn_coder.encode(anchors[None], gather_rows(gt[..., :4], midx))
            targets = torch.where((labels == 1)[..., None], targets, 0.0)
            n_sample = c["rpn_num_sample_anchors"]
            pos = sample_mask(noise["rpn_pos"], labels == 1, int(c["rpn_positive_ratio"] * n_sample), n_sample)
            labels = torch.where((labels == 1) & ~pos, -1, labels)
            neg = sample_mask(noise["rpn_neg"], labels == 0, n_sample - (labels == 1).sum(1), n_sample)
            labels = torch.where((labels == 0) & ~neg, -1, labels)
        logits, offsets = torch.cat(logits_l, 1), torch.cat(offsets_l, 1)
        valid = labels >= 0
        n_valid = valid.sum().float().clamp(min=1.0)
        rpn_cls = (bce_with_logits(logits, labels.to(logits.dtype)) * valid).sum() / n_valid
        rpn_reg = (l1(offsets, targets) * (labels > 0)[..., None]).sum() / n_valid
        # proposals and R-CNN sampling
        props, pvalid = self.proposals(logits_l, offsets_l, anchors_l, img_info[:, :2],
                                       c["rpn_pre_nms_topk_train"], c["rpn_post_nms_topk_train"])
        with torch.no_grad():
            all_rois = torch.cat([props, gt[..., :4]], 1)
            roi_valid = torch.cat([pvalid, gt_valid], 1)
            ov = torch.where(gt_valid[:, None, :], box_iou(all_rois, gt[..., :4]), -1.0)
            max_ov, assign = ov.amax(2), first_argmax(ov, 2)
            n_rois = c["rcnn_num_rois"]
            fg = (max_ov >= c["rcnn_fg_threshold"]) & roi_valid
            bg = (max_ov >= c["rcnn_bg_threshold_low"]) & (max_ov < c["rcnn_bg_threshold_high"]) & roi_valid
            sel_fg = sample_mask(noise["rcnn_fg"], fg, int(n_rois * c["rcnn_fg_ratio"]), n_rois)
            sel_bg = sample_mask(noise["rcnn_bg"], bg, n_rois - sel_fg.sum(1), n_rois)
            _, order = topk_stable(sel_fg * 2.0 + sel_bg * 1.0 + noise["rcnn_tie"] * 0.5, n_rois)
            rois = gather_rows(all_rois, order)
            assigned = gather_rows(gather_rows(gt, assign), order)
            ch_fg, ch_bg = sel_fg.gather(1, order), sel_bg.gather(1, order)
            roi_labels = torch.where(ch_fg, assigned[..., 4].long(), torch.where(ch_bg, 0, -1))
            roi_targets = torch.where(ch_fg[..., None], self.rcnn_coder.encode(rois, assigned[..., :4]), 0.0)
            weights = (ch_fg | ch_bg).float()
        pooled = roi_align(feats[:4], rois, POOL_STRIDES)
        cls_logits, deltas = self.module.rcnn(pooled.flatten(0, 1))
        lab, w = roi_labels.flatten(), weights.flatten()
        num = w.sum().clamp(min=1.0)
        nll = -F.log_softmax(cls_logits.float(), -1).gather(1, lab.clamp(min=0)[:, None])[:, 0]
        rcnn_cls = (nll * w).sum() / num
        fgm = lab > 0
        fg_d = deltas.float().gather(1, (lab - 1).clamp(min=0)[:, None, None].expand(-1, 1, 4))[:, 0]
        rcnn_reg = (l1(fg_d, roi_targets.flatten(0, 1)) * fgm[:, None]).sum() / num
        return {"total_loss": rpn_cls + rpn_reg + rcnn_cls + rcnn_reg, "rpn_cls_loss": rpn_cls,
                "rpn_reg_loss": rpn_reg, "rcnn_cls_loss": rcnn_cls, "rcnn_reg_loss": rcnn_reg}

    @torch.no_grad()
    def inference(self, batch) -> Dict[str, torch.Tensor]:
        c = self.cfg
        img_info = batch["im_info"].float()
        feats = self.features(batch["data"])
        logits_l, offsets_l = self.module.rpn(feats)
        anchors_l = anchors_for([tuple(f.shape[-2:]) for f in feats], img_info.device)
        props, pvalid = self.proposals(logits_l, offsets_l, anchors_l, img_info[:, :2],
                                       c["rpn_pre_nms_topk_test"], c["rpn_post_nms_topk_test"])
        B, P = props.shape[:2]
        C = self.num_classes
        logits, deltas = self.module.rcnn(roi_align(feats[:4], props, POOL_STRIDES).flatten(0, 1))
        scores = torch.softmax(logits.float(), -1)[:, 1:].reshape(B, P, C)
        boxes = self.rcnn_coder.decode(props.reshape(-1, 4)[:, None, :], deltas.float()).reshape(B, P * C, 4)
        flat = torch.where(pvalid[..., None], scores, 0.0).reshape(B, -1)
        top, idx = topk_stable(flat, min(2000, P * C))
        keep = top > c["test_cls_threshold"]
        boxes, scores, labels, valid = post_processing(gather_rows(boxes, idx), torch.where(keep, top, NEG_INF),
                                                       idx % C, img_info, c["test_iou_threshold"],
                                                       c["max_detections"])
        return {"boxes": boxes, "box_scores": scores, "box_labels": labels, "valid": valid}


def init_spec(name: str, shape) -> tuple:
    """How the benchmark draws a leaf from the seed (see ``yolox.init_spec``):
    backbone convs lecun-normal, FPN convs He-normal, the RPN and fc layers
    N(0, 0.01) and ``pred_delta`` N(0, 0.001); then, as ``chip_smoke.py``
    spreads them, the frozen BN's scale, bias and statistics, every bias
    N(0, 0.3), the RPN's box sizes +log 3 (proposals reach P2-P5) and the
    class logits' biases a further N(0, 2) (some clear the 0.05 threshold)."""
    leaf = name.rsplit(".", 1)[-1]
    if "FrozenBatchNorm" in name:
        return {"weight": ("uniform", 0.5, 1.5), "bias": ("normal", 0.3, 0.0),
                "running_mean": ("normal", 0.2, 0.0), "running_var": ("uniform", 0.5, 2.0)}[leaf]
    if leaf == "weight":
        fan_in = int(np.prod(shape[1:]))
        if name.startswith("module.bottom_up."):
            return ("normal", math.sqrt(1.0 / fan_in), 0.0)
        if name.startswith("module.fpn."):
            return ("normal", math.sqrt(2.0 / fan_in), 0.0)
        return ("normal", 0.001 if "pred_delta" in name else 0.01, 0.0)
    if leaf == "bias":
        if "rpn_bbox_offsets" in name:
            return ("normal", 0.3, (0.0, 0.0, math.log(3.0), math.log(3.0)))
        if "pred_cls" in name:
            return ("normal", math.sqrt(0.3 ** 2 + 2.0 ** 2), 0.0)
        return ("normal", 0.3, 0.0)
    raise KeyError(f"no init rule for {name} {tuple(shape)}")


def port_name(name: str) -> str:
    """The port's name of a reference state entry."""
    return name.removeprefix("module.")


def build(cfg: Dict) -> FasterRCNN:
    return FasterRCNN(cfg)


def flop_graph(model: FasterRCNN, batch: int, image_hw, train: bool) -> torch.Tensor:
    """The convolutions and matrix products of one step on ``batch`` images:
    backbone, FPN and RPN head on the padded image, and the box head on the
    RoIs a step pools (``rcnn_num_rois`` an image to train, the test's
    proposal slots to serve); RoIAlign itself is no matrix product."""
    dev = next(model.parameters()).device
    feats = model.features(torch.zeros((batch, *image_hw, 3), device=dev))
    logits, offsets = model.module.rpn(feats)
    rois = model.cfg["rcnn_num_rois"] if train else model.cfg["rpn_post_nms_topk_test"]
    pooled = torch.zeros((batch * rois, 7, 7, 256), device=dev, requires_grad=train)
    cls, delta = model.module.rcnn(pooled)
    return sum(t.float().sum() for t in logits + offsets) + cls.sum() + delta.sum()
