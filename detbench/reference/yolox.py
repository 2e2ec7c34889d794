"""YOLOX in plain PyTorch: CSPDarknet, PAFPN and the decoupled head, SimOTA
with its dynamic-k matching, the IoU, objectness and class losses, and the
decode, per-level top-1000 and class-aware NMS of inference.

Follows Megvii's YOLOX (``yolox/models/{darknet,yolo_pafpn,yolo_head}.py``)
as the port restates it; a frozen copy of the port's plain code, with the
port's parameter names, so that one state dict loads into both. Departures
from Megvii's code, the port's too: BN's running statistics move with the
biased variance (flax), and the dynamic-k matching picks the lowest index
among equal costs.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (NEG_INF, FlaxBN, QConv2d, bce_with_logits, box_iou, gather_rows, post_processing,
                    topk_stable, xcycwh_to_xyxy, xyxy_to_xcycwh)


class ConvBNAct(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1):
        super().__init__()
        self.conv = QConv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)
        self.bn = FlaxBN(cout, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Focus(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv = ConvBNAct(4 * cin, cout, k, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 5, 3, 1, 2, 4).reshape(B, 4 * C, H // 2, W // 2)
        return self.conv(x)


class SPPBottleneck(nn.Module):
    def __init__(self, cin, cout, kernels=(5, 9, 13)):
        super().__init__()
        hidden = cin // 2
        self.kernels = kernels
        self.conv1 = ConvBNAct(cin, hidden)
        self.conv2 = ConvBNAct(hidden * (len(kernels) + 1), cout)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.kernels], dim=1))


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, shortcut):
        super().__init__()
        self.conv1 = ConvBNAct(cin, cout)
        self.conv2 = ConvBNAct(cout, cout, 3)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add else y


class CSPLayer(nn.Module):
    def __init__(self, cin, cout, n, shortcut):
        super().__init__()
        hidden = cout // 2
        self.conv1 = ConvBNAct(cin, hidden)
        self.conv2 = ConvBNAct(cin, hidden)
        self.n = n
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(hidden, hidden, shortcut))
        self.conv3 = ConvBNAct(2 * hidden, cout)

    def forward(self, x):
        y = self.conv1(x)
        for i in range(self.n):
            y = getattr(self, f"m_{i}")(y)
        return self.conv3(torch.cat([y, self.conv2(x)], dim=1))


class CSPDarknet(nn.Module):
    def __init__(self, depth, width):
        super().__init__()
        base_depth = max(round(depth * 3), 1)
        c = int(width * 64)
        self.stem = Focus(3, c, 3)
        specs = [("dark2", c * 2, base_depth, False), ("dark3", c * 4, base_depth * 3, False),
                 ("dark4", c * 8, base_depth * 3, False), ("dark5", c * 16, base_depth, True)]
        prev = c
        for name, ch, n, spp in specs:
            self.add_module(f"{name}_conv", ConvBNAct(prev, ch, 3, 2))
            if spp:
                self.add_module(f"{name}_spp", SPPBottleneck(ch, ch))
            self.add_module(f"{name}_csp", CSPLayer(ch, ch, n, shortcut=not spp))
            prev = ch

    def forward(self, x):
        x = self.stem(x)
        out = []
        for name in ("dark2", "dark3", "dark4", "dark5"):
            x = getattr(self, f"{name}_conv")(x)
            if name == "dark5":
                x = self.dark5_spp(x)
            x = getattr(self, f"{name}_csp")(x)
            out.append(x)
        return out[1:]


class PAFPN(nn.Module):
    def __init__(self, depth, width):
        super().__init__()
        c0, c1, c2 = (int(c * width) for c in (256, 512, 1024))
        n = round(3 * depth)
        self.lateral_conv0 = ConvBNAct(c2, c1)
        self.C3_p4 = CSPLayer(2 * c1, c1, n, False)
        self.reduce_conv1 = ConvBNAct(c1, c0)
        self.C3_p3 = CSPLayer(2 * c0, c0, n, False)
        self.bu_conv2 = ConvBNAct(c0, c0, 3, 2)
        self.C3_n3 = CSPLayer(2 * c0, c1, n, False)
        self.bu_conv1 = ConvBNAct(c1, c1, 3, 2)
        self.C3_n4 = CSPLayer(2 * c1, c2, n, False)

    def forward(self, feats):
        x2, x1, x0 = feats
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        fpn0 = self.lateral_conv0(x0)
        f0 = self.C3_p4(torch.cat([up(fpn0), x1], 1))
        fpn1 = self.reduce_conv1(f0)
        p2 = self.C3_p3(torch.cat([up(fpn1), x2], 1))
        p1 = self.C3_n3(torch.cat([self.bu_conv2(p2), fpn1], 1))
        p0 = self.C3_n4(torch.cat([self.bu_conv1(p1), fpn0], 1))
        return [p2, p1, p0]


class Head(nn.Module):
    def __init__(self, num_classes, width):
        super().__init__()
        mid = int(256 * width)
        for lv, c in enumerate(int(c * width) for c in (256, 512, 1024)):
            self.add_module(f"stem_{lv}", ConvBNAct(c, mid))
            for i in range(2):
                self.add_module(f"cls_conv_{lv}_{i}", ConvBNAct(mid, mid, 3))
                self.add_module(f"reg_conv_{lv}_{i}", ConvBNAct(mid, mid, 3))
            self.add_module(f"cls_pred_{lv}", QConv2d(mid, num_classes, 1))
            self.add_module(f"reg_pred_{lv}", QConv2d(mid, 4, 1))
            self.add_module(f"obj_pred_{lv}", QConv2d(mid, 1, 1))

    def forward(self, feats):
        logits, offsets, objs = [], [], []
        for lv, x in enumerate(feats):
            x = getattr(self, f"stem_{lv}")(x)
            c, r = x, x
            for i in range(2):
                c = getattr(self, f"cls_conv_{lv}_{i}")(c)
                r = getattr(self, f"reg_conv_{lv}_{i}")(r)
            logits.append(getattr(self, f"cls_pred_{lv}")(c))
            offsets.append(getattr(self, f"reg_pred_{lv}")(r))
            objs.append(getattr(self, f"obj_pred_{lv}")(r))
        return logits, offsets, objs


class Network(nn.Module):
    def __init__(self, num_classes, depth, width):
        super().__init__()
        self.backbone = CSPDarknet(depth, width)
        self.pafpn = PAFPN(depth, width)
        self.head = Head(num_classes, width)

    def forward(self, image):
        return self.head(self.pafpn(self.backbone(image)))


def flatten_level(x, k):
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w * (c // k), k).float()


def points(sizes, strides, device):
    grids, svec = [], []
    for (h, w), s in zip(sizes, strides):
        ys = s * torch.arange(h, dtype=torch.float32, device=device)
        xs = s * torch.arange(w, dtype=torch.float32, device=device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grids.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], 1))
        svec.append(torch.full((h * w,), float(s), device=device))
    return grids, svec


def dynamic_k_matching(cost, ious, gt_valid, k=10):
    """SimOTA's dynamic k: each valid gt takes its ``floor(sum of its k best
    IoUs)`` (1 to k) cheapest anchors; an anchor taken twice goes to its
    cheapest gt → (matched gt (B, M), foreground (B, M))."""
    B, K, M = cost.shape
    k = min(k, M)
    col = torch.arange(M, device=cost.device)
    work, iou_sum = ious, torch.zeros((B, K), dtype=torch.float32, device=cost.device)
    for _ in range(k):
        iou_sum = iou_sum + work.amax(dim=2)
        work = torch.where(col == work.argmax(dim=2, keepdim=True), -torch.inf, work)
    dks = torch.where(gt_valid, iou_sum.to(torch.int32).clamp(1, k), 0)
    work, matching = cost, torch.zeros((B, K, M), dtype=torch.bool, device=cost.device)
    for i in range(k):
        pick = col == work.argmin(dim=2, keepdim=True)
        matching |= pick & (i < dks)[..., None]
        work = torch.where(pick, torch.inf, work)
    best = torch.where(matching, cost, torch.inf).argmin(dim=1)
    return best, matching.any(dim=1)


class YOLOX(nn.Module):
    """The whole detector: ``module`` holds the port's parameter names."""

    strides = (8, 16, 32)

    def __init__(self, cfg: Dict):
        super().__init__()
        self.num_classes = cfg["num_classes"]
        self.module = Network(self.num_classes, cfg["depth_factor"], cfg["width_factor"])
        self.cls_threshold = cfg["test_cls_threshold"]
        self.iou_threshold = cfg["test_iou_threshold"]
        self.max_det = cfg["max_detections"]

    def heads(self, data):
        image = data.float().permute(0, 3, 1, 2)
        return self.module(image)

    @torch.no_grad()
    def assign(self, anchors, svec, gt, num_valid, pred, cls_logits, obj_logits):
        K, R, C = gt.shape[1], anchors.shape[0], self.num_classes
        gt_valid = torch.arange(K, device=gt.device)[None, :] < num_valid[:, None]
        x1, y1, x2, y2 = (gt[..., i, None] for i in range(4))
        ax, ay = anchors[:, 0], anchors[:, 1]
        in_boxes = torch.minimum(torch.minimum(ax - x1, ay - y1), torch.minimum(x2 - ax, y2 - ay)) > 0
        cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
        rad = 2.5 * svec
        in_centers = torch.minimum(torch.minimum(ax - (cx - rad), ay - (cy - rad)),
                                   torch.minimum((cx + rad) - ax, (cy + rad) - ay)) > 0
        in_boxes &= gt_valid[..., None]
        in_centers &= gt_valid[..., None]
        candidate = in_boxes.any(1) | in_centers.any(1)
        both = in_boxes & in_centers
        ious = box_iou(gt[..., :4], xcycwh_to_xyxy(pred))
        ious = torch.where(gt_valid[..., None] & candidate[:, None, :], ious, 0.0)
        p = torch.sqrt(torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits))
        eps = 1e-8
        s0 = (-torch.log((1 - p).clamp(min=eps))).sum(-1)
        labels0 = (gt[..., 4].to(torch.int32) - 1).clamp(0, C - 1).long()
        p_y = torch.gather(p, 2, labels0[:, None, :].expand(-1, R, -1)).transpose(1, 2)
        cls_cost = s0[:, None, :] + torch.log((1 - p_y).clamp(min=eps)) - torch.log(p_y.clamp(min=eps))
        cost = (cls_cost + 3.0 * -torch.log(ious + 1e-8) + 100000.0 * ~both
                + 1e9 * ~candidate[:, None, :] + 1e9 * ~gt_valid[..., None])
        matched, fg = dynamic_k_matching(cost, ious, gt_valid)
        fg &= candidate
        pred_iou = torch.gather(ious, 1, matched[:, None, :])[:, 0]
        return fg, matched, pred_iou

    def losses(self, batch, seed: int = 0, step: int = 0) -> Dict[str, torch.Tensor]:
        """The losses of one batch (YOLOX draws no noise: ``seed`` and
        ``step`` are unused)."""
        logits_l, offsets_l, objs_l = self.heads(batch["data"])
        dev = batch["data"].device
        grids, svecs = points([tuple(x.shape[2:]) for x in logits_l], self.strides, dev)
        anchors, svec = torch.cat(grids), torch.cat(svecs)
        C = self.num_classes
        cls_logits = torch.cat([flatten_level(x, C) for x in logits_l], 1)
        raw = torch.cat([flatten_level(x, 4) for x in offsets_l], 1)
        obj = torch.cat([flatten_level(x, 1) for x in objs_l], 1)[..., 0]
        xy = raw[..., :2] * svec[None, :, None] + anchors[None]
        wh = torch.exp(raw[..., 2:4]) * svec[None, :, None]
        pred = torch.cat([xy, wh], -1)
        gt = batch["gt_boxes"].float()
        num_valid = batch["im_info"][:, 4].to(torch.int32)
        fg, matched_gt, pred_iou = self.assign(anchors, svec, gt, num_valid, pred.detach(), cls_logits.detach(),
                                               obj.detach()[..., None])
        matched = gather_rows(gt, matched_gt.long())
        num_fg = fg.sum().float().clamp(min=1.0)
        p_xyxy, t_xyxy = xcycwh_to_xyxy(pred), xcycwh_to_xyxy(xyxy_to_xcycwh(matched[..., :4]))
        area_p = (p_xyxy[..., 2] - p_xyxy[..., 0]).clamp(min=0) * (p_xyxy[..., 3] - p_xyxy[..., 1]).clamp(min=0)
        area_t = (t_xyxy[..., 2] - t_xyxy[..., 0]).clamp(min=0) * (t_xyxy[..., 3] - t_xyxy[..., 1]).clamp(min=0)
        iw = (torch.minimum(p_xyxy[..., 2], t_xyxy[..., 2]) - torch.maximum(p_xyxy[..., 0], t_xyxy[..., 0])).clamp(min=0)
        ih = (torch.minimum(p_xyxy[..., 3], t_xyxy[..., 3]) - torch.maximum(p_xyxy[..., 1], t_xyxy[..., 1])).clamp(min=0)
        inter = iw * ih
        iou = inter / (area_p + area_t - inter).clamp(min=1e-8)
        loss_iou = torch.sum((1.0 - iou ** 2) * fg) / num_fg * 5.0
        loss_obj = torch.sum(bce_with_logits(obj, fg.float())) / num_fg
        labels0 = (matched[..., 4].to(torch.int32) - 1).clamp(0, C - 1).long()
        target = F.one_hot(labels0, C).float() * pred_iou[..., None]
        loss_cls = torch.sum(bce_with_logits(cls_logits, target) * fg[..., None]) / num_fg
        total = loss_iou + loss_obj + loss_cls
        return {"total_loss": total, "iou_loss": loss_iou, "obj_loss": loss_obj, "cls_loss": loss_cls}

    @torch.no_grad()
    def inference(self, batch) -> Dict[str, torch.Tensor]:
        logits_l, offsets_l, objs_l = self.heads(batch["data"])
        img_info = batch["im_info"].float()
        C = self.num_classes
        grids, _ = points([tuple(x.shape[2:]) for x in logits_l], self.strides, img_info.device)
        cb, cs, cl = [], [], []
        for logits, offsets, obj, grid, stride in zip(logits_l, offsets_l, objs_l, grids, self.strides):
            logits, offsets, obj = flatten_level(logits, C), flatten_level(offsets, 4), flatten_level(obj, 1)
            score = torch.sqrt(torch.sigmoid(logits) * torch.sigmoid(obj)).flatten(1)
            boxes = xcycwh_to_xyxy(torch.cat([offsets[..., :2] * stride + grid,
                                              torch.exp(offsets[..., 2:4]) * stride], -1))
            top, idx = topk_stable(score, min(1000, score.shape[1]))
            cb.append(gather_rows(boxes, idx // C))
            cs.append(torch.where(top > self.cls_threshold, top, NEG_INF))
            cl.append(idx % C)
        boxes, scores, labels, valid = post_processing(torch.cat(cb, 1), torch.cat(cs, 1), torch.cat(cl, 1),
                                                       img_info, self.iou_threshold, self.max_det)
        return {"boxes": boxes, "box_scores": scores, "box_labels": labels, "valid": valid}


def init_spec(name: str, shape) -> tuple:
    """How the benchmark draws a leaf from the seed: ("normal", std, shift),
    ("uniform", low, high) or ("const", value). Conv kernels lecun-normal;
    BN scale, bias and statistics spread, and every bias shifted by N(0, 0.3)
    from its init (the head's prior bias; the box sizes' +log 4, so that a
    box spans about four strides and NMS suppresses), as ``chip_smoke.py``
    spreads them."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return ("const", 0.0)
    if leaf == "weight" and len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
        return ("normal", math.sqrt(1.0 / fan_in), 0.0)
    if ".bn." in f".{name}":
        return {"weight": ("uniform", 0.5, 1.5), "bias": ("normal", 0.3, 0.0),
                "running_mean": ("normal", 0.2, 0.0), "running_var": ("uniform", 0.5, 2.0)}[leaf]
    if leaf == "bias":
        prior = -math.log((1 - 0.01) / 0.01)
        if "cls_pred" in name or "obj_pred" in name:
            return ("normal", 0.3, prior)
        if "reg_pred" in name:
            return ("normal", 0.3, (0.0, 0.0, math.log(4.0), math.log(4.0)))
    raise KeyError(f"no init rule for {name} {tuple(shape)}")


def port_name(name: str) -> str:
    """The port's name of a reference state entry."""
    return name.removeprefix("module.")


def build(cfg: Dict) -> YOLOX:
    return YOLOX(cfg)


def flop_graph(model: YOLOX, batch: int, image_hw, train: bool) -> torch.Tensor:
    """The convolutions and matrix products of one step on ``batch`` images
    of ``image_hw`` (the network forward; the caller adds the backward for a
    train step), on whatever device ``model`` lives: a scalar to differentiate."""
    dev = next(model.parameters()).device
    data = torch.zeros((batch, *image_hw, 3), device=dev)
    return sum(t.float().sum() for level in model.heads(data) for t in level)
