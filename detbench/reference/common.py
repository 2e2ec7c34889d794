"""Plain PyTorch pieces that both reference detectors use: box arithmetic,
losses, stable top-k, greedy NMS, the IoU-threshold matcher, the sampling
masks, the box coder and multilevel RoIAlign.

A frozen copy of the port's plain versions (``structures/``,
``layers/losses/``, ``layers/common/``, ``ops/nms.py`` and the plain
RoIAlign), kept here so that the reference depends on nothing the program
ships. Everything runs in the caller's dtype (float32 in the benchmark) with
no custom kernel; RoIAlign runs in blocks of RoIs so that a batch of 8,192
fits. ``QConv2d`` and ``QLinear`` carry the hooks through which the
lower-precision controls (``detbench/kinds/``) round their operands and
gradients.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e10
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value
FP8_E5M2_MAX = 57344.0


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude maps to 448), back in x's dtype; the gradient passes straight
    through, as in fp8 training with f32 master weights."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


class _E5M2Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale = g.abs().amax().clamp(min=1e-30) / FP8_E5M2_MAX
        return (g / scale).to(torch.float8_e5m2).to(g.dtype) * scale


def fp8_e5m2_grad(y: torch.Tensor) -> torch.Tensor:
    """y unchanged; its gradient rounded to float8 e5m2 with one scale per
    tensor, as fp8 training rounds the gradients it multiplies."""
    return _E5M2Grad.apply(y)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10-bit mantissa, nearest even: what the
    card's TF32 tensor cores take in, for a device that has none."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return x + (i.view(torch.float32) - x.detach())


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` whose input and weight pass through ``quant`` first and
    whose output's gradient passes through ``grad_quant`` (identities
    unless the control sets them)."""

    quant = staticmethod(identity)
    grad_quant = staticmethod(identity)

    def forward(self, x):
        return self.grad_quant(F.conv2d(self.quant(x), self.quant(self.weight), self.bias, self.stride,
                                        self.padding, self.dilation, self.groups))


class QLinear(nn.Linear):
    quant = staticmethod(identity)
    grad_quant = staticmethod(identity)

    def forward(self, x):
        return self.grad_quant(F.linear(self.quant(x), self.quant(self.weight), self.bias))


def set_quant(module: nn.Module, fn, grad_fn=identity) -> None:
    """Route every ``QConv2d`` and ``QLinear`` of ``module`` through ``fn``,
    and the gradients of their outputs through ``grad_fn``."""
    for m in module.modules():
        if isinstance(m, (QConv2d, QLinear)):
            m.quant, m.grad_quant = fn, grad_fn


class FlaxBN(nn.BatchNorm2d):
    """Train mode: biased batch statistics, and the running statistics moved
    as flax moves them (``r = (1 - momentum) r + momentum stat``, biased
    variance). Eval mode: the running statistics."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0,
                                self.eps)
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(mean.detach(), alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var.detach(), alpha=self.momentum)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean[:, None, None]) * (inv * self.weight)[:, None, None] + self.bias[:, None, None]


class FrozenBN(nn.Module):
    """BatchNorm whose scale, bias and statistics are fixed buffers."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((channels,), fill))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = self.weight * inv
        return x * mul[:, None, None] + (self.bias - self.running_mean * mul)[:, None, None]


# -- boxes ---------------------------------------------------------------------------------------

def box_area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (..., M, N); 0 where the union is not positive."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)


def xcycwh_to_xyxy(b):
    return torch.cat([b[..., :2] - b[..., 2:4] * 0.5, b[..., :2] + b[..., 2:4] * 0.5], dim=-1)


def xyxy_to_xcycwh(b):
    wh = b[..., 2:4] - b[..., :2]
    return torch.cat([b[..., :2] + wh * 0.5, wh], dim=-1)


def clip_boxes(boxes, h, w):
    h, w = h[:, None], w[:, None]
    x1, y1, x2, y2 = (boxes[..., i].clamp(min=0.0) for i in range(4))
    return torch.stack([torch.minimum(x1, w), torch.minimum(y1, h), torch.minimum(x2, w), torch.minimum(y2, h)],
                       dim=-1)


def nonempty(boxes):
    return ((boxes[..., 2] - boxes[..., 0]) > 0) & ((boxes[..., 3] - boxes[..., 1]) > 0)


class BoxCoder:
    """R-CNN's (dx, dy, dw, dh) deltas whitened by mean and std."""

    def __init__(self, mean=(0.0, 0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0, 1.0)):
        self.mean, self.std = tuple(mean), tuple(std)

    @staticmethod
    def _cs(b):
        w, h = b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]
        return w, h, b[..., 0] + 0.5 * w, b[..., 1] + 0.5 * h

    def _ms(self, like):
        return (torch.tensor(self.mean, dtype=like.dtype, device=like.device),
                torch.tensor(self.std, dtype=like.dtype, device=like.device))

    def encode(self, anchors, gt):
        aw, ah, acx, acy = self._cs(anchors)
        gw, gh, gcx, gcy = self._cs(gt)
        t = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah, torch.log(gw / aw), torch.log(gh / ah)], dim=-1)
        mean, std = self._ms(t)
        return (t - mean) / std

    def decode(self, anchors, deltas):
        mean, std = self._ms(deltas)
        d = deltas * std + mean
        aw, ah, acx, acy = self._cs(anchors)
        cx, cy = acx + d[..., 0] * aw, acy + d[..., 1] * ah
        w, h = aw * torch.exp(d[..., 2]), ah * torch.exp(d[..., 3])
        return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


# -- small functions ---------------------------------------------------------------------------

def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) at idx (B, N) along dim 1."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(*idx.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, the lower index first among ties."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The lowest index of the maximum along ``dim``."""
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    index = torch.arange(size, device=x.device).reshape(shape)
    return torch.where(x == x.amax(dim=dim, keepdim=True), index, size).amin(dim=dim)


def bce_with_logits(x, z):
    return torch.maximum(x, torch.zeros_like(x)) - x * z + torch.log1p(torch.exp(-x.abs()))


def l1(pred, target):
    return (pred - target).abs()


def sample_mask(noise, candidates, quota, cap: int):
    """At most ``quota`` (an int or (B,)) of the True entries of
    ``candidates`` (B, N): those whose noise is among the quota largest."""
    B, n = candidates.shape
    scores = torch.where(candidates, noise, -1.0)
    cap = min(cap, n)
    top = torch.topk(scores, cap, dim=1).values
    q = torch.as_tensor(quota, device=scores.device).expand(B).clamp(0, cap)
    kth = top.gather(1, (q - 1).clamp(min=0)[:, None])[:, 0]
    thr = torch.where(q > 0, kth, torch.inf)
    return candidates & (scores >= thr[:, None])


def matcher(matrix, row_valid, thresholds=(0.3, 0.7), labels_=(0, -1, 1), low_quality=True):
    """IoU-threshold matching of K padded gts against M candidates."""
    masked = torch.where(row_valid[:, :, None], matrix, -1e8)
    best = masked.amax(dim=1)
    idx = first_argmax(masked, dim=1)
    labels = torch.full_like(idx, -1)
    edges = [-torch.inf, *thresholds, torch.inf]
    for lab, lo, hi in zip(labels_, edges[:-1], edges[1:]):
        labels = torch.where((best >= lo) & (best < hi), lab, labels)
    if low_quality:
        is_best = (masked == masked.amax(dim=2, keepdim=True)) & row_valid[:, :, None]
        labels = torch.where(is_best.any(dim=1), 1, labels)
    return idx, labels


# -- NMS ---------------------------------------------------------------------------------------

def nms_keep(sorted_boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy NMS over boxes sorted by descending score: a box is kept when
    it is valid and no kept box before it has ``inter > t * union``. The
    pairwise matrix is built image by image; the walk is over all images."""
    B, K = valid.shape
    t = torch.tensor(thresh, dtype=torch.float32, device=valid.device)
    later = torch.ones((K, K), dtype=torch.bool, device=valid.device).triu(1)
    suppress = torch.empty((B, K, K), dtype=torch.bool, device=valid.device)
    for b in range(B):
        x1, y1, x2, y2 = sorted_boxes[b].unbind(-1)
        iw = (torch.minimum(x2[:, None], x2[None, :]) - torch.maximum(x1[:, None], x1[None, :])).clamp(min=0.0)
        ih = (torch.minimum(y2[:, None], y2[None, :]) - torch.maximum(y1[:, None], y1[None, :])).clamp(min=0.0)
        inter = iw * ih
        area = (x2 - x1) * (y2 - y1)
        union = (area[:, None] + area[None, :]) - inter
        suppress[b] = (inter > t * union.clamp(min=1e-12)) & later
    keep = valid.clone()
    for i in range(K):
        keep &= ~(suppress[:, i] & keep[:, i:i + 1])
    return keep


def nms_padded(boxes, scores, thresh: float, max_output: int):
    B, K = scores.shape
    valid = scores > NEG_INF / 2
    sort_scores, order = torch.sort(torch.where(valid, scores, NEG_INF), dim=1, descending=True, stable=True)
    sort_boxes = gather_rows(boxes, order)
    keep = nms_keep(sort_boxes.contiguous(), sort_scores > NEG_INF / 2, thresh)
    src = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    if K < max_output:
        src = F.pad(src, (0, max_output - K))
    src = src[:, :max_output]
    filled = torch.arange(max_output, device=scores.device)[None, :] < keep.sum(1, keepdim=True)
    src = torch.where(filled, src, 0)
    out_idx = torch.where(filled, gather_rows(order, src), -1)
    out_scores = torch.where(filled, gather_rows(sort_scores, src), NEG_INF)
    return out_idx, out_scores, filled


def batched_nms(boxes, scores, classes, thresh: float, max_output: int):
    """Class-aware NMS by offsetting each class's boxes past the image's
    largest coordinate → (indices, boxes, scores, valid)."""
    valid = scores > NEG_INF / 2
    safe = torch.where(valid[..., None], boxes, 0.0)
    offsets = classes.to(boxes.dtype) * (safe.amax(dim=(1, 2)) + 1.0)[:, None]
    idx, out_scores, out_valid = nms_padded(safe + offsets[..., None], scores, thresh, max_output)
    out_boxes = torch.where(out_valid[..., None], gather_rows(safe, idx.clamp(min=0)), 0.0)
    return idx, out_boxes, out_scores, out_valid


def post_processing(boxes, scores, labels, img_info, iou_threshold: float, max_detections: int):
    """Class-aware NMS, then the kept boxes rescaled to the original image
    and clipped → (boxes, scores, labels (-1 where empty), valid)."""
    idx, out_boxes, out_scores, valid = batched_nms(boxes, scores, labels, iou_threshold, max_detections)
    kept_labels = torch.where(valid, gather_rows(labels, idx.clamp(min=0)), -1)
    sy = img_info[:, 2] / img_info[:, 0]
    sx = img_info[:, 3] / img_info[:, 1]
    scaled = out_boxes * torch.stack([sx, sy, sx, sy], dim=-1)[:, None, :]
    return (clip_boxes(scaled, img_info[:, 2], img_info[:, 3]), torch.where(valid, out_scores, 0.0),
            kept_labels, valid)


# -- RoIAlign ----------------------------------------------------------------------------------

def roi_levels(rois, min_level: int, max_level: int):
    area = (rois[..., 2] - rois[..., 0]).clamp(min=0) * (rois[..., 3] - rois[..., 1]).clamp(min=0)
    lvl = torch.floor(4 + torch.log(torch.sqrt(area.clamp(min=1e-12)) / 224) / math.log(2.0)).to(torch.int32)
    return lvl.clamp(min_level, max_level) - min_level


def axis_weights(lo, bin_size, pool: int, size: int, sampling: int = 2):
    """(r, pool, size) bilinear weights along one axis: sampling points per
    bin, samples outside [-1, size] dropped, the 1/S average folded in."""
    dev = lo.device
    steps = (torch.arange(pool, dtype=torch.float32, device=dev)[:, None]
             + (torch.arange(sampling, dtype=torch.float32, device=dev)[None, :] + 0.5) / sampling)
    coords = lo[:, None, None] + steps * bin_size[:, None, None]
    oob = (coords < -1.0) | (coords > size)
    c = coords.clamp(0.0, size - 1.0)
    low = torch.floor(c)
    high = torch.minimum(low + 1.0, torch.tensor(size - 1.0, device=dev))
    lerp = c - low
    grid = torch.arange(size, dtype=torch.float32, device=dev)
    w = ((grid == low[..., None]) * (1.0 - lerp)[..., None] + (grid == high[..., None]) * lerp[..., None])
    return (w * (torch.where(oob, 0.0, 1.0) / sampling)[..., None]).sum(-2)


def roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor, strides: Sequence[int],
              output_size=(7, 7), block: int = 256) -> torch.Tensor:
    """Aligned multilevel RoIAlign (sampling ratio 2) → (B, R, ph, pw, C):
    each RoI pooled from its FPN level with separable weights, ``block``
    RoIs of one image and level at a time."""
    B, R = rois.shape[:2]
    C = features[0].shape[1]
    ph, pw = output_size
    levels = roi_levels(rois, int(math.log2(strides[0])), int(math.log2(strides[-1])))
    flat = rois.reshape(-1, 4)
    parts: List[torch.Tensor] = []
    where: List[torch.Tensor] = []
    for li, (feat, stride) in enumerate(zip(features, strides)):
        H, W = feat.shape[-2:]
        for b in range(B):
            sel = torch.nonzero(levels[b] == li)[:, 0] + b * R
            for s in range(0, sel.numel(), block):
                idx = sel[s:s + block]
                box = flat[idx] / stride - 0.5
                bh = (box[:, 3] - box[:, 1]) / torch.tensor(float(ph), device=box.device)
                bw = (box[:, 2] - box[:, 0]) / torch.tensor(float(pw), device=box.device)
                py = axis_weights(box[:, 1], bh, ph, H)
                px = axis_weights(box[:, 0], bw, pw, W)
                t = torch.einsum("riy,cyx->rixc", py, feat[b])
                parts.append(torch.einsum("rjx,rixc->rijc", px, t))
                where.append(idx)
    out = torch.zeros((B * R, ph, pw, C), dtype=features[0].dtype, device=rois.device)
    if parts:
        out = out.index_copy(0, torch.cat(where), torch.cat(parts))
    return out.reshape(B, R, ph, pw, C)
