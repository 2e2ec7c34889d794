"""YOLO heads in NCHW (counterparts of ``YOLOXHead`` and ``YOLOHead`` in
``basedet_tpu/layers/head/yolo_head.py``). YOLOX's decoupled head: per level
a 1x1 stem, two cls and two reg convs, and cls/reg/obj 1x1 predictions with
the prior-prob bias on cls and obj. YOLOv3's head: per level a 3x3
ConvBNAct doubling the channels (YOLOX's BN eps and momentum, as in the JAX
package) and a 1x1 prediction to A·(5 + C) channels; no model of either
package calls it. The predictions follow the compute-dtype policy, as the
JAX package's ``PConv`` does: bf16 out under bf16."""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn

from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.layers.blocks.yolo_block import ConvBNAct, make_conv


class YOLOXHead(nn.Module):
    def __init__(self, num_classes, in_channels: Sequence[int], mid_channels=256, act="silu",
                 depthwise=False, prior_prob=0.01, device=None):
        super().__init__()
        BlockConv = make_conv(depthwise)
        self.num_levels = len(in_channels)
        self.prior_prob = prior_prob
        kw = dict(act=act, device=device)
        for lv, c in enumerate(in_channels):
            self.add_module(f"stem_{lv}", ConvBNAct(c, mid_channels, 1, 1, **kw))
            for i in range(2):
                self.add_module(f"cls_conv_{lv}_{i}", BlockConv(mid_channels, mid_channels, 3, 1, **kw))
                self.add_module(f"reg_conv_{lv}_{i}", BlockConv(mid_channels, mid_channels, 3, 1, **kw))
            self.add_module(f"cls_pred_{lv}", nn.Conv2d(mid_channels, num_classes, 1, device=device))
            self.add_module(f"reg_pred_{lv}", nn.Conv2d(mid_channels, 4, 1, device=device))
            self.add_module(f"obj_pred_{lv}", nn.Conv2d(mid_channels, 1, 1, device=device))

    @torch.no_grad()
    def init_prior_bias(self) -> None:
        bias = -math.log((1 - self.prior_prob) / self.prior_prob)
        for lv in range(self.num_levels):
            getattr(self, f"cls_pred_{lv}").bias.fill_(bias)
            getattr(self, f"obj_pred_{lv}").bias.fill_(bias)

    def forward(self, features: List[torch.Tensor]):
        logits, offsets, objs = [], [], []
        for lv, x in enumerate(features):
            x = getattr(self, f"stem_{lv}")(x)
            c, r = x, x
            for i in range(2):
                c = getattr(self, f"cls_conv_{lv}_{i}")(c)
                r = getattr(self, f"reg_conv_{lv}_{i}")(r)
            logits.append(precision.conv2d(getattr(self, f"cls_pred_{lv}"), c))
            offsets.append(precision.conv2d(getattr(self, f"reg_pred_{lv}"), r))
            objs.append(precision.conv2d(getattr(self, f"obj_pred_{lv}"), r))
        return logits, offsets, objs


class YOLOHead(nn.Module):
    def __init__(self, num_classes, in_channels: Sequence[int], num_anchors=3, act="lrelu", device=None):
        super().__init__()
        for lv, c in enumerate(in_channels):
            self.add_module(f"conv_{lv}", ConvBNAct(c, 2 * c, 3, 1, act=act, device=device))
            self.add_module(f"pred_{lv}", nn.Conv2d(2 * c, num_anchors * (5 + num_classes), 1, device=device))

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        return [precision.conv2d(getattr(self, f"pred_{lv}"), getattr(self, f"conv_{lv}")(x))
                for lv, x in enumerate(features)]
