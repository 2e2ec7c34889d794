"""RetinaNet's classification and box-regression head in NCHW (counterpart of
``basedet_tpu/layers/head/retina_head.py``): per level, ``num_convs`` 3x3
convs + ReLU in each subnet, then a 3x3 conv to A·num_classes logits and one
to A·4 offsets. With ``share_param`` one set of convs serves every level
(flax names ``cls_subnet_<i>``, ``bbox_subnet_<i>``, ``cls_score``,
``bbox_pred``); without, each level has its own, named with ``_l<level>``
(``cls_subnet_l<lv>_<i>``, ``cls_score_l<lv>``, ...), for
``utils/weights.py``. Every convolution follows the compute policy
(``layers/precision.py``): under bf16 the outputs are bf16. Under
``TRAINER.REMAT`` each level is a segment (``layers/remat.py``).
"""
from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision, remat


class RetinaNetHead(nn.Module):
    def __init__(self, in_channels: int, num_anchors: int, num_classes: int, num_levels: int = 5,
                 num_convs: int = 4, prior_prob: float = 0.01, share_param: bool = True, device=None):
        super().__init__()
        self.num_levels = num_levels
        self.num_convs = num_convs
        self.share_param = share_param
        self.prior_prob = prior_prob

        def conv(cout, name):
            self.add_module(name, nn.Conv2d(in_channels, cout, 3, padding=1, device=device))

        for suffix in ([""] if share_param else [f"_l{lv}" for lv in range(num_levels)]):
            for i in range(num_convs):
                conv(in_channels, f"cls_subnet{suffix}_{i}")
                conv(in_channels, f"bbox_subnet{suffix}_{i}")
            conv(num_anchors * num_classes, f"cls_score{suffix}")
            conv(num_anchors * 4, f"bbox_pred{suffix}")

    def _level(self, lv: int):
        suffix = "" if self.share_param else f"_l{lv}"
        return ([getattr(self, f"cls_subnet{suffix}_{i}") for i in range(self.num_convs)],
                [getattr(self, f"bbox_subnet{suffix}_{i}") for i in range(self.num_convs)],
                getattr(self, f"cls_score{suffix}"), getattr(self, f"bbox_pred{suffix}"))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the flax initialisers draw them: every kernel normal(0.01), biases
        0 but ``cls_score``'s, -log((1 - p) / p) at the prior probability p."""
        bias_value = -math.log((1 - self.prior_prob) / self.prior_prob)
        for name, m in self.named_children():
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.fill_(bias_value if name.startswith("cls_score") else 0.0)

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """features: per level (N, C, H, W) → per level (logits (N, A·num_classes,
        H, W), offsets (N, A·4, H, W))."""
        outs = [remat.segment(functools.partial(self._forward_level, lv), feat)
                for lv, feat in enumerate(features)]
        return [c for c, _ in outs], [b for _, b in outs]

    def _forward_level(self, lv: int, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cls_convs, bbox_convs, cls_score, bbox_pred = self._level(lv)
        c = feat
        for conv in cls_convs:
            c = F.relu(precision.conv2d(conv, c))
        b = feat
        for conv in bbox_convs:
            b = F.relu(precision.conv2d(conv, b))
        return precision.conv2d(cls_score, c), precision.conv2d(bbox_pred, b)
