"""The FCOS family's point head in NCHW (counterpart of
``basedet_tpu/layers/head/point_head.py``): per level, ``num_convs`` 3x3
convs, each followed by GroupNorm(32) (with ``with_norm``) and ReLU, in a
class subnet and a box subnet; a 3x3 conv to the class logits on the first,
and on the second one to four offsets and one to the centerness (OTA reads it
as the predicted IoU). The offsets decode by ``relu(raw · scale) · stride``
(``relu_scale``) or ``exp(raw · scale)`` (``exp_scale``, OTA without
``NORM_REG_TARGETS``), with one learnt ``scales`` entry per level.

Submodules keep the flax names (``cls_subnet_<i>``, ``bbox_subnet_<i>``,
``cls_gn_<i>``, ``bbox_gn_<i>``, ``cls_score``, ``bbox_pred``, ``ctrness``;
with ``share_param`` False each level has its own, ``_l<lv>`` before the
index: ``cls_subnet_l<lv>_<i>``, ``cls_score_l<lv>``) for
``utils/weights.py``. GroupNorm takes flax's epsilon, 1e-6 (torch's default
is 1e-5).

Under the compute policy (``layers/precision.py``) the convolutions run in
bf16, while GroupNorm and the ``scales``, which the JAX package builds with no
``dtype=``, promote: a bf16 input gives an f32 output. So the subnets' convs
take f32 inputs after the first, the offsets come out f32, and the logits and
centerness bf16. Under ``TRAINER.REMAT`` each level is a segment
(``layers/remat.py``).
"""
from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision, remat

GN_GROUPS = 32
GN_EPS = 1e-6  # flax nn.GroupNorm's default


class PointHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, strides: Sequence[int] = (8, 16, 32, 64, 128),
                 num_anchors: int = 1, num_convs: int = 4, prior_prob: float = 0.01, with_norm: bool = True,
                 share_param: bool = True, decode_mode: str = "relu_scale", device=None):
        super().__init__()
        if decode_mode not in ("relu_scale", "exp_scale"):
            raise ValueError(f"decode_mode {decode_mode!r} is not relu_scale or exp_scale")
        self.strides = tuple(strides)
        self.num_convs = num_convs
        self.with_norm = with_norm
        self.share_param = share_param
        self.decode_mode = decode_mode
        self.prior_prob = prior_prob

        def conv(cout, name):
            self.add_module(name, nn.Conv2d(in_channels, cout, 3, padding=1, device=device))

        for suffix in self._suffixes():
            for i in range(num_convs):
                conv(in_channels, f"cls_subnet{suffix}_{i}")
                conv(in_channels, f"bbox_subnet{suffix}_{i}")
                if with_norm:
                    for kind in ("cls", "bbox"):
                        self.add_module(f"{kind}_gn{suffix}_{i}",
                                        nn.GroupNorm(GN_GROUPS, in_channels, eps=GN_EPS, device=device))
            conv(num_anchors * num_classes, f"cls_score{suffix}")
            conv(num_anchors * 4, f"bbox_pred{suffix}")
            conv(num_anchors, f"ctrness{suffix}")
        self.scales = nn.Parameter(torch.ones(len(self.strides), device=device))

    def _suffixes(self) -> List[str]:
        return [""] if self.share_param else [f"_l{lv}" for lv in range(len(self.strides))]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """As the flax initialisers draw them: every conv kernel normal(0.01),
        biases 0 but ``cls_score``'s, -log((1 - p) / p) at the prior
        probability p; GroupNorm the identity; ``scales`` 1."""
        bias_value = -math.log((1 - self.prior_prob) / self.prior_prob)
        for name, m in self.named_children():
            if isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0), m.bias.zero_()
                continue
            m.weight.normal_(0.0, 0.01, generator=generator)
            m.bias.fill_(bias_value if name.startswith("cls_score") else 0.0)
        self.scales.fill_(1.0)

    def _subnet(self, x: torch.Tensor, kind: str, suffix: str) -> torch.Tensor:
        for i in range(self.num_convs):
            x = precision.conv2d(getattr(self, f"{kind}_subnet{suffix}_{i}"), x)
            if self.with_norm:
                x = precision.promoted(getattr(self, f"{kind}_gn{suffix}_{i}"), x)
            x = F.relu(x)
        return x

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                                                  List[torch.Tensor]]:
        """features: per level (N, C, H, W) → per level (logits (N, A·classes,
        H, W), decoded offsets (N, A·4, H, W), centerness (N, A, H, W))."""
        outs = [remat.segment(functools.partial(self._forward_level, lv), feat) for lv, feat in enumerate(features)]
        return tuple([out[k] for out in outs] for k in range(3))

    def _forward_level(self, lv: int, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        suffix = "" if self.share_param else f"_l{lv}"
        c = self._subnet(feat, "cls", suffix)
        b = self._subnet(feat, "bbox", suffix)
        logits = precision.conv2d(getattr(self, f"cls_score{suffix}"), c)
        # the f32 scale promotes a bf16 output, as jnp does (a 0-dim tensor would not)
        raw = precision.conv2d(getattr(self, f"bbox_pred{suffix}"), b).float() * self.scales[lv]
        offsets = F.relu(raw) * self.strides[lv] if self.decode_mode == "relu_scale" else torch.exp(raw)
        return logits, offsets, precision.conv2d(getattr(self, f"ctrness{suffix}"), b)
