"""YOLOv3's embedding FPN in NCHW (counterpart of
``basedet_tpu/layers/backbone/yolo_fpn.py``): per branch six ConvBNActs
whose fifth output taps the lateral path, then a 1x1 prediction conv; the
branches run coarse to fine, each after a nearest 2x upsample of the
previous tap's lateral conv, concatenated with the finer feature.

The ConvBNActs follow the compute policy (``layers/precision.py``); the
prediction conv is the JAX package's plain ``nn.Conv`` (no ``dtype=``), so
under bf16 it promotes its input and gives f32."""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.layers.blocks.yolo_block import DARKNET_KW, ConvBNAct


class YOLOFPN(nn.Module):
    """in_channels: the bottom-up features fine to coarse (dark3, dark4,
    dark5); out_channels and mid_channels ((ch1, ch2) per branch) coarse to
    fine, as the outputs run."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 mid_channels: Sequence[Sequence[int]], device=None):
        super().__init__()
        ins = list(in_channels)[::-1]  # coarse to fine
        self.num_levels = len(ins)
        for idx in range(self.num_levels):
            ch1, ch2 = mid_channels[idx]
            c = ins[idx]
            if idx:
                lat = mid_channels[idx][0]
                self.add_module(f"lateral_conv{idx}",
                                ConvBNAct(mid_channels[idx - 1][0], lat, 1, 1, **DARKNET_KW, device=device))
                c += lat
            for i, (co, k) in enumerate([(ch1, 1), (ch2, 3), (ch1, 1), (ch2, 3), (ch1, 1), (ch2, 3)]):
                self.add_module(f"output_conv{idx}_conv{i}", ConvBNAct(c, co, k, 1, **DARKNET_KW, device=device))
                c = co
            self.add_module(f"output_conv{idx}_pred", nn.Conv2d(c, out_channels[idx], 1, device=device))

    def _branch(self, x, idx):
        for i in range(6):
            x = getattr(self, f"output_conv{idx}_conv{i}")(x)
            if i == 4:
                tap = x
        return precision.promoted(getattr(self, f"output_conv{idx}_pred"), x), tap

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        feats = list(features)[::-1]
        out, tap = self._branch(feats[0], 0)
        outs = [out]
        for idx in range(1, self.num_levels):
            lat = F.interpolate(getattr(self, f"lateral_conv{idx}")(tap), scale_factor=2, mode="nearest")
            out, tap = self._branch(torch.cat([lat, feats[idx]], dim=1), idx)
            outs.append(out)
        return outs
