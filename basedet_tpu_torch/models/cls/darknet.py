"""Darknet-21/53 backbone in NCHW (counterpart of ``basedet_tpu/models/cls/darknet.py``):
a conv-BN-LeakyReLU(0.1) stem and five stride-2 stages of residual
``DarknetBlock``s. Every BN has eps 1e-5 and the flax decay 0.9 (torch
momentum 0.1). Submodules keep the flax names (``stem``, ``dark<i>_down``,
``dark<i>_block<b>/layer1|layer2``)."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from basedet_tpu_torch.layers.blocks.yolo_block import DARKNET_KW, ConvBNAct

DEPTH2BLOCKS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}


def darknet_feature_channels(out_channels: int = 32) -> Dict[str, int]:
    chans = {"stem": out_channels}
    c = out_channels
    for i in range(5):
        c *= 2
        chans[f"dark{i + 1}"] = c
    return chans


class DarknetBlock(nn.Module):
    """x + 3x3(1x1(x)), the 1x1 halving the channels."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.layer1 = ConvBNAct(channels, channels // 2, 1, 1, **DARKNET_KW, device=device)
        self.layer2 = ConvBNAct(channels // 2, channels, 3, 1, **DARKNET_KW, device=device)

    def forward(self, x):
        return x + self.layer2(self.layer1(x))


class Darknet(nn.Module):
    def __init__(self, depth: int = 53, out_channels: int = 32,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"), device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        self.blocks = DEPTH2BLOCKS[depth]
        self.stem = ConvBNAct(3, out_channels, 3, 1, **DARKNET_KW, device=device)
        c = out_channels
        for i, n_blocks in enumerate(self.blocks):
            self.add_module(f"dark{i + 1}_down", ConvBNAct(c, 2 * c, 3, 2, **DARKNET_KW, device=device))
            c *= 2
            for b in range(n_blocks):
                self.add_module(f"dark{i + 1}_block{b}", DarknetBlock(c, device=device))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outputs = {"stem": x}
        for i, n_blocks in enumerate(self.blocks):
            name = f"dark{i + 1}"
            x = getattr(self, f"{name}_down")(x)
            for b in range(n_blocks):
                x = getattr(self, f"{name}_block{b}")(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
