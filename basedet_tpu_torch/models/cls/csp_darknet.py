"""CSPDarknet backbone in NCHW (counterpart of ``basedet_tpu/models/cls/csp_darknet.py``):
Focus stem, then dark2..dark5 (stride-2 conv + CSP layers; SPP in dark5)."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from basedet_tpu_torch.layers.blocks.yolo_block import CSPLayer, Focus, SPPBottleneck, make_conv


def csp_darknet_feature_channels(width_factor: float = 1.0) -> Dict[str, int]:
    base_c = int(width_factor * 64)
    return {"stem": base_c, "dark2": base_c * 2, "dark3": base_c * 4, "dark4": base_c * 8, "dark5": base_c * 16}


class CSPDarknet(nn.Module):
    def __init__(self, depth_factor=1.0, width_factor=1.0,
                 out_features: Sequence[str] = ("dark3", "dark4", "dark5"),
                 depthwise=False, act="silu", device=None):
        super().__init__()
        Conv = make_conv(depthwise)
        base_depth = max(round(depth_factor * 3), 1)
        base_c = int(width_factor * 64)
        self.out_features = tuple(out_features)
        self.stem = Focus(3, base_c, 3, act=act, device=device)
        specs = [
            ("dark2", base_c * 2, base_depth, True, False),
            ("dark3", base_c * 4, base_depth * 3, True, False),
            ("dark4", base_c * 8, base_depth * 3, True, False),
            ("dark5", base_c * 16, base_depth, False, True),
        ]
        self.stages = [name for name, *_ in specs]
        prev = base_c
        for name, ch, n, shortcut, with_spp in specs:
            self.add_module(f"{name}_conv", Conv(prev, ch, 3, 2, act=act, device=device))
            if with_spp:
                self.add_module(f"{name}_spp", SPPBottleneck(ch, ch, act=act, device=device))
            self.add_module(f"{name}_csp", CSPLayer(ch, ch, n=n, shortcut=shortcut,
                                                    depthwise=depthwise, act=act, device=device))
            prev = ch

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {"stem": self.stem(x)}
        x = outputs["stem"]
        for name in self.stages:
            x = getattr(self, f"{name}_conv")(x)
            if hasattr(self, f"{name}_spp"):
                x = getattr(self, f"{name}_spp")(x)
            x = getattr(self, f"{name}_csp")(x)
            outputs[name] = x
        return {k: v for k, v in outputs.items() if k in self.out_features}
