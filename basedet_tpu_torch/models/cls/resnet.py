"""ResNet backbones in NCHW (counterpart of ``basedet_tpu/models/cls/resnet.py``):
torchvision-style v1.5 (stride on the 3x3 conv of Bottleneck), returning the
features named in ``out_features`` from {stem, res2, res3, res4, res5}.

The stem is a plain 7x7/2 convolution with padding 3, then a 3x3/2 max-pool
with padding 1: the JAX package computes the same operator on a
space-to-depth packing (``ops/s2d_conv.py``), a TPU layout that is not
ported. Submodules carry the flax names (``conv1``, ``layer1_0``,
``downsample_conv``, and a block's norms ``FrozenBatchNorm_<i>`` or, under
``norm="BN"``, ``BatchNorm_<i>`` in call order; the stem's lone train-mode
``BatchNorm_0`` is ``bn``, as ``utils/weights.py`` names a parent's only BN),
so that ``utils/weights.py`` maps the variable tree by name. ``freeze_at``
stops gradients at the stage boundary, as ``lax.stop_gradient`` does there,
and turns ``requires_grad`` off for the frozen stages' weights; 0 freezes
nothing.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers.common.blocks import get_norm

_STAGE_SPECS = {
    "resnet10": ("basic", (1, 1, 1, 1)),
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}
_EXPANSION = {"basic": 1, "bottleneck": 4}


def resnet_feature_channels(name: str) -> Dict[str, int]:
    e = _EXPANSION[_STAGE_SPECS[name][0]]
    return {"stem": 64, "res2": 64 * e, "res3": 128 * e, "res4": 256 * e, "res5": 512 * e}


def _conv(cin, cout, k, stride=1, device=None):
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False, device=device)


class _Block(nn.Module):
    """Shared forward of both block types: convs in order, each followed by
    its norm (ReLU between), then the projected or identity shortcut."""

    def _add_norms(self, norm: str, channels, device):
        prefix = "FrozenBatchNorm_" if norm == "FrozenBN" else "BatchNorm_"
        self.norms = [f"{prefix}{i}" for i in range(len(channels))]
        for name, c in zip(self.norms, channels):
            self.add_module(name, get_norm(norm)(c, device=device))

    def forward(self, x):
        y = x
        for i, conv in enumerate(self.convs):
            y = getattr(self, self.norms[i])(getattr(self, conv)(y))
            if i < len(self.convs) - 1:
                y = F.relu(y)
        identity = x
        if self.has_downsample:
            identity = getattr(self, self.norms[len(self.convs)])(self.downsample_conv(x))
        return F.relu(y + identity)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin, channels, stride=1, norm="FrozenBN", device=None):
        super().__init__()
        self.convs = ("conv1", "conv2")
        self.conv1 = _conv(cin, channels, 3, stride, device)
        self.conv2 = _conv(channels, channels, 3, 1, device)
        self.has_downsample = cin != channels or stride != 1
        if self.has_downsample:
            self.downsample_conv = _conv(cin, channels, 1, stride, device)
        self._add_norms(norm, [channels] * (3 if self.has_downsample else 2), device)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, cin, channels, stride=1, norm="FrozenBN", device=None):
        super().__init__()
        out_c = channels * 4
        self.convs = ("conv1", "conv2", "conv3")
        self.conv1 = _conv(cin, channels, 1, 1, device)
        self.conv2 = _conv(channels, channels, 3, stride, device)
        self.conv3 = _conv(channels, out_c, 1, 1, device)
        self.has_downsample = cin != out_c or stride != 1
        if self.has_downsample:
            self.downsample_conv = _conv(cin, out_c, 1, stride, device)
        norms = [channels, channels, out_c] + ([out_c] if self.has_downsample else [])
        self._add_norms(norm, norms, device)


class ResNet(nn.Module):
    def __init__(self, arch: str = "resnet50", norm: str = "FrozenBN", freeze_at: int = 2,
                 out_features: Sequence[str] = ("res3", "res4", "res5"), device=None):
        super().__init__()
        block_type, stage_sizes = _STAGE_SPECS[arch]
        block = BasicBlock if block_type == "basic" else Bottleneck
        self.freeze_at = freeze_at
        self.out_features = tuple(out_features)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=device)
        self.stem_norm = "FrozenBatchNorm_0" if norm == "FrozenBN" else "bn"
        self.add_module(self.stem_norm, get_norm(norm)(64, device=device))
        self.stages = []
        cin = 64
        for s, (n_blocks, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            names = []
            for b in range(n_blocks):
                name = f"layer{s + 1}_{b}"
                stride = 2 if s > 0 and b == 0 else 1
                self.add_module(name, block(cin, width, stride, norm, device))
                cin = width * block.expansion
                names.append(name)
            self.stages.append(names)
        frozen = [self.conv1] + [getattr(self, n) for stage in self.stages[:freeze_at - 1] for n in stage]
        for m in frozen if freeze_at >= 1 else ():
            m.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(getattr(self, self.stem_norm)(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        if self.freeze_at >= 1:
            y = y.detach()
        feats = {"stem": y}
        for s, names in enumerate(self.stages):
            for name in names:
                y = getattr(self, name)(y)
            if self.freeze_at >= s + 2:
                y = y.detach()
            feats[f"res{s + 2}"] = y
        return {k: feats[k] for k in self.out_features}
