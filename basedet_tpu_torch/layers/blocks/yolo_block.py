"""YOLO building blocks in NCHW (counterpart of ``basedet_tpu/layers/blocks/yolo_block.py``).

Each submodule carries the name of its flax counterpart (``conv``, ``m_0``,
``dconv``...), with the flax ``BatchNorm_0`` called ``bn``, so that
``utils/weights.py`` maps the JAX variable tree onto ``state_dict()`` keys by
name alone. Convolutions and BatchNorm follow the compute-dtype policy
(``layers/precision.py``); under bf16 with ``TRAINER.AMP.FUSED_BN`` a
train-mode dense SiLU ``CSPLayer`` runs the fused-BN chain
(``layers/blocks/csp_fused.py``) on the same submodules.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision
from basedet_tpu_torch.layers.blocks.csp_fused import csp_layer_fused
from basedet_tpu_torch.layers.common.blocks import FlaxBatchNorm2d, get_activation


class ConvBNAct(nn.Module):
    """Conv (no bias) + BatchNorm + activation: ``_ConvBNAct``. BN eps is
    YOLOX's 1e-3 (not ``cfg.MODEL.BN_EPS``, as in the JAX package), and its
    momentum the flax decay 0.97, which torch writes as 0.03."""

    def __init__(self, in_channels, out_channels, ksize=1, stride=1, groups=1,
                 act="silu", device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, ksize, stride, (ksize - 1) // 2,
                              groups=groups, bias=False, device=device)
        self.bn = FlaxBatchNorm2d(out_channels, eps=1e-3, momentum=0.03, device=device)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.bn(precision.conv2d(self.conv, x)))


class DepthwiseConvBlock(nn.Module):
    def __init__(self, in_channels, out_channels, ksize=3, stride=1, act="silu", device=None):
        super().__init__()
        self.dconv = ConvBNAct(in_channels, in_channels, ksize, stride, groups=in_channels,
                               act=act, device=device)
        self.pconv = ConvBNAct(in_channels, out_channels, 1, 1, act=act, device=device)

    def forward(self, x):
        return self.pconv(self.dconv(x))


def make_conv(depthwise: bool):
    return DepthwiseConvBlock if depthwise else ConvBNAct


class Focus(nn.Module):
    """Space-to-depth stem: the 2x2 pixel de-interleave packs channel block
    ``2*dx + dy`` (the reference's tl, bl, tr, br concat), then a kxk
    stride-1 ConvBNAct over 4C channels."""

    def __init__(self, in_channels, out_channels, ksize=3, act="silu", device=None):
        super().__init__()
        self.conv = ConvBNAct(4 * in_channels, out_channels, ksize, 1, act=act, device=device)

    def forward(self, x):
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // 2, 2, W // 2, 2)            # (B, C, i, dy, j, dx)
        x = x.permute(0, 5, 3, 1, 2, 4).reshape(B, 4 * C, H // 2, W // 2)
        return self.conv(x)


class SPPBottleneck(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_sizes: Sequence[int] = (5, 9, 13),
                 act="silu", device=None):
        super().__init__()
        hidden = in_channels // 2
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = ConvBNAct(in_channels, hidden, 1, 1, act=act, device=device)
        self.conv2 = ConvBNAct(hidden * (len(self.kernel_sizes) + 1), out_channels, 1, 1,
                               act=act, device=device)

    def forward(self, x):
        x = self.conv1(x)
        pools = [F.max_pool2d(x, ks, 1, ks // 2) for ks in self.kernel_sizes]
        return self.conv2(torch.cat([x, *pools], dim=1))


class Bottleneck(nn.Module):
    def __init__(self, in_channels, out_channels, shortcut=True, expansion=0.5,
                 depthwise=False, act="silu", device=None):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, 1, 1, act=act, device=device)
        self.conv2 = make_conv(depthwise)(hidden, out_channels, 3, 1, act=act, device=device)
        self.use_add = shortcut and in_channels == out_channels

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """C3: CSP bottleneck with 3 convs."""

    def __init__(self, in_channels, out_channels, n=1, shortcut=True, expansion=0.5,
                 depthwise=False, act="silu", device=None):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvBNAct(in_channels, hidden, 1, 1, act=act, device=device)
        self.conv2 = ConvBNAct(in_channels, hidden, 1, 1, act=act, device=device)
        self.n = n
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(hidden, hidden, shortcut, 1.0, depthwise,
                                                 act, device=device))
        self.conv3 = ConvBNAct(2 * hidden, out_channels, 1, 1, act=act, device=device)
        self.shortcut = shortcut
        # the fused chain's gate, besides train mode and the policy
        self.fusable = not depthwise and act == "silu"

    def forward(self, x):
        if self.fusable and self.training and precision.fused_bn_enabled():
            return self._fused(x)
        x1 = self.conv1(x)
        for i in range(self.n):
            x1 = getattr(self, f"m_{i}")(x1)
        return self.conv3(torch.cat([x1, self.conv2(x)], dim=1))

    def _blocks(self):
        """(key, ConvBNAct) of every conv, in ``csp_layer_fused``'s names."""
        yield "conv1", self.conv1
        yield "conv2", self.conv2
        for i in range(self.n):
            m = getattr(self, f"m_{i}")
            yield f"m{i}a", m.conv1
            yield f"m{i}b", m.conv2
        yield "conv3", self.conv3

    def fused_params(self):
        """This layer's parameters under ``csp_layer_fused``'s keys
        (``{conv1,conv2,m{i}a,m{i}b,conv3}/{w,g,b}``), the tensors themselves."""
        return {f"{key}/{p}": t for key, block in self._blocks()
                for p, t in (("w", block.conv.weight), ("g", block.bn.weight), ("b", block.bn.bias))}

    def _fused(self, x):
        """The fused-BN chain on this layer's own parameters, then flax's
        running-statistics update (momentum 0.97) from its batch moments."""
        out, moments = csp_layer_fused(self.fused_params(), x, self.n, shortcut=self.shortcut,
                                       eps=self.conv1.bn.eps)
        for key, block in self._blocks():
            block.bn.update_running(*moments[key])
        return out
