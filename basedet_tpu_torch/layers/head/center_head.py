"""CenterNet's upsampling neck and heads in NCHW (counterpart of
``basedet_tpu/layers/head/center_head.py``).

``DeconvLayer``: DCN → BN → ReLU → 4x4 stride-2 transposed convolution with
the bilinear init → BN → ReLU. The transposed convolution is torch's own
``ConvTranspose2d(k=4, s=2, p=1)``, the operator that the JAX package
reproduces with ``ops/subpixel.py``, a TPU factorisation that is not ported;
it runs on cuDNN, as the JAX package leaves it outside Pallas. Submodules
carry the flax names (``dcn``, ``BatchNorm_0``, ``up_sample``,
``BatchNorm_1``; ``deconv<i>``; ``feat_conv``, ``out_conv``) for
``utils/weights.py``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers.blocks.deformable import DeformConv, ModulatedDeformConv
from basedet_tpu_torch.layers.common.blocks import get_norm


def bilinear_upsample_kernel(k: int, channels: int) -> np.ndarray:
    """The bilinear-interpolation transposed-conv kernel, as
    ``ConvTranspose2d.weight`` (Ci, Co, k, k): one filter on the diagonal."""
    f = math.ceil(k / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w = np.zeros((k, k), np.float32)
    for i in range(k):
        for j in range(k):
            w[i, j] = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
    kernel = np.zeros((channels, channels, k, k), np.float32)
    for ch in range(channels):
        kernel[ch, ch] = w
    return kernel


def _lecun_normal(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """flax's default conv init (normal in place of truncated normal), bias 0."""
    conv.weight.normal_(0.0, math.sqrt(1.0 / conv.weight[0].numel()), generator=generator)
    if conv.bias is not None:
        conv.bias.zero_()


class DeconvLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, deconv_kernel: int = 4,
                 modulate_deform: bool = True, device=None):
        super().__init__()
        if deconv_kernel != 4:
            raise ValueError("CenterNet's deconvolutions are 4x4")
        bn = get_norm("BN")
        self.dcn = (ModulatedDeformConv(in_channels, out_channels, device=device) if modulate_deform
                    else DeformConv(in_channels, out_channels, device=device))
        self.BatchNorm_0 = bn(out_channels, device=device)
        self.up_sample = nn.ConvTranspose2d(out_channels, out_channels, 4, stride=2, padding=1,
                                            bias=False, device=device)
        self.BatchNorm_1 = bn(out_channels, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.dcn.init_weights(generator)
        self.up_sample.weight.copy_(torch.from_numpy(
            bilinear_upsample_kernel(4, self.up_sample.weight.shape[0])))
        self.BatchNorm_0.reset_parameters()
        self.BatchNorm_1.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.dcn(x)))
        return F.relu(self.BatchNorm_1(self.up_sample(x)))


class CenternetDeconv(nn.Module):
    """``deconv1`` ... ``deconv<n>``: ``channels[0]`` in, ``channels[i]`` out
    of stage i."""

    def __init__(self, channels: Sequence[int] = (2048, 256, 128, 64),
                 deconv_kernels: Sequence[int] = (4, 4, 4), modulate_deform: bool = True,
                 device=None):
        super().__init__()
        self.n = len(deconv_kernels)
        for i, k in enumerate(deconv_kernels):
            self.add_module(f"deconv{i + 1}", DeconvLayer(channels[i], channels[i + 1], k,
                                                          modulate_deform, device))

    def stages(self):
        return [getattr(self, f"deconv{i + 1}") for i in range(self.n)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in self.stages():
            x = stage(x)
        return x


class SingleHead(nn.Module):
    """3x3 conv with ReLU, then a 1x1 conv whose bias starts at ``bias_value``."""

    def __init__(self, in_channels: int, out_channels: int, bias_value: float = 0.0, device=None):
        super().__init__()
        self.bias_value = bias_value
        self.feat_conv = nn.Conv2d(in_channels, in_channels, 3, padding=1, device=device)
        self.out_conv = nn.Conv2d(in_channels, out_channels, 1, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal(self.feat_conv, generator)
        _lecun_normal(self.out_conv, generator)
        self.out_conv.bias.fill_(self.bias_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_conv(F.relu(self.feat_conv(x)))


class CenterHead(nn.Module):
    """``cls`` (sigmoid), ``wh`` and ``reg`` maps, each NCHW."""

    def __init__(self, in_channels: int, num_classes: int = 80, prior_prob: float = 0.1,
                 device=None):
        super().__init__()
        bias_value = -math.log((1 - prior_prob) / prior_prob)
        self.cls_head = SingleHead(in_channels, num_classes, bias_value, device=device)
        self.wh_head = SingleHead(in_channels, 2, device=device)
        self.reg_head = SingleHead(in_channels, 2, device=device)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"cls": torch.sigmoid(self.cls_head(x)), "wh": self.wh_head(x),
                "reg": self.reg_head(x)}
