"""Feature Pyramid Network in NCHW (counterpart of ``basedet_tpu/layers/backbone/fpn.py``):
lateral 1x1 and output 3x3 convs over the bottom-up features, a bilinear
top-down pass, and a top block: ``p6``, a stride-2 subsample of the last
level (Faster R-CNN), or ``p6p7``, two 3x3 stride-2 convs, ``fpn_p6`` on
``top_block_in_feature`` (RetinaNet: ``res5``) and ``fpn_p7`` on
``relu(p6)``. Every convolution follows the compute policy
(``layers/precision.py``), and the top-down pass runs in its dtype; under
``TRAINER.REMAT`` the whole pyramid is one segment (``layers/remat.py``).
With a ``norm`` (``GN``, ``BN``, ``SyncBN`` or ``FrozenBN``,
``layers/common/blocks.py::get_norm``) the lateral and output convs lose
their bias and each is followed by the norm, named as flax names it
(``GroupNorm_<i>``, ``BatchNorm_<i>``, ``FrozenBatchNorm_<i>``: for each
level coarse to fine, the lateral's then the output's). Not ported: the
``deconv`` top-down upsampling, which no configuration of the port selects.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision, remat
from basedet_tpu_torch.layers.common.blocks import get_norm

_NORM_NAMES = {"GN": "GroupNorm", "BN": "BatchNorm", "SyncBN": "BatchNorm", "FrozenBN": "FrozenBatchNorm"}


def upsample_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of x to like's spatial size with half-pixel centres,
    as ``jax.image.resize(..., "bilinear")`` upsamples (its border weights
    renormalise to the clamp that ``align_corners=False`` does)."""
    return F.interpolate(x, size=like.shape[-2:], mode="bilinear", align_corners=False)


class FPN(nn.Module):
    """Bottom-up features {name: (B, C_in, H, W)} fine→coarse → {p<k>: (B,
    out_channels, H, W)}, with p<last + 1> (``p6``) or p<last + 1> and
    p<last + 2> (``p6p7``) from the top block; ``p6p7`` reads the bottom-up
    feature ``top_block_in_feature``. Convs are named as the flax ones
    (``fpn_lateral_<name>``, ``fpn_output_<name>``, ``fpn_p6``, ``fpn_p7``)."""

    def __init__(self, in_features: Sequence[str], in_channels: Sequence[int],
                 strides: Sequence[int], out_channels: int = 256, norm=None,
                 top_block: str = "p6", top_block_in_feature: str = "res5", device=None):
        super().__init__()
        if norm and norm not in _NORM_NAMES:
            raise NotImplementedError(f"FPN with norm {norm!r} is not ported to basedet_tpu_torch yet")
        if top_block not in ("p6", "p6p7"):
            raise NotImplementedError(f"FPN top block {top_block!r} is not ported to basedet_tpu_torch yet")
        self.in_features = tuple(in_features)
        self.strides = tuple(strides)
        self.top_block = top_block
        self.top_block_in_feature = top_block_in_feature
        make_norm, bias = get_norm(norm), not norm
        self.norms: Dict[str, str] = {}  # conv name → its norm's module name
        for name, cin in zip(self.in_features, in_channels):
            self.add_module(f"fpn_lateral_{name}", nn.Conv2d(cin, out_channels, 1, bias=bias, device=device))
            self.add_module(f"fpn_output_{name}",
                            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=bias, device=device))
        if norm:  # flax's creation order: per level, coarse → fine, the lateral's norm then the output's
            convs = [f"fpn_{kind}_{name}" for name in self.in_features[::-1] for kind in ("lateral", "output")]
            for i, conv in enumerate(convs):
                self.norms[conv] = f"{_NORM_NAMES[norm]}_{i}"
                self.add_module(self.norms[conv], make_norm(out_channels, device=device))
        if top_block == "p6p7":
            cin = dict(zip(self.in_features, in_channels))[top_block_in_feature]
            self.fpn_p6 = nn.Conv2d(cin, out_channels, 3, 2, padding=1, device=device)
            self.fpn_p7 = nn.Conv2d(out_channels, out_channels, 3, 2, padding=1, device=device)

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return remat.segment(self._pyramid, bottom_up)

    @torch.no_grad()
    def reset_norms(self) -> None:
        """Each norm to the identity, as flax initialises it: scale 1, bias 0,
        running (or frozen) mean 0 and variance 1."""
        for name in self.norms.values():
            m = getattr(self, name)
            if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
                m.reset_parameters()
            else:
                m.weight.fill_(1.0), m.bias.zero_(), m.running_mean.zero_(), m.running_var.fill_(1.0)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = precision.conv2d(getattr(self, name), x)
        return getattr(self, self.norms[name])(y) if name in self.norms else y

    def _pyramid(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        results: List[torch.Tensor] = []
        prev = None
        for name in self.in_features[::-1]:  # coarse → fine
            lateral = self._conv(f"fpn_lateral_{name}", bottom_up[name])
            if prev is not None:
                lateral = lateral + upsample_like(prev, lateral)
            prev = lateral
            results.append(self._conv(f"fpn_output_{name}", lateral))
        out_names = [f"p{int(math.log2(s))}" for s in self.strides]
        outputs = dict(zip(out_names, results[::-1]))
        last = int(math.log2(self.strides[-1]))
        if self.top_block == "p6":
            outputs[f"p{last + 1}"] = outputs[f"p{last}"][:, :, ::2, ::2]
        else:
            p6 = precision.conv2d(self.fpn_p6, bottom_up[self.top_block_in_feature])
            outputs[f"p{last + 1}"] = p6
            outputs[f"p{last + 2}"] = precision.conv2d(self.fpn_p7, F.relu(p6))
        return outputs
