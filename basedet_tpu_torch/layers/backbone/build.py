"""Backbone dispatch by config name (counterpart of
``basedet_tpu/layers/backbone/build.py``). The port has the ResNet family;
YOLOX builds its CSPDarknet itself."""
from __future__ import annotations

from typing import Sequence


def make_backbone(name: str, out_features: Sequence[str] = (), norm: str = "FrozenBN",
                  freeze_at: int = 0, device=None):
    if name.startswith("resnet"):
        # imported here: basedet_tpu_torch.models imports the detectors, which import this
        from basedet_tpu_torch.models.cls.resnet import ResNet

        return ResNet(arch=name, norm=norm, freeze_at=freeze_at, out_features=out_features,
                      device=device)
    raise NotImplementedError(f"backbone {name!r} is not ported to basedet_tpu_torch yet")
