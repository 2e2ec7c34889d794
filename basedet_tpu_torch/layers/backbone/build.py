"""Backbone dispatch by config name (counterpart of
``basedet_tpu/layers/backbone/build.py``): ``resnet<depth>``,
``darknet<depth>`` (YOLOv3's Darknet, ``models/cls/darknet.py``, at its
default width) and ``csp_darknet`` (YOLOX's CSPDarknet at depth and width
factor 1), as the JAX package names them, and :func:`feature_channels`, the
widths of their features, from which the FPN detectors size their laterals
where flax reads them off the inputs. Not ported: the ``hf_`` adaptor and
backbones registered by model name."""
from __future__ import annotations

from typing import Dict, Sequence


def make_backbone(name: str, out_features: Sequence[str] = (), norm: str = "FrozenBN",
                  freeze_at: int = 0, device=None):
    # imported here: basedet_tpu_torch.models imports the detectors, which import this
    if name.startswith("resnet"):
        from basedet_tpu_torch.models.cls.resnet import ResNet

        return ResNet(arch=name, norm=norm, freeze_at=freeze_at, out_features=out_features,
                      device=device)
    if name.startswith("darknet"):
        from basedet_tpu_torch.models.cls.darknet import Darknet

        return Darknet(depth=int(name[len("darknet"):]), out_features=out_features, device=device)
    if name == "csp_darknet":
        from basedet_tpu_torch.models.cls.csp_darknet import CSPDarknet

        return CSPDarknet(out_features=out_features, device=device)
    raise NotImplementedError(f"backbone {name!r} is not ported to basedet_tpu_torch yet")


def feature_channels(name: str) -> Dict[str, int]:
    """{feature name: channels} of the backbone that :func:`make_backbone`
    builds for ``name``."""
    if name.startswith("resnet"):
        from basedet_tpu_torch.models.cls.resnet import resnet_feature_channels

        return resnet_feature_channels(name)
    if name.startswith("darknet"):
        from basedet_tpu_torch.models.cls.darknet import darknet_feature_channels

        return darknet_feature_channels()
    if name == "csp_darknet":
        from basedet_tpu_torch.models.cls.csp_darknet import csp_darknet_feature_channels

        return csp_darknet_feature_channels()
    raise NotImplementedError(f"backbone {name!r} is not ported to basedet_tpu_torch yet")
