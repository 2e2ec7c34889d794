"""Backbone dispatch by config name (counterpart of
``basedet_tpu/layers/backbone/build.py``): ``hf_<preset>`` (the HF zoo's
ResNet or RegNet, ``layers/backbone/hf_adaptor.py``), ``resnet<depth>``,
``darknet<depth>`` (YOLOv3's Darknet, ``models/cls/darknet.py``, at its
default width), ``csp_darknet`` (YOLOX's CSPDarknet at depth and width
factor 1), as the JAX package names them, or a name registered in
``registers.models``, whose object is returned as it is (the JAX branch's
behaviour); and :func:`feature_channels`, the widths of their features, from
which the detectors size their laterals and projections where flax reads
them off the inputs. A registered backbone gives its widths as a
``feature_channels`` attribute (a dict or a function of no argument)."""
from __future__ import annotations

from typing import Dict, Sequence

_HF = "hf_"


def make_backbone(name: str, out_features: Sequence[str] = (), norm: str = "FrozenBN",
                  freeze_at: int = 0, device=None):
    """The backbone for ``name``; the HF zoo ignores ``norm`` and
    ``freeze_at`` (its BNs train), as the JAX adapter does."""
    # imported here: basedet_tpu_torch.models imports the detectors, which import this
    if name.startswith(_HF):
        from basedet_tpu_torch.layers.backbone.hf_adaptor import HFBackboneAdapter

        return HFBackboneAdapter(name[len(_HF):], out_features=tuple(out_features) or ("res3", "res4", "res5"),
                                 device=device)
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
    return _registered(name)


def feature_channels(name: str) -> Dict[str, int]:
    """{feature name: channels} of the backbone that :func:`make_backbone`
    builds for ``name``."""
    if name.startswith(_HF):
        from basedet_tpu_torch.layers.backbone.hf_adaptor import hf_feature_channels

        return hf_feature_channels(name[len(_HF):])
    if name.startswith("resnet"):
        from basedet_tpu_torch.models.cls.resnet import resnet_feature_channels

        return resnet_feature_channels(name)
    if name.startswith("darknet"):
        from basedet_tpu_torch.models.cls.darknet import darknet_feature_channels

        return darknet_feature_channels()
    if name == "csp_darknet":
        from basedet_tpu_torch.models.cls.csp_darknet import csp_darknet_feature_channels

        return csp_darknet_feature_channels()
    channels = getattr(_registered(name), "feature_channels", None)
    if channels is None:
        raise ValueError(f"registered backbone {name!r} has no feature_channels")
    return dict(channels() if callable(channels) else channels)


def _registered(name: str):
    from basedet_tpu_torch.utils.registry import registers

    if name in registers.models:
        return registers.models.get(name)
    raise ValueError(f"unknown backbone {name!r}")
