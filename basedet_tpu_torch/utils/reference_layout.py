"""Synthetic reference-layout state dicts (the port's own copy of
``basedet_tpu/utils/reference_layout.py``, numpy only): the names and shapes
of the reference's RetinaNet R50-FPN checkpoint (ResNet trunk, FPN laterals,
outputs and the ``p6``/``p7`` top block, the ``share_param`` head) with
MegEngine's (1, C, 1, 1) BatchNorm parameter shapes, each value the key's
insertion index, so a misplaced tensor shows; and the same R50 trunk as an
ImageNet classification checkpoint names it (no ``backbone.bottom_up.``
prefix, the 1000-way ``fc`` classifier at the end), the backbone-only file a
detector is trained from.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

R50_STAGES = [(64, 3), (128, 4), (256, 6), (512, 2 + 1)]  # (width, blocks)


def _r50_trunk(add, add_bn, prefix: str) -> None:
    add(f"{prefix}conv1.weight", (64, 3, 7, 7))
    add_bn(f"{prefix}bn1", 64)
    in_c = 64
    for stage_i, (width, blocks) in enumerate(R50_STAGES, start=1):
        out_c = width * 4
        for b in range(blocks):
            p = f"{prefix}layer{stage_i}.{b}"
            add(f"{p}.conv1.weight", (width, in_c if b == 0 else out_c, 1, 1))
            add_bn(f"{p}.bn1", width)
            add(f"{p}.conv2.weight", (width, width, 3, 3))
            add_bn(f"{p}.bn2", width)
            add(f"{p}.conv3.weight", (out_c, width, 1, 1))
            add_bn(f"{p}.bn3", out_c)
            if b == 0:  # downsample Sequential(conv, bn)
                add(f"{p}.downsample.0.weight", (out_c, in_c, 1, 1))
                add_bn(f"{p}.downsample.1", out_c)
        in_c = out_c


def _builder(fill: Optional[Callable[[str, Tuple[int, ...]], np.ndarray]] = None):
    state: Dict[str, np.ndarray] = {}

    def add(name, shape):
        value = np.full(shape, float(len(state))) if fill is None else fill(name, shape)
        state[name] = np.asarray(value, np.float32).reshape(shape)

    def add_bn(prefix, c):
        for field in ("weight", "bias", "running_mean", "running_var"):
            add(f"{prefix}.{field}", (1, c, 1, 1))  # MegEngine BN shape

    return state, add, add_bn


def reference_retinanet_r50_state() -> Dict[str, np.ndarray]:
    """RetinaNet R50-FPN with the reference's exact naming and shapes."""
    state, add, add_bn = _builder()
    _r50_trunk(add, add_bn, "backbone.bottom_up.")
    for stage, c_in in ((3, 512), (4, 1024), (5, 2048)):
        add(f"backbone.fpn_lateral{stage}.weight", (256, c_in, 1, 1))
        add(f"backbone.fpn_lateral{stage}.bias", (256,))
        add(f"backbone.fpn_output{stage}.weight", (256, 256, 3, 3))
        add(f"backbone.fpn_output{stage}.bias", (256,))
    add("backbone.top_block.p6.weight", (256, 2048, 3, 3))
    add("backbone.top_block.p6.bias", (256,))
    add("backbone.top_block.p7.weight", (256, 256, 3, 3))
    add("backbone.top_block.p7.bias", (256,))
    for sub in ("cls_subnet", "bbox_subnet"):
        for i in range(4):
            add(f"head.{sub}.{i}.weight", (256, 256, 3, 3))
            add(f"head.{sub}.{i}.bias", (256,))
    add("head.cls_score.weight", (9 * 80, 256, 3, 3))
    add("head.cls_score.bias", (9 * 80,))
    add("head.bbox_pred.weight", (9 * 4, 256, 3, 3))
    add("head.bbox_pred.bias", (9 * 4,))
    return state


def reference_r50_backbone_state(
    fill: Optional[Callable[[str, Tuple[int, ...]], np.ndarray]] = None
) -> Dict[str, np.ndarray]:
    """The R50 trunk as an ImageNet classification checkpoint names it:
    ``conv1``, ``bn1``, ``layer<s>.<b>.*`` and the ``fc`` classifier, which a
    detector leaves unused. ``fill(name, shape)`` gives each value in place of
    its insertion index (a network that runs needs weights of sensible
    scale)."""
    state, add, add_bn = _builder(fill)
    _r50_trunk(add, add_bn, "")
    add("fc.weight", (1000, 2048))
    add("fc.bias", (1000,))
    return state
