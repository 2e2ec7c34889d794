"""Reference-layout (torch/MegEngine) state dicts → the port's ``state_dict``
(counterpart of ``basedet_tpu/utils/convert_weights.py``).

The port keeps torch's layouts: conv kernels stay OIHW, ``Linear`` weights
(out, in), ``ConvTranspose2d`` weights (Ci, Co, kh, kw), and BN leaves keep
their torch names (``weight``, ``bias``, ``running_mean``, ``running_var``),
which are also the port's ``FrozenBatchNorm`` buffers. What carries across is
the renames and MegEngine's ``(1, C, 1, 1)`` BN shapes, flattened to (C,);
the matcher (``utils/checkpoint.py``) then resolves suffixes and shapes.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from .checkpoint import as_tensor, unwarp_ckpt


def convert_torch_style_state(state: Mapping) -> Dict[str, torch.Tensor]:
    """A flat torch/MegEngine state dict as tensors, the parameters of every
    module with running statistics (a BN) flattened to 1-D."""
    state = unwarp_ckpt(state)
    bn_prefixes = {k[: -len(".running_mean")] for k in state if k.endswith(".running_mean")}
    out = {}
    for key, value in state.items():
        t = as_tensor(value)
        out[key] = t.reshape(-1) if key.rsplit(".", 1)[0] in bn_prefixes else t
    return out


def convert_reference_detector_state(state: Mapping) -> Dict[str, torch.Tensor]:
    """The reference (MegEngine basedet) detector naming → the port's names,
    the JAX package's renames with dots:

      * the ``backbone.`` wrapper goes: the trunk lives under ``bottom_up``,
        the FPN convs and its top block under ``fpn``
        (``fpn_lateral3`` → ``fpn.fpn_lateral_res3``, ``top_block.p6`` →
        ``fpn.fpn_p6``);
      * BN submodules take the names of the blocks' norms in call order:
        ``bn1`` → ``FrozenBatchNorm_0``, ``bn2`` → ``_1``[, ``bn3`` → ``_2``],
        ``downsample.1`` → the last; ``downsample.0`` → ``downsample_conv``;
      * Sequential indices flatten: ``layer1.0.`` → ``layer1_0.``,
        ``cls_subnet.2.`` → ``cls_subnet_2.``.

    A name of the port's own ``state_dict`` without a ``.<index>.`` part
    passes through unchanged; ``BaseNet.load_weights`` keeps the port's own
    names out of these renames."""
    state = unwarp_ckpt(state)
    ds_bn = "FrozenBatchNorm_3" if any(".bn3." in k for k in state) else "FrozenBatchNorm_2"
    renamed = {}
    for key, value in state.items():
        k = re.sub(r"^backbone\.bottom_up\.", "bottom_up.", key)
        k = re.sub(r"^backbone\.top_block\.(p\d)\.", r"fpn.fpn_\1.", k)
        k = re.sub(r"^backbone\.fpn_lateral(\d)\.", r"fpn.fpn_lateral_res\1.", k)
        k = re.sub(r"^backbone\.fpn_output(\d)\.", r"fpn.fpn_output_res\1.", k)
        k = re.sub(r"\.downsample\.0\.", ".downsample_conv.", k)
        k = re.sub(r"\.downsample\.1\.", f".{ds_bn}.", k)
        k = re.sub(r"\.bn(\d)\.", lambda m: f".FrozenBatchNorm_{int(m.group(1)) - 1}.", k)
        k = re.sub(r"^bn(\d)\.", lambda m: f"FrozenBatchNorm_{int(m.group(1)) - 1}.", k)
        k = re.sub(r"\.(\d+)\.", r"_\1.", k)
        renamed[k] = value
    return convert_torch_style_state(renamed)

