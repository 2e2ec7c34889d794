"""State-dict surgery: rename, conv+BN fusion for inference (counterpart of
``basedet_tpu/layers/common/module_utils.py``, and of the reference's
``rename_module`` / ``fuse_model``).

The JAX package rewrites its nested variable tree and keeps HWIO kernels; the
port's state is a flat ``state_dict`` with dot-joined names and OIHW conv
weights, so a rename touches one element of the dotted names and the fold
scales the weight's first (output-channel) axis.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


def rename_tree_key(state: Mapping[str, torch.Tensor], old: str, new: str) -> Dict[str, torch.Tensor]:
    """Rename the path element ``old`` to ``new`` in every dotted name of a
    ``state_dict`` (``bottom_up.bn.weight`` with ``bn`` → ``norm`` gives
    ``bottom_up.norm.weight``); elements that only contain ``old`` stay."""
    return {".".join(new if part == old else part for part in k.split(".")): v for k, v in state.items()}


def fuse_conv_bn(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    eps: float = 1e-5,
):
    """Fold BN(scale, bias, mean, var) into a conv's OIHW ``weight`` and
    ``bias`` (None for none):

    y = scale * (conv(x) + bias - mean) / sqrt(var + eps) + bn_bias
      = conv'(x)  with  w' = weight · s[:, None, None, None],
        b' = (bias - mean) · s + bn_bias,  s = scale / sqrt(var + eps).

    Returns (fused weight, fused bias)."""
    s = bn_scale / torch.sqrt(bn_var + eps)
    fused_weight = weight * s.reshape(-1, *([1] * (weight.dim() - 1)))
    base = bias if bias is not None else torch.zeros_like(bn_mean)
    return fused_weight, (base - bn_mean) * s + bn_bias
