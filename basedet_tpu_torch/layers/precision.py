"""Compute-dtype policy (counterpart of ``basedet_tpu/layers/precision.py``).

``TRAINER.AMP.ENABLE`` selects bf16 compute with f32 parameters, as the JAX
package's flax layers get it through their ``dtype=`` argument: a
convolution casts its input, weight and bias to the compute dtype and gives
its output in it; BatchNorm reduces its statistics in f32 and gives its
output in the compute dtype; parameters, BN buffers and the losses stay f32
(``DYNAMIC_SCALE`` is ignored: bf16 needs no loss scaling). The casts are
written out rather than left to ``torch.autocast``, whose op lists differ
between the CPU and CUDA.

``TRAINER.AMP.FUSED_BN`` (absent by default) routes every train-mode dense
SiLU ``CSPLayer`` under the bf16 policy through the fused 1x1-GEMM + BN-stats
kernels (``layers/blocks/csp_fused.py``), where the JAX package reads
``BASEDET_FUSED_BN=1`` from the environment.

Modules read the policy when they run; ``make_train_step`` enters it around
the forward and the losses.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_POLICY: Tuple[Optional[torch.dtype], bool] = (None, False)  # (compute dtype, fused BN)


def compute_dtype() -> Optional[torch.dtype]:
    """The compute dtype, or None for full f32 (no casts)."""
    return _POLICY[0]


def fused_bn_enabled() -> bool:
    """Whether train-mode CSP layers take the fused-BN chain: the switch is
    on and the compute dtype is bf16 (``fused_bn_enabled`` of the JAX
    package's ``yolo_block.py``, without its TPU check: on the CPU the chain
    runs the kernels' plain versions)."""
    return _POLICY[1] and _POLICY[0] == torch.bfloat16


def policy_from_cfg(cfg) -> Tuple[Optional[torch.dtype], bool]:
    """(compute dtype, fused BN) from ``cfg.TRAINER.AMP``."""
    amp = cfg.TRAINER.AMP
    if not amp.get("ENABLE", False):
        return None, False
    name = amp.get("DTYPE", "bfloat16")
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"TRAINER.AMP.DTYPE {name!r} is not a torch floating dtype")
    return dtype, bool(amp.get("FUSED_BN", False))


@contextlib.contextmanager
def precision_policy(dtype: Optional[torch.dtype], fused_bn: bool = False) -> Iterator[None]:
    """Run with compute dtype ``dtype`` (None: f32) and the fused-BN switch
    for the duration; the previous policy is restored after."""
    global _POLICY
    saved, _POLICY = _POLICY, (dtype, fused_bn)
    try:
        yield
    finally:
        _POLICY = saved


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` under the policy: with a compute dtype, input, weight and
    bias cast to it, the bias added after the convolution in that dtype, as
    flax's ``nn.Conv(dtype=...)`` does; without one, the module as it is."""
    dt = compute_dtype()
    if dt is None:
        return conv(x)
    y = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride, conv.padding, conv.dilation,
                 conv.groups)
    return y if conv.bias is None else y + conv.bias.to(dt)[:, None, None]
