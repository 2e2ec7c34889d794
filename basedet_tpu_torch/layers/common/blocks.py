"""Activations and norms by name, and the frozen BatchNorm (counterparts of
``get_activation``, ``get_norm`` and ``FrozenBatchNorm`` in
``basedet_tpu/layers/common/blocks.py``)."""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

_ACTIVATIONS: dict = {
    "relu": F.relu,
    "lrelu": functools.partial(F.leaky_relu, negative_slope=0.1),
    "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.1),
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "gelu": functools.partial(F.gelu, approximate="tanh"),  # jax.nn.gelu's default
    "identity": lambda x: x,
}


def get_activation(name: Optional[Union[str, Callable]]) -> Callable:
    if name is None:
        return _ACTIVATIONS["identity"]
    if callable(name):
        return name
    return _ACTIVATIONS[name]


class FrozenBatchNorm(nn.Module):
    """BatchNorm with all of its state frozen: scale, bias, mean and var are
    buffers (the JAX package's ``frozen`` collection), applied as the fixed
    affine ``x * mul + add`` over NCHW channels, in the JAX op order."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels, device=device))
        self.register_buffer("bias", torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        mul = self.weight * inv
        add = self.bias - self.running_mean * self.weight * inv
        return x * mul[:, None, None] + add[:, None, None]


def get_norm(name: Optional[str]) -> Optional[Callable[..., nn.Module]]:
    """A norm constructor ``(channels, device=None) -> module`` by name, or
    None for no norm. The port has only what its models use."""
    if not name:
        return None
    if name == "FrozenBN":
        return FrozenBatchNorm
    raise NotImplementedError(f"norm {name!r} is not ported to basedet_tpu_torch yet")
