"""Activations and norms by name, the frozen BatchNorm and flax's train-mode
BatchNorm (counterparts of ``get_activation``, ``get_norm``,
``FrozenBatchNorm`` and ``nn.BatchNorm`` as ``basedet_tpu/layers/common/blocks.py``
uses them)."""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch.layers import precision, remat

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
    affine ``x * mul + add`` over NCHW channels, in the JAX op order, with
    ``mul`` and ``add`` cast to the input's dtype (bf16 in, bf16 out under the
    compute policy)."""

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
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running statistics as
    flax's ``nn.BatchNorm`` does: ``r = (1 - momentum) * r + momentum * stat``
    with the *biased* batch variance (torch's own update uses the unbiased
    one). Normalisation (biased batch statistics in train mode, running ones
    in eval mode) and the state-dict keys are torch's.

    Under a compute dtype it is flax's ``nn.BatchNorm(dtype=...)`` instead:
    statistics reduced in f32 as E[x²] - E[x]² (``use_fast_variance``), the
    normalisation in f32 in flax's order, the output in the compute dtype."""

    def forward(self, x):
        dt = precision.compute_dtype()
        if dt is not None:
            return self._forward_policy(x, dt)
        if not self.training:
            return super().forward(x)
        # momentum 1 writes the batch mean and unbiased variance into the
        # scratch buffers from the same fused pass that normalises
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        self.update_running(mean, var * ((n - 1) / n))
        return y

    def _forward_policy(self, x, dt):
        xf = x.float()
        if self.training:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean, 0.0)
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]).to(dt)

    @torch.no_grad()
    def update_running(self, mean, var) -> None:
        """flax's running update from a batch mean and biased variance; none
        while a REMAT segment is recomputed (``layers/remat.py``): the
        statistics move once a step."""
        if remat.recomputing():
            return
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)



def get_norm(name: Optional[str]) -> Optional[Callable[..., nn.Module]]:
    """A norm constructor ``(channels, device=None) -> module`` by name, or
    None for no norm. The port has only what its models use: ``BN`` is
    flax's ``nn.BatchNorm`` with the JAX package's defaults for it (eps 1e-5,
    flax momentum 0.9, which torch writes 0.1), ``FrozenBN`` the frozen one."""
    if not name:
        return None
    if name == "BN":
        return functools.partial(FlaxBatchNorm2d, eps=1e-5, momentum=0.1)
    if name == "FrozenBN":
        return FrozenBatchNorm
    raise NotImplementedError(f"norm {name!r} is not ported to basedet_tpu_torch yet")
