"""Activations and norms by name, the frozen BatchNorm, flax's train-mode
BatchNorm and GroupNorm (counterparts of ``get_activation``, ``get_norm``,
``FrozenBatchNorm``, ``nn.BatchNorm`` and ``nn.GroupNorm`` as
``basedet_tpu/layers/common/blocks.py`` uses them).

Under a process group (``basedet_tpu_torch/parallel``) a train-mode BN
reduces its statistics over every rank's rows (``CrossRankBatchNorm``), as
flax's ``nn.BatchNorm`` does over a batch that pjit shards: ``BN`` and
``SyncBN`` alike."""
from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from basedet_tpu_torch import parallel
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


class CrossRankBatchNorm(torch.autograd.Function):
    """Train-mode BN of an f32 NCHW ``x`` over the rows of every rank: flax's
    statistics (mean and biased variance as E[x²] - E[x]², clamped at 0) and
    normalisation ``(x - mean) * (rsqrt(var + eps) * weight) + bias``.

    Forward: one all-reduce of [Σx, Σx², n] (float64, so the count is exact).
    Backward: one all-reduce of [Σdy, Σdy·x̂], from which dx is the gradient
    of every rank's loss together; ``weight`` and ``bias`` get this rank's
    own Σdy·x̂ and Σdy, which ``parallel.all_reduce_grads`` then averages
    with every other parameter's gradient. Returns (y, mean, var); the last
    two, for the running update, carry no gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=torch.float64, device=x.device)
        sums = parallel.all_reduce_sum_(torch.cat([x.sum((0, 2, 3)).double(), (x * x).sum((0, 2, 3)).double(),
                                                   count]))
        n = sums[-1]
        mean = (sums[:c] / n).float()
        var = torch.clamp_min((sums[c:2 * c] / n).float() - mean * mean, 0.0)
        invstd = torch.rsqrt(var + eps)
        y = (x - mean[:, None, None]) * (invstd * weight)[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, weight, mean, invstd, n.float())
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]
        xhat = (x - mean[:, None, None]) * invstd[:, None, None]
        local = torch.cat([dy.sum((0, 2, 3)), (dy * xhat).sum((0, 2, 3))])
        dbias, dweight = local[:c].clone(), local[c:].clone()
        sums = parallel.all_reduce_sum_(local)
        dx = (weight * invstd)[:, None, None] * (dy - (sums[:c] / n)[:, None, None]
                                                - xhat * (sums[c:] / n)[:, None, None])
        return dx, dweight, dbias, None


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running statistics as
    flax's ``nn.BatchNorm`` does: ``r = (1 - momentum) * r + momentum * stat``
    with the *biased* batch variance (torch's own update uses the unbiased
    one). Normalisation (biased batch statistics in train mode, running ones
    in eval mode) and the state-dict keys are torch's.

    Under a compute dtype it is flax's ``nn.BatchNorm(dtype=...)`` instead:
    statistics reduced in f32 as E[x²] - E[x]² (``use_fast_variance``), the
    normalisation in f32 in flax's order, the output in the compute dtype.

    In train mode under a process group, both take their statistics over
    every rank's rows (``CrossRankBatchNorm``, in f32; the output in the
    compute dtype where there is one); without one, the paths above."""

    def forward(self, x):
        dt = precision.compute_dtype()
        if self.training and parallel.is_active():
            y, mean, var = CrossRankBatchNorm.apply(x.float(), self.weight, self.bias, self.eps)
            self.update_running(mean, var)
            return y.to(dt or x.dtype)
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


class FlaxGroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(num_groups, epsilon, dtype=compute dtype)``:
    torch's ``group_norm`` in f32; under a compute dtype the statistics and
    the normalisation in f32 in flax's order (E[x²] - E[x]²), the output in
    the compute dtype."""

    def forward(self, x):
        dt = precision.compute_dtype()
        if dt is None:
            return super().forward(x)
        b, c = x.shape[:2]
        xg = x.float().reshape(b, self.num_groups, -1)
        mean = xg.mean(-1, keepdim=True)
        var = torch.clamp_min((xg * xg).mean(-1, keepdim=True) - mean * mean, 0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(dt)


def get_norm(name: Optional[str]) -> Optional[Callable[..., nn.Module]]:
    """A norm constructor ``(channels, device=None) -> module`` by name, or
    None for no norm. ``BN`` and ``SyncBN`` are flax's ``nn.BatchNorm`` with
    the JAX package's defaults for it (eps 1e-5, flax momentum 0.9, which
    torch writes 0.1), one module: its statistics are over every rank under a
    process group, as the JAX package's are over the sharded batch for both.
    ``FrozenBN`` is the frozen one; ``GN`` flax's ``nn.GroupNorm(32,
    epsilon=1e-5)`` (the point head's GroupNorm keeps flax's default eps,
    1e-6)."""
    if not name:
        return None
    if name in ("BN", "SyncBN"):
        return functools.partial(FlaxBatchNorm2d, eps=1e-5, momentum=0.1)
    if name == "FrozenBN":
        return FrozenBatchNorm
    if name == "GN":
        return lambda channels, device=None: FlaxGroupNorm(32, channels, eps=1e-5, device=device)
    raise NotImplementedError(f"norm {name!r} is not ported to basedet_tpu_torch yet")
