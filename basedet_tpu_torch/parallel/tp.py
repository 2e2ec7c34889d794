"""Tensor parallelism over the model group (counterpart of
``basedet_tpu/parallel/tp.py``).

The JAX package constrains the transformer's FFN activations to its mesh's
``model`` axis and lets GSPMD split the matmuls; weights stay replicated.
Here the split is written out in the Megatron style
(``layers/blocks/transformer.py``): model rank m computes columns
``[m·F/tp, (m+1)·F/tp)`` of the FFN's hidden width from replicated weights,
and two autograd-aware collectives join the ranks:

- :func:`copy_to_model`: the identity forward, an all-reduce of the gradient
  over the model group backward (the FFN's input feeds every rank's slice);
- :func:`reduce_from_model`: an all-reduce over the model group forward (the
  partial products' sum), the identity backward.

:func:`tp_context` installs the model group for the block it wraps (the
train step, as the JAX trainer wraps its step in ``tp_context(mesh)``); out
of it, or without a model group, :func:`tp_size` is 1 and both collectives
are the identity, so a single process keeps its bits. After the backward
:func:`all_reduce_model_grads` sums the gradients that each rank holds only
a slice of and averages the replicated ones over the model group.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Iterator, Optional

import torch
import torch.distributed as dist

_state = threading.local()


def current_model_group():
    return getattr(_state, "group", None)


def tp_size() -> int:
    group = current_model_group()
    return dist.get_world_size(group) if group is not None else 1


def tp_rank() -> int:
    group = current_model_group()
    return dist.get_rank(group) if group is not None else 0


@contextlib.contextmanager
def tp_context(group) -> Iterator[Optional[object]]:
    """Install the model ``group`` (None: none) for the block; the previous
    one is restored after."""
    prev = current_model_group()
    _state.group = group
    try:
        yield group
    finally:
        _state.group = prev


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; its gradient summed over the model group."""
    group = current_model_group()
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model group; its gradient passed through."""
    group = current_model_group()
    return x if group is None else _ReduceFromModel.apply(x, group)


@torch.no_grad()
def all_reduce_model_grads(params: Iterable[torch.nn.Parameter], sharded: Iterable[torch.nn.Parameter],
                           group) -> None:
    """After the backward, one all-reduce over the model ``group`` of every
    gradient: those of ``sharded``, which each model rank holds only its
    slice of (zeros elsewhere), are summed into the whole gradient; the
    others, which every model rank computed from the same rows, are
    averaged. They agree across the ranks but for the order of the card's
    non-deterministic sums (cuDNN's weight-gradient algorithms give a
    ResNet's convolutions other bits run to run), so the average keeps the
    replicas bit-equal where each rank's own would let them drift. Nothing
    without a group."""
    if group is None:
        return
    width = dist.get_world_size(group)
    split = {id(p) for p in sharded}
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) if id(p) in split else p.grad.reshape(-1) / width for p in params])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
