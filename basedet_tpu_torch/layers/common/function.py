"""Small functional helpers (counterpart of ``basedet_tpu/layers/common/function.py``)."""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch


def topk_scores(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, lowest index first among equal
    scores, as ``jax.lax.top_k`` gives it. ``torch.topk`` promises no order
    among ties, so this takes a stable full sort."""
    values, indices = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def extract_topk_mask(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k over the last axis: values (..., M) → (the k largest
    (..., k), largest first; membership mask (..., M) bool), the lowest index
    first among equal values, as the JAX package's iterative argmax
    extraction picks them (rows must hold at least k finite values there). A
    stable sort gives that order on every device; ``torch.topk`` promises
    none among ties."""
    k = min(k, values.shape[-1])
    top, idx = topk_scores(values, k)
    mask = torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    return top, mask.scatter_(-1, idx, True)


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the maximum along ``dim``, the lowest index among equal
    maxima, as ``jnp.argmax`` gives it. ``torch.argmax`` and ``torch.max``
    promise no order among ties on CUDA, and ties are the common case where
    this is used: an anchor or proposal that overlaps no gt has IoU 0 with
    all of them. ``x`` must hold no NaN."""
    size = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = size
    index = torch.arange(size, device=x.device).reshape(shape)
    best = x.amax(dim=dim, keepdim=True)
    return torch.where(x == best, index, size).amin(dim=dim)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """cuDNN convolutions and cuBLAS matmuls in IEEE f32, TF32 off, for the
    duration, whatever the process had set; the settings are restored after.
    The parity budget with the JAX package assumes f32 (PyTorch's default lets
    cuDNN use TF32). Usable as a decorator."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
