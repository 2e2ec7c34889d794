"""Data parallelism over a ``torch.distributed`` process group (counterpart of
``basedet_tpu/parallel/mesh.py``).

The JAX package shards one global batch over a device mesh and lets pjit
insert every collective: the gradient mean, the train-mode BN statistics and
every sum over the batch. Here each rank is a process that holds its own
rows of the global batch, and those reductions are made explicit:

- ``all_reduce_grads``: the gradient mean, after the backward, in buckets;
- ``global_sum``: a detached count or sum over the global batch (the loss
  normalisers of ``models/det/``);
- ``all_reduce_sum_``: the cross-rank BN's statistics
  (``layers/common/blocks.py``);
- ``group_stats``: the fused CSP chain's BN sums, differentiably
  (``layers/blocks/csp_fused.py``);
- ``shard_rows`` / ``shard_batch``: the rank's rows of a global tensor or
  batch (the loaders, the sampling noise, DETR's dropout masks);
- ``broadcast_module``: rank 0's parameters and buffers to every rank;
- ``group_max``: the data group's largest canvas, which every rank pads
  its rows to (``engine/trainer.py``), as one process pads the global batch.

The collectives run wherever a process group is initialised, even at world
size 1 (``torchrun --nproc-per-node 1 ... --multi-host``); without one every
function here is the identity, so a single-process run keeps its bits.

``init_from_env`` reads torchrun's environment. The device rule is the
port's: ``cuda`` gives the rank ``cuda:LOCAL_RANK`` and never the CPU. NCCL
takes one card a rank; gloo, asked for by name, may run ranks that share a
card (``cuda:LOCAL_RANK`` modulo the visible cards). Nothing falls back to
another backend or device.

With ``TRAINER.TP_SIZE`` above 1 (``mesh.init_grid``) the ranks form a
(data × model) grid: the ranks of one model group hold the same rows and
split DETR's FFN between them (``parallel/tp.py``). Every function here then
works over this rank's data group: :func:`world_size` and :func:`rank` are
the data-parallel size and index, the rows, sums, normalisers, gradient
means, metrics and BN statistics are the data group's. Without a grid the
data group is the whole process group.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from basedet_tpu_torch.parallel import mesh
from basedet_tpu_torch.parallel.mesh import data_group, init_grid, model_group

BUCKET_BYTES = 25 << 20  # the gradient all-reduce's bucket size, as DDP's default


def is_active() -> bool:
    """True where a process group is initialised: the collectives run."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of data-parallel ranks: the data group's size."""
    return dist.get_world_size(data_group()) if is_active() else 1


def rank() -> int:
    """This rank's index in its data group: which rows of a global batch it holds."""
    return dist.get_rank(data_group()) if is_active() else 0


def global_rank() -> int:
    return dist.get_rank() if is_active() else 0


def is_main_process() -> bool:
    """Rank 0 of the whole process group: the one that writes and evaluates."""
    return global_rank() == 0


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_from_env(device: torch.device, backend: Optional[str] = None) -> torch.device:
    """Initialise the process group from torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, over ``backend``
    (``nccl`` on ``cuda``, ``gloo`` on ``cpu`` when None), and return the
    rank's device. Raises without that environment, for NCCL with more local
    ranks than visible cards, and for NCCL on the CPU."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multi-host needs torchrun's environment; {', '.join(missing)} not set "
                           "(launch with torchrun --nproc-per-node N -m basedet_tpu_torch.tools.det_train ...)")
    device = torch.device(device)
    backend = backend or default_backend(device.type)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("--device cuda but CUDA is not available; pass --device cpu explicitly")
        if backend == "nccl" and max(local_world, local_rank + 1) > cards:
            raise RuntimeError(f"nccl with {max(local_world, local_rank + 1)} ranks on this host but {cards} "
                               "visible card(s): NCCL takes one card a rank (ranks sharing a card: "
                               "--dist-backend gloo)")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("nccl runs on CUDA devices only; --device cpu takes gloo")
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return device


def shutdown() -> None:
    if is_active():
        mesh.reset_grid()
        dist.destroy_process_group()


def barrier() -> None:
    if is_active():
        dist.barrier()


def shard_rows(x):
    """Rows ``[r·n, (r + 1)·n)`` of a global tensor or array whose leading
    dimension holds ``n·W`` rows: the rank's share. The identity without a
    process group."""
    w = world_size()
    if w == 1:
        return x
    if x.shape[0] % w:
        raise ValueError(f"{x.shape[0]} rows do not split over {w} ranks")
    n = x.shape[0] // w
    return x[rank() * n:(rank() + 1) * n]


def shard_batch(batch: Mapping) -> Dict:
    """The rank's rows of every array or tensor of a global batch (leading
    dimension = the batch); other entries as they are."""
    return {k: shard_rows(v) if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim else v
            for k, v in batch.items()}


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the data group, in place."""
    if is_active():
        dist.all_reduce(t, group=data_group())
    return t


class _GroupStats(torch.autograd.Function):
    """(Σx, Σx², n) of one rank's rows → the data group's, in one all-reduce
    (float64, so the count is exact); the backward all-reduces the
    cotangents of the two sums, so the gradient that reaches a rank's rows is
    that of every rank's loss together, as ``CrossRankBatchNorm`` gives it."""

    @staticmethod
    def forward(ctx, s, ss, count):
        c = s.shape[0]
        n = torch.full((1,), float(count), dtype=torch.float64, device=s.device)
        sums = all_reduce_sum_(torch.cat([s.double(), ss.double(), n]))
        total = sums[-1].float()
        ctx.mark_non_differentiable(total)
        return sums[:c].float(), sums[c:2 * c].float(), total

    @staticmethod
    def backward(ctx, ds, dss, _dn):
        c = ds.shape[0]
        sums = all_reduce_sum_(torch.cat([ds, dss]))
        return sums[:c], sums[c:], None


def group_stats(s: torch.Tensor, ss: torch.Tensor, count: int):
    """(s, ss, count) summed over the data group under a process group (the
    count as an f32 tensor), differentiable in ``s`` and ``ss``; without one,
    the arguments as they are."""
    if not is_active():
        return s, ss, count
    return _GroupStats.apply(s, ss, count)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A detached count or sum over the global batch: ``x`` summed over
    ranks. A loss divides its own rank's sum by ``global_sum(n) /
    world_size()``, so that the mean of the ranks' gradients, which
    ``all_reduce_grads`` takes, is the gradient of ΣS / Σn."""
    x = x.detach()
    return all_reduce_sum_(x.clone()) if is_active() else x


def global_normaliser(n: torch.Tensor, floor: float) -> torch.Tensor:
    """A loss normaliser over the global batch, as this rank's share: the
    count or sum ``n`` summed over ranks, in f32, at least ``floor``, over
    the world size. A rank that divides its own sum S by it makes the mean of
    the ranks' gradients the gradient of ΣS / max(Σn, floor)."""
    return global_sum(n).to(torch.float32).clamp(min=floor) / world_size()


@torch.no_grad()
def broadcast_tensors(tensors: Iterable[torch.Tensor]) -> None:
    """Rank 0's values of ``tensors`` to every rank, in place."""
    if is_active():
        for t in tensors:
            dist.broadcast(t, 0)


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank, in place."""
    broadcast_tensors(module.state_dict().values())


def _buckets(params: List[torch.nn.Parameter], bucket_bytes: int) -> List[List[int]]:
    buckets: List[List[int]] = [[]]
    size = 0
    for i, p in enumerate(params):
        nbytes = p.numel() * p.element_size()
        if buckets[-1] and (size + nbytes > bucket_bytes or p.dtype != params[buckets[-1][0]].dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(i)
        size += nbytes
    return buckets


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter], bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each trainable parameter's gradient by its mean over the data group,
    flattened into buckets of at most ``bucket_bytes`` of one dtype (one
    all-reduce a bucket). A parameter without a gradient counts as zeros and
    leaves with the mean, as the JAX package gives every parameter a
    gradient; no host sync."""
    if not is_active():
        return
    params = [p for p in params if p.requires_grad]
    w = world_size()
    for idx in _buckets(params, bucket_bytes) if params else ():
        flat = torch.cat([params[i].grad.reshape(-1) if params[i].grad is not None
                          else params[i].new_zeros(params[i].numel()) for i in idx])
        dist.all_reduce(flat, group=data_group())
        flat.div_(w)
        offset = 0
        for i in idx:
            p = params[i]
            view = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
            if p.grad is None:
                p.grad = view.clone()
            else:
                p.grad.copy_(view)


def group_max(values: Sequence[int]) -> List[int]:
    """The elementwise maximum of a few integers over the data group, in one
    all-reduce (on the card under NCCL, which takes device tensors only; on
    the host under gloo); the values as they are without a process group."""
    if not is_active():
        return list(values)
    nccl = dist.get_backend(data_group()) == "nccl"
    t = torch.tensor(list(values), dtype=torch.int64,
                     device=torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=data_group())
    return t.tolist()


def reduce_metrics(metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The mean over the data group of each tensor metric (one all-reduce); the others
    (the LR) as they are."""
    if not is_active():
        return dict(metrics)
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    if not names:
        return dict(metrics)
    stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in names])
    dist.all_reduce(stacked, group=data_group())
    stacked.div_(world_size())
    return {**metrics, **dict(zip(names, stacked.unbind()))}
