"""The (data × model) grid of ranks (counterpart of
``basedet_tpu/parallel/mesh.py``).

The JAX package reshapes its devices to a ``(W / tp, tp)`` mesh with axes
``data`` and ``model`` (``make_mesh``). Here each of the W ranks of the process
group takes the place of a device in that layout: rank r holds data index
``r // tp`` and model index ``r % tp``, so the ranks of one model group are
consecutive. :func:`init_grid` makes a ``torch.distributed`` group for each
row (a model group) and each column (a data group) and keeps this rank's
two; ``basedet_tpu_torch/parallel`` then reduces over the data group and
``parallel/tp.py`` over the model group. Without a grid, or with
``tp`` = 1, the data group is the whole process group and there is no model
group.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch.distributed as dist


class Grid(NamedTuple):
    tp: int
    data_group: object  # this rank's data group (None: the whole process group)
    model_group: object  # this rank's model group (None without one)
    data_rank: int
    data_size: int
    model_rank: int


_GRID: Optional[Grid] = None


def grid_layout(world: int, tp: int) -> Tuple[List[List[int]], List[List[int]]]:
    """(data groups, model groups) of ``world`` ranks at model width ``tp``,
    as ``make_mesh((("data", world // tp), ("model", tp)))`` lays its devices
    out: model group d holds ranks ``d·tp … d·tp + tp - 1``, data group m the
    ranks ``m, m + tp, …``. Raises where ``tp`` does not divide ``world``."""
    if tp < 1 or world % tp:
        raise ValueError(f"TRAINER.TP_SIZE {tp} does not divide the world size {world}")
    model = [list(range(d * tp, (d + 1) * tp)) for d in range(world // tp)]
    data = [list(range(m, world, tp)) for m in range(tp)]
    return data, model


def init_grid(tp: int) -> Optional[Grid]:
    """Lay the initialised process group out as ``grid_layout`` says and keep
    this rank's groups (every rank makes every group, in the same order, as
    ``dist.new_group`` asks). ``tp`` = 1 keeps no grid: the data group is the
    whole process group. Replaces a grid made before."""
    global _GRID
    reset_grid()
    if tp == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(f"TRAINER.TP_SIZE {tp} needs a process group (det_train --multi-host under torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    data, model = grid_layout(world, tp)
    data_groups = [dist.new_group(ranks) for ranks in data]
    model_groups = [dist.new_group(ranks) for ranks in model]
    d, m = rank // tp, rank % tp
    _GRID = Grid(tp, data_groups[m], model_groups[d], d, world // tp, m)
    return _GRID


def reset_grid() -> None:
    """Drop the grid and its groups (before the process group ends)."""
    global _GRID
    if _GRID is not None and dist.is_initialized():
        for group in (_GRID.data_group, _GRID.model_group):
            dist.destroy_process_group(group)
    _GRID = None


def current_grid() -> Optional[Grid]:
    return _GRID


def data_group():
    """The group the data-parallel reductions run over: this rank's data
    group, or None (the whole process group) without a grid."""
    return _GRID.data_group if _GRID is not None else None


def model_group():
    """This rank's model group, or None without a grid."""
    return _GRID.model_group if _GRID is not None else None
