"""Batched row scatter-add, plain PyTorch: the plain version of the CUDA
kernel in ``csrc/scatter_rows.cu`` and the glue both share.

The function is the JAX package's ``scatter_rows_onehot_pallas``
(``basedet_tpu/ops/scatter_onehot.py``): idx (B, N) int, values (B, N, D) f32
or bf16 → ``zeros(B, R, D).at[b, idx].add(values)`` in f32; an index outside
[0, R) adds nothing. It is the transpose of the DCN block gather
(``ops/scatter_rows_kernel.py::gather_rows_batched``). The TPU kernel's
``D % 128`` rule and its row and channel padding are layout and are not
ported.

Both versions sum each row's entries in f32 in the original n order, after
:func:`row_segments` has sorted them stably by row: the plain version one
entry position at a time over all rows, the kernel one row per block. The
same additions in the same order give the same bits.
"""
from __future__ import annotations

from typing import Tuple

import torch


def row_segments(idx: torch.Tensor, n_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx (B, N) → (order (B*N,) int64, starts (B*R + 1,) int64): the
    entries sorted stably by the key b*R + idx, out-of-range entries last
    (key B*R), and where each of the B*R rows' runs starts in that order
    (``starts[-1]`` is the number of in-range entries)."""
    B, N = idx.shape
    idx = idx.to(torch.int64)
    rows = B * n_rows
    base = torch.arange(B, device=idx.device, dtype=torch.int64)[:, None] * n_rows
    key = torch.where((idx >= 0) & (idx < n_rows), idx + base, rows).flatten()
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(sorted_key, torch.arange(rows + 1, device=idx.device))
    return order, starts


def scatter_rows_plain(idx: torch.Tensor, values: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of ``scatter_rows`` (``scatter_rows_plain.calls``
    counts its calls): idx (B, N), values (B, N, D) f32 or bf16 → (B, R, D)
    f32. Round k adds, to every row that has one, its k-th entry in n order,
    so each row is summed as the kernel sums it."""
    scatter_rows_plain.calls += 1
    B, N, D = values.shape
    out = torch.zeros(B * n_rows, D, dtype=torch.float32, device=values.device)
    if B * N == 0 or n_rows == 0:
        return out.view(B, n_rows, D)
    order, starts = row_segments(idx, n_rows)
    flat = values.reshape(B * N, D)
    first, counts = starts[:-1], starts[1:] - starts[:-1]
    for k in range(int(counts.max())):
        live = counts > k
        entry = order[torch.where(live, first + k, 0)]
        out += torch.where(live[:, None], flat[entry].float(), 0.0)
    return out.view(B, n_rows, D)


scatter_rows_plain.calls = 0
