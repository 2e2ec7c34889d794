"""Batched row scatter-add: the CUDA kernels in ``csrc/scatter_rows.cu``,
their wrappers, and ``gather_rows_batched``, the DCN block gather whose
gradient it is.

The kernels replace ``basedet_tpu/ops/scatter_onehot.py::_scatter_oh_kernel``
(``scatter_rows_onehot_pallas``, kernel #9). The JAX package reaches it only
with ``BASEDET_DCN_SCATTER=pallas``; by default it runs a one-hot matmul scan
for R <= 2048 and XLA's scatter above. All three compute one function, and
the port computes it with these kernels at every R. The plain versions are
``ops/scatter_rows.py::scatter_rows_plain`` and ``segment_rows_plain``.

On the card the scatter is bound by bytes: CenterNet's three DCN stages at
batch 16 move about 3 GB of f32 values per train step, 1.5 GB of bf16 ones
under ``--amp``. A call is one segmentation (:func:`segment_rows`: a memset
and four kernels group the entries by row, each row in ascending n, with no
sort) and one scatter launch that sums each row's entries in that fixed
order, so the result is deterministic, and stores it as f32 or, for the
bf16 table of an ``--amp`` step, as bf16. f32 ``atomicAdd`` (as
``index_add_`` uses) would change the order, and the last bits, from run to
run.

The kernels are built from the repository's source at first use and bound
with ``ctypes`` (``ops/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from basedet_tpu_torch.ops._build import CSRC, load_library
from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain, segment_rows_plain

SOURCE = CSRC / "scatter_rows.cu"
_VALUE_TYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1
_MAX_ENTRIES = 2 ** 31 - 1024  # B*N: ids and the walk's positions stay in int32


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    seg = lib.basedet_row_segments
    seg.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p]
    seg.restype = ctypes.c_int
    fn = lib.basedet_scatter_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_idx(idx: torch.Tensor, n_rows: int) -> None:
    if idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int32 or int64 (B, N), got {idx.dtype} {tuple(idx.shape)}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    if idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no scatter kernel for device {idx.device}")
    B, N = idx.shape
    if B * N > _MAX_ENTRIES or 2 * B * n_rows + B + 1 > _INT32_MAX:
        raise ValueError(f"idx {tuple(idx.shape)} into {n_rows} rows is past the kernels' 32-bit ids")


def _check(idx: torch.Tensor, values: torch.Tensor, n_rows: int, out_dtype: torch.dtype) -> None:
    if values.dim() != 3 or values.dtype not in _VALUE_TYPES:
        raise ValueError(f"values must be f32 or bf16 (B, N, D), got {values.dtype} "
                         f"{tuple(values.shape)}")
    if idx.shape != values.shape[:2]:
        raise ValueError(f"idx must be {tuple(values.shape[:2])}, got {tuple(idx.shape)}")
    if idx.device != values.device:
        raise ValueError("idx and values lie on different devices")
    if out_dtype not in (torch.float32, values.dtype):
        raise ValueError(f"out_dtype must be float32 or the values' {values.dtype}, got {out_dtype}")
    _check_idx(idx, n_rows)


def _segment(idx: torch.Tensor, n_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The segmentation kernels on a CUDA idx (B, N), R = n_rows > 0."""
    B, N = idx.shape
    rows = B * n_rows
    idx = idx.contiguous()
    scratch = torch.empty(2 * rows + B + 1 + 2 * B * N, dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        err = _library().basedet_row_segments(idx.data_ptr(), int(idx.dtype == torch.int64), B, N, n_rows,
                                              scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"row segmentation launch failed: CUDA error {err}")
    segment_rows.launches += 1
    starts = scratch[rows + B:2 * rows + B + 1]
    return scratch[2 * rows + B + 1 + B * N:], starts


def segment_rows(idx: torch.Tensor, n_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx (B, N) int32 or int64 → (ids (B*N,) int32, starts (B*R + 1,)
    int32): the in-range entries' flat ids (b*N + n), row by row and in
    ascending n within a row, where row b*R + r begins at ``starts[b*R + r]``;
    only the first ``starts[-1]`` ids are meaningful.

    A CUDA tensor goes through the segmentation kernels (a memset and four
    launches, counted once a call in ``segment_rows.launches``), a CPU tensor
    through ``segment_rows_plain`` (whose ids are exactly the meaningful
    ones); any other device raises."""
    _check_idx(idx, n_rows)
    if idx.device.type == "cpu":
        return segment_rows_plain(idx, n_rows)
    if n_rows == 0:
        return (torch.empty(idx.numel(), dtype=torch.int32, device=idx.device),
                torch.zeros(1, dtype=torch.int32, device=idx.device))
    return _segment(idx, n_rows)


segment_rows.launches = 0


def scatter_rows(idx: torch.Tensor, values: torch.Tensor, n_rows: int,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """idx (B, N) int32 or int64, values (B, N, D) f32 or bf16 → ``zeros(B,
    R, D).at[b, idx].add(values)`` (B, R, D), summed in f32 and stored as
    ``out_dtype``: f32, or the values' dtype (bf16 rounded once from the f32
    sum); indices outside [0, R) add nothing.

    A CUDA tensor goes through the segmentation kernels and the scatter
    kernel (``scatter_rows.launches`` counts the scatter's launches), a CPU
    tensor through the plain version; any other device raises."""
    _check(idx, values, n_rows, out_dtype)
    if values.device.type == "cpu":
        return scatter_rows_plain(idx, values, n_rows, out_dtype)
    B, N, D = values.shape
    out = torch.empty(B * n_rows, D, dtype=out_dtype, device=values.device)
    if out.numel() == 0:
        return out.view(B, n_rows, D)
    values = values.contiguous()
    ids, starts = _segment(idx, n_rows)
    wide = 16 // values.element_size()
    vec = wide if D % wide == 0 and values.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = _library().basedet_scatter_rows(
            values.data_ptr(), int(values.dtype == torch.bfloat16), ids.data_ptr(), starts.data_ptr(),
            B * n_rows, D, vec, out.data_ptr(), int(out_dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"scatter kernel launch failed: CUDA error {err}")
    scatter_rows.launches += 1
    return out.view(B, n_rows, D)


scatter_rows.launches = 0


class _GatherRows(torch.autograd.Function):
    """``table[b, idx[b]]`` forward; its gradient in the table is the row
    scatter of the cotangent, summed in f32 and stored in the table's dtype
    (the JAX package's custom VJP of ``gather_rows_batched`` casts its f32
    sum the same way). idx gets none."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = table.shape[1], table.dtype
        return torch.gather(table, 1, idx.to(torch.int64)[..., None].expand(-1, -1, table.shape[2]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_rows(idx, grad, ctx.n_rows, out_dtype=ctx.dtype), None


def gather_rows_batched(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, R, D), idx (B, N) int32 in [0, R) → (B, N, D), ``table[b,
    idx[b]]`` (counterpart of ``basedet_tpu/ops/scatter_onehot.py::
    gather_rows_batched``). The forward is ``torch.gather``; the gradient in
    the table goes through :func:`scatter_rows`: the kernel for a CUDA
    tensor, the plain version for a CPU one."""
    if table.dim() != 3 or idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"table must be (B, R, D) and idx (B, N), got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no scatter kernel for device {table.device}")
    return _GatherRows.apply(table, idx)
