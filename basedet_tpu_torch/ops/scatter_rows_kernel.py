"""Batched row scatter-add: the CUDA kernel in ``csrc/scatter_rows.cu``, its
wrapper, and ``gather_rows_batched``, the DCN block gather whose gradient it
is.

The kernel replaces ``basedet_tpu/ops/scatter_onehot.py::_scatter_oh_kernel``
(``scatter_rows_onehot_pallas``, kernel #9). The JAX package reaches it only
with ``BASEDET_DCN_SCATTER=pallas``; by default it runs a one-hot matmul scan
for R <= 2048 and XLA's scatter above. All three compute one function, and
the port computes it with this one kernel at every R. The plain version is
``ops/scatter_rows.py::scatter_rows_plain``.

On the card the kernel is bound by bytes: CenterNet's three DCN stages at
batch 16 move about 3 GB of values per train step. The wrapper sorts the
row keys (``row_segments``: a stable ``torch.sort`` and a
``torch.searchsorted``, glue as NMS's sort is); the kernel then sums each
row's entries in a fixed order, so the result is deterministic. f32
``atomicAdd`` (as ``index_add_`` uses) would change the order, and the last
bits, from run to run.

The kernel is built from the repository's source at first use and bound
with ``ctypes`` (``ops/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from basedet_tpu_torch.ops._build import CSRC, load_library
from basedet_tpu_torch.ops.scatter_rows import row_segments, scatter_rows_plain

SOURCE = CSRC / "scatter_rows.cu"
_VALUE_TYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.basedet_scatter_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(idx: torch.Tensor, values: torch.Tensor, n_rows: int) -> None:
    if values.dim() != 3 or values.dtype not in _VALUE_TYPES:
        raise ValueError(f"values must be f32 or bf16 (B, N, D), got {values.dtype} "
                         f"{tuple(values.shape)}")
    if idx.shape != values.shape[:2] or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int32 {tuple(values.shape[:2])}, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.device != values.device:
        raise ValueError("idx and values lie on different devices")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")


def scatter_rows(idx: torch.Tensor, values: torch.Tensor, n_rows: int) -> torch.Tensor:
    """idx (B, N) int32, values (B, N, D) f32 or bf16 → ``zeros(B, R,
    D).at[b, idx].add(values)`` (B, R, D) f32, summed in f32; indices outside
    [0, R) add nothing.

    A CUDA tensor goes through the kernel (``scatter_rows.launches`` counts
    its launches), a CPU tensor through the plain version; any other device
    raises."""
    _check(idx, values, n_rows)
    if values.device.type == "cpu":
        return scatter_rows_plain(idx, values, n_rows)
    if values.device.type != "cuda":
        raise ValueError(f"no scatter kernel for device {values.device}")
    B, N, D = values.shape
    out = torch.empty(B * n_rows, D, dtype=torch.float32, device=values.device)
    if out.numel() == 0:
        return out.view(B, n_rows, D)
    values = values.contiguous()
    order, starts = row_segments(idx, n_rows)
    vec = 4 if D % 4 == 0 and values.data_ptr() % (4 * values.element_size()) == 0 else 1
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = _library().basedet_scatter_rows(
            values.data_ptr(), int(values.dtype == torch.bfloat16), order.data_ptr(),
            starts.data_ptr(), B * n_rows, D, vec, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scatter kernel launch failed: CUDA error {err}")
    scatter_rows.launches += 1
    return out.view(B, n_rows, D)


scatter_rows.launches = 0


class _GatherRows(torch.autograd.Function):
    """``table[b, idx[b]]`` forward; its gradient in the table is the row
    scatter of the cotangent, cast to the table's dtype (the JAX package's
    custom VJP of ``gather_rows_batched``). idx gets none."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = table.shape[1], table.dtype
        return torch.gather(table, 1, idx.to(torch.int64)[..., None].expand(-1, -1, table.shape[2]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_rows(idx, grad, ctx.n_rows).to(ctx.dtype), None


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
