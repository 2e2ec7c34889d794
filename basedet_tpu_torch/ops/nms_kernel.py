"""Greedy-NMS keep mask: the CUDA kernel in ``csrc/nms.cu`` and its plain version.

Replaces ``basedet_tpu/ops/nms_pallas.py::_nms_kernel``. Over boxes sorted by
descending score, ``keep[i] = valid[i]`` and no kept ``j < i`` has
``inter > t * max(union, 1e-12)``: the exact sequential greedy result, ties
included.

On the card the kernel is bound by the chain of dependent keep decisions, not
by bytes (one image's 5000 candidates are 80 KB) nor by the pairwise tests.
Its design therefore moves all pairwise work into one fully parallel launch (a
``(B, K, ceil(K/64))`` bitmask of suppressions, 64 boxes per block, only the
blocks and rows the sweep reads) and leaves a sweep of one round per 64-box
word for the sequential part: each warp resolves the word's 64 decisions in
registers, then the block ORs the kept rows into ``removed``, one block per
image. See ``csrc/nms.cu``.

The kernel is built from the repository's source at first use and bound with
``ctypes`` (``ops/_build.py``). It is reached through one registered custom op,
``torch.ops.basedet.nms_keep``, so that ``torch.export`` records a call to it as
one node and an exported program launches it as the eager module does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from basedet_tpu_torch.ops._build import CSRC, load_library

SOURCE = CSRC / "nms.cu"
# the sweep keeps one u64 `removed` word per 64 boxes and a 64-byte list per warp (at most 32) in
# shared memory, 227 KB a block
MAX_WORDS = (232448 - 32 * 64) // 8


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.basedet_nms_keep
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(sorted_boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if sorted_boxes.dim() != 3 or sorted_boxes.shape[-1] != 4:
        raise ValueError(f"sorted_boxes must be (B, K, 4), got {tuple(sorted_boxes.shape)}")
    if sorted_boxes.dtype != torch.float32:
        raise TypeError(f"sorted_boxes must be float32, got {sorted_boxes.dtype}")
    if valid.shape != sorted_boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(
            f"valid must be bool {tuple(sorted_boxes.shape[:2])}, "
            f"got {valid.dtype} {tuple(valid.shape)}"
        )
    if valid.device != sorted_boxes.device:
        raise ValueError("sorted_boxes and valid lie on different devices")


def _launch(lib, sorted_boxes, valid, B, K, thresh, mask, keep) -> int:
    return lib.basedet_nms_keep(
        sorted_boxes.data_ptr(), valid.data_ptr(), B, K, thresh,  # c_float: rounds to f32
        mask.data_ptr(), keep.data_ptr(), torch.cuda.current_stream().cuda_stream,
    )


def nms_keep(sorted_boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy-NMS keep mask: sorted_boxes (B, K, 4) f32 xyxy in descending
    score order, valid (B, K) bool → keep (B, K) bool.

    Calls the custom op ``basedet::nms_keep``: a CUDA tensor goes through the
    kernel (``nms_keep.launches`` counts its launches); a CPU tensor goes
    through :func:`nms_keep_plain`."""
    _check(sorted_boxes, valid)
    if sorted_boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS kernel for device {sorted_boxes.device}")
    return torch.ops.basedet.nms_keep(sorted_boxes, valid, float(thresh))


@torch.library.custom_op("basedet::nms_keep", mutates_args=())
def _nms_keep_op(sorted_boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    if sorted_boxes.device.type == "cpu":
        return nms_keep_plain(sorted_boxes, valid, thresh)
    return _nms_keep_cuda(sorted_boxes, valid, thresh)


@_nms_keep_op.register_fake
def _(sorted_boxes, valid, thresh):
    return torch.empty_like(valid)


def _nms_keep_cuda(sorted_boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    if not (sorted_boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep needs contiguous sorted_boxes and valid")
    if sorted_boxes.data_ptr() % 16:
        raise ValueError("nms_keep needs sorted_boxes on a 16-byte boundary")
    B, K = valid.shape
    words = (K + 63) // 64
    if B > 65535 or words > MAX_WORDS:
        raise ValueError(f"nms_keep supports B <= 65535 and K <= {64 * MAX_WORDS}, got B={B} K={K}")
    device = valid.device
    keep = torch.empty((B, K), dtype=torch.bool, device=device)
    mask = torch.empty((B, K, words), dtype=torch.int64, device=device)
    lib = _library()
    if device.index == torch.cuda.current_device():
        err = _launch(lib, sorted_boxes, valid, B, K, thresh, mask, keep)
    else:
        with torch.cuda.device(device):
            err = _launch(lib, sorted_boxes, valid, B, K, thresh, mask, keep)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: CUDA error {err}")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0


def nms_keep_plain(sorted_boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`nms_keep` (``nms_keep_plain.calls``
    counts its calls). Evaluates the predicate with the kernel's operations
    in the kernel's order, then walks the rows in order."""
    _check(sorted_boxes, valid)
    nms_keep_plain.calls += 1
    B, K = valid.shape
    t = torch.tensor(thresh, dtype=torch.float32, device=valid.device)
    x1, y1, x2, y2 = sorted_boxes.unbind(-1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp(min=0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp(min=0.0)
    inter = iw * ih
    area = (x2 - x1) * (y2 - y1)
    union = (area[:, :, None] + area[:, None, :]) - inter
    later = torch.ones((K, K), dtype=torch.bool, device=valid.device).triu(1)
    suppress = (inter > t * union.clamp(min=1e-12)) & later  # [b, i, j]: i removes j
    keep = valid.clone()
    for i in range(K):
        keep &= ~(suppress[:, i] & keep[:, i : i + 1])
    return keep


nms_keep_plain.calls = 0
