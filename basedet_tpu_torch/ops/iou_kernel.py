"""Pairwise IoU of xyxy f32 boxes: the CUDA kernel in ``csrc/iou.cu`` and its
wrapper (counterpart of ``basedet_tpu/ops/iou_pallas.py``).

The kernel replaces ``basedet_tpu/ops/iou_pallas.py::_iou_kernel``
(``box_iou_pallas``, kernel #10). The JAX package dispatches to it only on a
TPU, for 2-D inputs with M·N >= 256²; its models call the fused ``jnp`` form
``structures/box_ops.py::box_iou``. The port launches the kernel for every
CUDA input, with no size threshold, and RetinaNet's anchor assignment calls
it: 100 padded gts against 201,600 anchors per image at 800x1344.

On the card the work is bound by bytes: the (B, M, N) f32 output is written
once and is the only large array. Eager PyTorch writes full-size
temporaries (lt, rb, wh, inter, union, the clamp, the quotient) about twenty
times the output's bytes. The plain version, which a CPU tensor takes, is
``structures/box_ops.py::box_iou``, exported here as ``box_iou_plain``; the
kernel follows its arithmetic term by term and gives its bits on finite
inputs.

The kernel has no gradient, as the TPU kernel has no VJP: an input that
requires grad raises. It is built from the repository's source at first use
and bound with ``ctypes`` (``ops/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from basedet_tpu_torch.ops._build import CSRC, load_library
from basedet_tpu_torch.structures.box_ops import box_iou as box_iou_plain

SOURCE = CSRC / "iou.cu"

__all__ = ["box_iou", "box_iou_plain"]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.basedet_box_iou
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(boxes1: torch.Tensor, boxes2: torch.Tensor) -> None:
    shapes = f"{tuple(boxes1.shape)} and {tuple(boxes2.shape)}"
    if boxes1.dtype != torch.float32 or boxes2.dtype != torch.float32:
        raise ValueError(f"box_iou takes f32 boxes, got {boxes1.dtype} and {boxes2.dtype}")
    if boxes1.device != boxes2.device:
        raise ValueError(f"box_iou: boxes on {boxes1.device} and {boxes2.device}")
    if boxes1.requires_grad or boxes2.requires_grad:
        raise ValueError("box_iou has no gradient (the TPU kernel has no VJP): pass boxes that "
                         "do not require grad")
    if boxes1.shape[-1:] != (4,) or boxes2.shape[-1:] != (4,):
        raise ValueError(f"box_iou takes (..., 4) xyxy boxes, got {shapes}")
    if boxes1.dim() == 2:
        ok = boxes2.dim() == 2
    else:
        ok = boxes1.dim() == 3 and (boxes2.dim() == 2
                                    or (boxes2.dim() == 3 and boxes2.shape[0] == boxes1.shape[0]))
    if not ok:
        raise ValueError(f"box_iou takes (M, 4) with (N, 4), or (B, M, 4) with (N, 4) or (B, N, 4); "
                         f"got {shapes}")


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy f32 boxes, 0 where the union is not positive:
    boxes1 (B, M, 4) with boxes2 (N, 4), shared by every image, or (B, N, 4)
    → (B, M, N); boxes1 (M, 4) with boxes2 (N, 4) → (M, N).

    A CUDA tensor goes through the kernel (``box_iou.launches`` counts its
    launches), a CPU tensor through :func:`box_iou_plain`
    (``box_iou_plain.calls``); any other device raises."""
    _check(boxes1, boxes2)
    if boxes1.device.type == "cpu":
        return box_iou_plain(boxes1, boxes2)
    if boxes1.device.type != "cuda":
        raise ValueError(f"no IoU kernel for device {boxes1.device}")
    flat = boxes1.dim() == 2
    b1 = boxes1.contiguous()[None] if flat else boxes1.contiguous()
    b2 = boxes2.contiguous()
    B, M, N = b1.shape[0], b1.shape[1], b2.shape[-2]
    out = torch.empty(B, M, N, dtype=torch.float32, device=b1.device)
    if out.numel():
        with torch.cuda.device(b1.device):
            stream = torch.cuda.current_stream(b1.device).cuda_stream
            err = _library().basedet_box_iou(b1.data_ptr(), b2.data_ptr(), B, M, N,
                                             N * 4 if b2.dim() == 3 else 0, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"IoU kernel launch failed: CUDA error {err}")
        box_iou.launches += 1
    return out[0] if flat else out


box_iou.launches = 0
