"""Pairwise IoU of xyxy f32 boxes: the CUDA kernel in ``csrc/iou.cu`` and its
wrapper (counterpart of ``basedet_tpu/ops/iou_pallas.py``).

The kernel replaces ``basedet_tpu/ops/iou_pallas.py::_iou_kernel``
(``box_iou_pallas``, kernel #10). The JAX package dispatches to it only on a
TPU, for 2-D inputs with M·N >= 256²; its models call the fused ``jnp`` form
``structures/box_ops.py::box_iou``. The port sends every pairwise IoU of its
models through :func:`box_iou`, which launches the kernel for every CUDA
input, with no size threshold: RetinaNet's anchor assignment (100 padded gts
against 201,600 anchors per image at 800x1344), Faster R-CNN's RPN targets
(against 268,569 anchors) and its R-CNN sampling (1,100 candidates against
the 100 gts), and YOLOX's SimOTA (100 gts against 8,400 predicted boxes).

On the card the work is bound by bytes: the (B, M, N) f32 output is written
once and is the only large array. Eager PyTorch writes full-size
temporaries (lt, rb, wh, inter, union, the clamp, the quotient) about twenty
times the output's bytes. The kernel computes an element in full only where
its pair can intersect: a warp owns a strip of ``STRIP_COLS`` columns and a
chunk of up to 32 rows, and a row whose box misses the envelope of
the strip's boxes2 stores zeros (``csrc/iou.cu`` says why that is exact, the
sign of zero included). :func:`iou_tile_model` is that rule on the CPU, for
the tests. The plain version, which a CPU tensor takes, is
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
import torch.nn.functional as F

from basedet_tpu_torch.ops._build import CSRC, load_library
from basedet_tpu_torch.structures.box_ops import box_iou as box_iou_plain

SOURCE = CSRC / "iou.cu"
STRIP_COLS = 128  # columns per warp (kCols in csrc/iou.cu)

__all__ = ["box_iou", "box_iou_plain", "iou_skip_mask", "iou_tile_model"]


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


def _aligned(boxes: torch.Tensor) -> torch.Tensor:
    """``boxes`` contiguous and 16-byte aligned, as the kernel loads a box at
    a time."""
    boxes = boxes.contiguous()
    return boxes if boxes.data_ptr() % 16 == 0 else boxes.clone()


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
    b1 = _aligned(boxes1[None] if flat else boxes1)
    b2 = _aligned(boxes2)
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


def _neg_zero(t: torch.Tensor) -> torch.Tensor:
    return (t == 0) & torch.signbit(t)


def iou_skip_mask(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """The kernel's skip rule: (B, M, S) bool, S = ceil(N / STRIP_COLS), true
    where row m of image b stores zeros across strip s with no arithmetic.
    That is where the row's box misses the envelope of the strip's boxes2
    (min(x2, max x2) - max(x1, min x1) <= 0 in x or in y, in f32) and neither
    the row nor the strip holds a -0.0 coordinate. Shapes as :func:`box_iou`;
    boxes1 (M, 4) counts as B = 1. Runs on any device, in plain PyTorch."""
    b1 = boxes1[None] if boxes1.dim() == 2 else boxes1
    B, N = b1.shape[0], boxes2.shape[-2]
    b2 = boxes2.expand(B, N, 4)
    S = -(-N // STRIP_COLS)
    pad = S * STRIP_COLS - N

    def per_strip(t: torch.Tensor, fill, reduce):  # (B, N) → (B, S)
        return reduce(F.pad(t, (0, pad), value=fill).view(B, S, STRIP_COLS), -1)

    inf = float("inf")
    lo_x, lo_y = (per_strip(b2[..., i], inf, torch.amin)[:, None] for i in (0, 1))
    hi_x, hi_y = (per_strip(b2[..., i], -inf, torch.amax)[:, None] for i in (2, 3))
    strip_neg0 = per_strip(_neg_zero(b2).any(-1).float(), 0.0, torch.amax)[:, None] > 0
    row_neg0 = _neg_zero(b1).any(-1)[..., None]
    ux = torch.minimum(b1[..., 2, None], hi_x) - torch.maximum(b1[..., 0, None], lo_x)
    uy = torch.minimum(b1[..., 3, None], hi_y) - torch.maximum(b1[..., 1, None], lo_y)
    return ((ux <= 0) | (uy <= 0)) & ~strip_neg0 & ~row_neg0


def iou_tile_model(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """The kernel's output decomposed as it computes it, on the CPU: the plain
    arithmetic on every (row, strip) that :func:`iou_skip_mask` keeps, +0.0
    on the rest. Equal to :func:`box_iou_plain` bit for bit where the skip rule
    is exact, which is what the tests hold it to."""
    skip = iou_skip_mask(boxes1, boxes2)
    out = box_iou_plain(boxes1, boxes2)
    zeros = skip.repeat_interleave(STRIP_COLS, -1)[..., :out.shape[-1]]
    return torch.where(zeros.reshape(out.shape), torch.zeros((), dtype=out.dtype), out)
