"""SimOTA dynamic-k matching: the CUDA kernel in ``csrc/matching.cu`` and its
plain version.

Replaces ``basedet_tpu/ops/matching_pallas.py::_matching_kernel``. Over cost
and ious (B, K, M) and gt_valid (B, K): each valid gt takes
``dk = clip(int(sum of its k largest ious), 1, k)`` (k = min(candidate_topk,
M), the f32 sum taken largest first) and marks its dk lowest-cost anchors,
the lowest index first among equal costs; an anchor marked by several gts
goes to the lowest-cost one, the lowest gt index first. Returns
``(best_gt (B, M) int32, fg (B, M) bool)``, with best_gt 0 where fg is false,
as the Pallas kernel and the scan version give it. Costs must be finite.

On the card the kernel is bound by bytes: it reads each valid row of cost and
ious once and skips padded gts, where the plain version makes 2k full passes
over (B, K, M). One launch a call: a block per (image, gt) row finds its k
largest ious and dk lowest costs by a radix select over order-preserving
32-bit keys (the row in shared memory where it fits, ``MAX_STAGED``), and
the last block of each image decodes the image's claims. Its scratch, 64-bit
claim keys per anchor and a done-counter per image, is allocated once per
device and stream and cached: the kernel leaves it as it found it. See
``csrc/matching.cu``. The assignment is piecewise constant, so nothing here
carries a gradient: callers pass detached tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from basedet_tpu_torch.ops._build import CSRC, load_library

SOURCE = CSRC / "matching.cu"
MAX_TOPK = 10  # kMaxK of the source: the most ious summed and costs taken
MAX_STAGED = 16384  # kMaxStaged of the source: longer rows are streamed from device memory


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.basedet_dynamic_k_matching
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(cost: torch.Tensor, ious: torch.Tensor, gt_valid: torch.Tensor) -> None:
    if cost.dim() != 3 or cost.shape[1] < 1 or cost.shape[2] < 1:
        raise ValueError(f"cost must be (B, K, M) with K, M >= 1, got {tuple(cost.shape)}")
    if cost.dtype != torch.float32 or ious.dtype != torch.float32:
        raise TypeError(f"cost and ious must be float32, got {cost.dtype}, {ious.dtype}")
    if ious.shape != cost.shape:
        raise ValueError(f"ious {tuple(ious.shape)} must match cost {tuple(cost.shape)}")
    if gt_valid.shape != cost.shape[:2] or gt_valid.dtype != torch.bool:
        raise ValueError(
            f"gt_valid must be bool {tuple(cost.shape[:2])}, "
            f"got {gt_valid.dtype} {tuple(gt_valid.shape)}"
        )
    if not (cost.device == ious.device == gt_valid.device):
        raise ValueError("cost, ious and gt_valid lie on different devices")


_SCRATCH = {}


def _scratch(device: torch.device, stream: int, B: int, M: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch on one stream, at least (B, M) claim keys (int64,
    all bits set: the kernel's kNone) and B done-counters (int32, 0). The
    kernel leaves both so, so they are made once and grown only when a call
    needs more."""
    key = (device.index, stream)
    keys, done = _SCRATCH.get(key, (None, None))
    if keys is None or keys.numel() < B * M or done.numel() < B:
        n_keys = max(B * M, 0 if keys is None else keys.numel())
        n_done = max(B, 0 if done is None else done.numel())
        keys = torch.full((n_keys,), -1, dtype=torch.int64, device=device)
        done = torch.zeros(n_done, dtype=torch.int32, device=device)
        _SCRATCH[key] = keys, done
    return keys, done


def dynamic_k_matching(
    cost: torch.Tensor, ious: torch.Tensor, gt_valid: torch.Tensor, candidate_topk: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched dynamic-k matching → (best_gt (B, M) int32, fg (B, M) bool).

    A CUDA tensor goes through the kernel (``dynamic_k_matching.launches``
    counts its launches): one launch, the outputs its only allocation. A CPU
    tensor goes through :func:`dynamic_k_matching_plain`."""
    _check(cost, ious, gt_valid)
    if cost.device.type == "cpu":
        return dynamic_k_matching_plain(cost, ious, gt_valid, candidate_topk)
    if cost.device.type != "cuda":
        raise ValueError(f"no matching kernel for device {cost.device}")
    if not (cost.is_contiguous() and ious.is_contiguous() and gt_valid.is_contiguous()):
        raise ValueError("dynamic_k_matching needs contiguous cost, ious and gt_valid")
    B, K, M = cost.shape
    k = min(candidate_topk, M)
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"candidate_topk must give 1 <= k <= {MAX_TOPK}, got {k}")
    if B * K >= 2**31 or M >= 2**31:
        raise ValueError(f"dynamic_k_matching supports B*K, M < 2**31, got {B}x{K}, {M}")
    out = torch.empty(5 * B * M, dtype=torch.uint8, device=cost.device)
    best_gt = out[:4 * B * M].view(torch.int32).view(B, M)
    fg = out[4 * B * M:].view(torch.bool).view(B, M)
    lib = _library()
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream(cost.device).cuda_stream
        keys, done = _scratch(cost.device, stream, B, M)
        err = lib.basedet_dynamic_k_matching(
            cost.data_ptr(), ious.data_ptr(), gt_valid.data_ptr(), B, K, M, k,
            keys.data_ptr(), done.data_ptr(), best_gt.data_ptr(), fg.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"matching kernel launch failed: CUDA error {err}")
    dynamic_k_matching.launches += 1
    return best_gt, fg


dynamic_k_matching.launches = 0


def dynamic_k_matching_plain(
    cost: torch.Tensor, ious: torch.Tensor, gt_valid: torch.Tensor, candidate_topk: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`dynamic_k_matching`
    (``dynamic_k_matching_plain.calls`` counts its calls): the scan
    formulation of ``basedet_tpu/layers/common/matcher.py``, k argmax passes
    for dk and k argmin passes for the picks. ``argmax``/``argmin`` return
    the first index among ties, which is the kernel's tie-break."""
    _check(cost, ious, gt_valid)
    dynamic_k_matching_plain.calls += 1
    B, K, M = cost.shape
    k = min(candidate_topk, M)
    col = torch.arange(M, device=cost.device)

    work, iou_sum = ious, torch.zeros((B, K), dtype=torch.float32, device=cost.device)
    for _ in range(k):
        iou_sum = iou_sum + work.amax(dim=2)
        pick = col == work.argmax(dim=2, keepdim=True)
        work = torch.where(pick, -torch.inf, work)
    dynamic_ks = iou_sum.to(torch.int32).clamp(1, k)
    dynamic_ks = torch.where(gt_valid, dynamic_ks, 0)

    work, matching = cost, torch.zeros((B, K, M), dtype=torch.bool, device=cost.device)
    for i in range(k):
        pick = col == work.argmin(dim=2, keepdim=True)
        matching |= pick & (i < dynamic_ks)[..., None]
        work = torch.where(pick, torch.inf, work)

    best_gt = torch.where(matching, cost, torch.inf).argmin(dim=1)
    return best_gt.to(torch.int32), matching.any(dim=1)


dynamic_k_matching_plain.calls = 0
