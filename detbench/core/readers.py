"""What the per-layer readers share: a kernel's share of its roofline over
the traced stretch, and the step's share of the chip's peak."""
from __future__ import annotations

from typing import Optional

from core import roofline
from core.trace import KERNELS, Trace


def least_ms(tr: Trace, key: str) -> float:
    """The least time of every recorded call of one kernel wrapper, from
    the call's arguments (read after the stretch)."""
    total = 0.0
    for call in tr.calls.get(key, ()):
        if key == "nms":
            B, K, valid, kept = call
            total += roofline.nms_bound(B, K, valid.sum(1).cpu(), kept.sum(1).cpu())[0]
        elif key == "matching":
            gt_valid, B, M = call
            total += roofline.matching_bound(int(gt_valid.sum()), B, M)[0]
        elif key == "iou":
            total += roofline.iou_bound(*call)[0]
        elif key == "roi_align_fwd":
            sizes, strides, channels, elem, rois, levels = call
            total += roofline.roi_align_bound(sizes, strides, channels, elem, rois, levels)[0]
        elif key == "roi_align_bwd":
            total += roofline.roi_align_bwd_bound(*call)[0]
    return total


def roofline_share(tr: Trace, *keys: str) -> Optional[float]:
    """100 × the least time of the calls over their kernels' device time;
    None where no call or no kernel time was seen."""
    device = sum(tr.kernel_ms(KERNELS[k]) for k in keys)
    least = sum(least_ms(tr, k) for k in keys)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device


def step_mfu(tr: Trace) -> Optional[float]:
    """100 × the reference's FLOPs an image × the window's images/s over the
    peak of the cell's compute dtype."""
    r = tr.run
    if not tr.device_ops or not r.get("flops_per_image") or not r.get("images_per_s"):
        return None
    return 100.0 * r["flops_per_image"] * r["images_per_s"] / r["peak_flops"]


def conv_gemm_ms(tr: Trace) -> Optional[float]:
    """Device ms a step in the operations that convolutions and matrix
    products launch (cuDNN's layout changes and FFTs included)."""
    ms = tr.conv_gemm_us() / 1e3
    return ms / tr.steps if ms > 0 else None


def idle_share(tr: Trace) -> Optional[float]:
    if tr.stretch_s <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.stretch_s)


def launches_per_step(tr: Trace) -> Optional[float]:
    n = tr.launches()
    return n / tr.steps if n else None
