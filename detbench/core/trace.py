"""The traced stretch of a ``--trace 1`` run: a padded ``torch.profiler``
window over a few steady steps, the arguments of the port's kernel calls
recorded by wrapping its op functions, and what the per-layer readers read.

The profiler keeps a device record only if its timestamp, converted to the
host's clock, lies inside the window, so the window is padded by 50 ms of
idle on each side (``scripts/profiler_window_probe.py``). Device times come
from the device's own records; the stretch's length from the host's clock
around work that ends in a synchronise.
"""
from __future__ import annotations

import contextlib
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

PAD_S = 0.05
# a device operation is a convolution's or a matrix product's if a host
# operation that launched it is one, or else if its own name says so
CONV_GEMM_HOST = re.compile(r"conv(?!ert)|^aten::(mm|addmm|bmm|baddbmm|matmul|linear|_scaled_mm)$|(Mm|Addmm|Bmm)Backward",
                            re.IGNORECASE)
CONV_GEMM = re.compile(r"gemm|xmma|conv(?!ert)|cutlass|wgrad|dgrad|fprop|winograd|splitk|fft", re.IGNORECASE)
KERNELS = {  # the port's kernels by the names the profiler gives their launches
    "nms": ("nms_mask_kernel", "nms_sweep_kernel"),
    "matching": ("match_kernel",),
    "iou": ("iou_kernel",),
    "roi_align_fwd": ("roi_align_fwd_kernel", "roi_align_fwd_bf16_kernel"),
    "roi_align_bwd": ("roi_align_bwd_kernel", "roi_align_bwd_bf16_kernel"),
}


class Recorder:
    """While active, every call of the port's NMS, matching, IoU and RoIAlign
    wrappers records what its bound needs: shapes, and references to the
    call's own tensors, which the readers reduce once the stretch has ended,
    so that the recorder launches nothing on the device. Each wrapper
    replaces the function wherever a module of the port holds it, and is put
    back on exit."""

    def __init__(self):
        from basedet_tpu_torch.ops import iou_kernel, matching_kernel, nms_kernel, roi_align_kernel

        self.calls: Dict[str, List] = {k: [] for k in KERNELS}
        c = self.calls

        def nms(fn):
            def wrapped(sorted_boxes, valid, thresh):
                keep = fn(sorted_boxes, valid, thresh)
                c["nms"].append((*valid.shape, valid, keep))
                return keep
            return wrapped

        def matching(fn):
            def wrapped(cost, ious, gt_valid, candidate_topk=10):
                c["matching"].append((gt_valid, cost.shape[0], cost.shape[2]))
                return fn(cost, ious, gt_valid, candidate_topk)
            return wrapped

        def iou(fn):
            def wrapped(boxes1, boxes2):
                c["iou"].append((tuple(boxes1.shape), tuple(boxes2.shape)))
                return fn(boxes1, boxes2)
            return wrapped

        def roi_fwd(fn):
            def wrapped(features, rois, levels, strides, output_size=(7, 7)):
                c["roi_align_fwd"].append(([tuple(f.shape[-2:]) for f in features], tuple(strides),
                                           features[0].shape[1], features[0].element_size(), rois, levels))
                return fn(features, rois, levels, strides, output_size)
            return wrapped

        def roi_bwd(fn):
            def wrapped(grad, rois, levels, strides, sizes):
                c["roi_align_bwd"].append((tuple(grad.shape), grad.element_size(), [tuple(s) for s in sizes]))
                return fn(grad, rois, levels, strides, sizes)
            return wrapped

        self.targets = [(nms_kernel.nms_keep, nms), (matching_kernel.dynamic_k_matching, matching),
                        (iou_kernel.box_iou, iou), (roi_align_kernel.multilevel_roi_align, roi_fwd),
                        (roi_align_kernel.multilevel_roi_align_backward, roi_bwd)]

    @contextlib.contextmanager
    def active(self):
        patched = []
        for fn, make in self.targets:
            wrapper = make(fn)
            wrapper.__dict__ = fn.__dict__  # the wrapped function counts its launches on itself by name
            for mod in list(sys.modules.values()):
                if getattr(mod, "__name__", "").startswith("basedet_tpu_torch"):
                    for attr, val in list(vars(mod).items()):
                        if val is fn:
                            setattr(mod, attr, wrapper)
                            patched.append((mod, attr, fn))
        try:
            yield self
        finally:
            for mod, attr, fn in patched:
                setattr(mod, attr, fn)


@dataclass
class Trace:
    """What a traced stretch of ``steps`` steps read, for the per-layer
    readers: device operations (name, start µs, end µs) on the device's
    clock, the host operations that launched each (innermost first), the
    label of each idle gap, the stretch's host seconds, the recorder's
    calls, and the run's own figures in ``run``."""

    steps: int
    stretch_s: float
    device_ops: List[Tuple[str, float, float]]
    gap_labels: List[Tuple[str, float]]
    calls: Dict[str, List]
    run: Dict = field(default_factory=dict)
    origins: List[Tuple[str, ...]] = field(default_factory=list)

    def conv_gemm_us(self) -> float:
        """Device µs over the stretch in convolutions and matrix products."""
        origins = self.origins or [()] * len(self.device_ops)
        return sum(e - s for (n, s, e), chain in zip(self.device_ops, origins)
                   if any(CONV_GEMM_HOST.search(h) for h in chain) or CONV_GEMM.search(n))

    def kernel_ms(self, names) -> float:
        """Device ms over the stretch of the operations whose name holds any of ``names``."""
        return sum(e - s for n, s, e in self.device_ops if any(k in n for k in names)) / 1e3

    def busy_s(self) -> float:
        ops = sorted((s, e) for _, s, e in self.device_ops)
        busy, run_s, run_e = 0.0, None, None
        for s, e in ops:
            if run_e is None or s > run_e:
                if run_e is not None:
                    busy += run_e - run_s
                run_s, run_e = s, e
            else:
                run_e = max(run_e, e)
        if run_e is not None:
            busy += run_e - run_s
        return busy / 1e6

    def launches(self) -> int:
        return sum(1 for n, _, _ in self.device_ops if not n.startswith(("Memcpy", "Memset")))

    def breakdown(self) -> Dict:
        """The ten device operations that took most time, and the ten
        labels under which the device sat idle longest, seconds per step."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s) / 1e6
        gaps: Dict[str, float] = {}
        for label, secs in self.gap_labels:
            gaps[label] = gaps.get(label, 0.0) + secs
        top = lambda d: [[k, v / self.steps] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


SYNC = re.compile(r"^(Context Sync|Stream Sync|Event Sync|Stream Wait Event|Device Synchronize)")


def _chain(op) -> Tuple[str, ...]:
    names = []
    while op is not None:
        names.append(op.name)
        op = op.cpu_parent
    return tuple(names)


def _device_records(prof):
    """The device's operations (name, start µs, end µs) from the profiler's
    own records (the waits it logs on the device's timeline left out), the
    host operations that launched each, innermost first, and each idle
    stretch between them, labelled with the host operation that launched
    the operation ending it (what the device waited for)."""
    raw = prof.profiler.kineto_results.events()
    host = {e.id: e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    dev = sorted(((e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.linked_correlation_id())
                  for e in raw if e.device_type() == torch.autograd.DeviceType.CUDA and not SYNC.match(e.name())),
                 key=lambda r: r[1])
    gaps, run_end = [], None
    for name, start, end, link in dev:
        if run_end is not None and start > run_end:
            op = host.get(link)
            while op is not None and op.name.startswith(("cuda", "cu")) and op.cpu_parent is not None:
                op = op.cpu_parent
            gaps.append((op.name[:120] if op is not None else "unlinked", (start - run_end) / 1e6))
        run_end = end if run_end is None else max(run_end, end)
    return [(n, s, e) for n, s, e, _ in dev], [_chain(host.get(link)) for *_, link in dev], gaps


def traced_stretch(step: Callable[[], None], steps: int, recorder: Optional[Recorder]) -> Trace:
    """Run ``step`` ``steps`` times under the profiler (CPU and CUDA
    activity), padded, with the recorder active; no trace is written."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    ctx = recorder.active() if recorder is not None else contextlib.nullcontext()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof, ctx:
        time.sleep(PAD_S)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        stretch = time.perf_counter() - t0
        time.sleep(PAD_S)
    device_ops, origins, gaps = _device_records(prof)
    return Trace(steps, stretch, device_ops, gaps, recorder.calls if recorder is not None else {},
                 origins=origins)
