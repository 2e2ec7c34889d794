"""The roofline and FLOP arithmetic on hand-counted shapes."""
from __future__ import annotations

import contextlib
import json

import pytest
import torch

from conftest import BENCH


def test_bound_picks_the_larger_time():
    from core.roofline import bound

    assert bound(3.35e9, 0.0) == pytest.approx((1.0, "bytes"))
    assert bound(0.0, 67e9) == pytest.approx((1.0, "operations"))
    assert bound(0.0, 989e9, 989e12)[0] == pytest.approx(1.0)


def test_kernel_bounds_by_hand():
    from core import roofline as r

    # IoU (2, 3, 4) x (5, 4): 30 pairs: 120 B out, 96 + 80 B in; 17 x 30 operations
    assert r.iou_bound((2, 3, 4), (5, 4))[0] == pytest.approx(max(296 / 3.35e12, 510 / 67e12) * 1e3)
    # NMS, one image of 4 candidates, 3 valid, 2 kept: 4 x 18 B; 15 x (1 + 1) tests
    assert r.nms_bound(1, 4, torch.tensor([3]), torch.tensor([2]))[0] == pytest.approx(
        max(72 / 3.35e12, 30 / 67e12) * 1e3)
    # matching: 2 valid rows over 10 anchors, 1 image
    assert r.matching_bound(2, 1, 10)[0] == pytest.approx(max((160 + 50) / 3.35e12, 40 / 67e12) * 1e3)
    # RoIAlign backward: g (1, 2, 7, 7, 4) f32, one level 10 x 10
    n = 2 * 49 * 4
    assert r.roi_align_bwd_bound((1, 2, 7, 7, 4), 4, [(10, 10)])[0] == pytest.approx(
        max((n * 4 + 400 * 4 + 40) / 3.35e12, n * 36 / 67e12) * 1e3)


def test_roi_align_touched_by_hand():
    from core.roofline import roi_align_touched

    # a RoI on level 0 (stride 4) over [8, 36) on both axes: feature coordinates
    # 1.5 .. 8.5, bins of 1, two samples a bin at 1.75, 2.25, .., 8.25; each
    # sample reads its floor and the next row: rows and columns 1..9, 9 x 9
    rois = torch.tensor([[[8.0, 8.0, 36.0, 36.0]]])
    levels = torch.tensor([[0]])
    assert roi_align_touched([(32, 32), (16, 16)], (4, 8), rois, levels) == 81


def test_flops_of_a_convolution_and_the_step():
    from torch.utils.flop_counter import FlopCounterMode

    from core import port
    from reference.common import QConv2d

    conv = QConv2d(3, 8, 3, padding=1)
    with FlopCounterMode(display=False) as fc:
        conv(torch.zeros(2, 3, 16, 16))
    assert fc.get_total_flops() == 2 * 2 * 8 * 16 * 16 * 3 * 9
    cfg = json.loads((BENCH / "configs" / "yolox_s.json").read_text())
    fwd = port.flops_per_image(cfg, 2, (640, 640), train=False)
    step = port.flops_per_image(cfg, 2, (640, 640), train=True)
    assert 26e9 < fwd < 28e9  # YOLOX-S: 26.8 GFLOPs at 640x640 (Megvii's table), multiply-adds twice
    assert 2.5 * fwd < step <= 3 * fwd  # the stem needs no input gradient


def test_readers_on_a_made_up_trace():
    from core import readers
    from core.trace import Trace

    ops = [("void nms_mask_kernel<1>", 0.0, 10.0), ("sm90_xmma_fprop_implicit_gemm_bf16", 10.0, 40.0),
           ("batch_norm_collect_statistics_kernel", 50.0, 60.0), ("Memcpy HtoD", 60.0, 70.0),
           ("elementwise_kernel convert", 70.0, 100.0)]
    calls = {"nms": [(1, 4, torch.tensor([[True, True, True, False]]), torch.tensor([[True, True, False, False]]))]}
    tr = Trace(steps=2, stretch_s=200e-6, device_ops=ops, gap_labels=[("aten::item", 10e-6)], calls=calls)
    least = max(72 / 3.35e12, 30 / 67e12) * 1e3
    assert readers.roofline_share(tr, "nms") == pytest.approx(100 * least / 0.010)
    assert readers.roofline_share(tr, "matching") is None
    assert readers.conv_gemm_ms(tr) == pytest.approx(0.030 / 2)
    assert tr.busy_s() == pytest.approx(90e-6) and readers.idle_share(tr) == pytest.approx(55.0)
    assert readers.launches_per_step(tr) == 2.0
    tr.run = {"flops_per_image": 1e9, "images_per_s": 67.0, "peak_flops": 67e12}
    assert readers.step_mfu(tr) == pytest.approx(100 * 67e9 / 67e12)
    b = tr.breakdown()
    assert b["device_ops"][0][0].startswith("sm90_xmma") and b["idle_gaps"] == [["aten::item", 5e-6]]


@pytest.mark.parametrize("cell", ["yolox_s.train_b64", "frcnn_r50.train_b16", "frcnn_r50.infer_b8"])
def test_recorder_launches_nothing(tiny_f32, cell):
    """A step with the recorder active runs the same operations as one
    without it: the readers reduce the recorded tensors after the stretch."""
    from torch.profiler import ProfilerActivity, profile

    from core import manifest, trace

    c = manifest.load_cell(cell, tiny_f32)
    r = manifest.kind_module(c.kind).Run(c, 2 ** 31 + 7, "cpu")
    r.setup()
    step = r.step if c.kind == "train" else r.serve
    recorder, counts = trace.Recorder(), []
    for active in (False, True, False):
        r.k = 0
        with profile(activities=[ProfilerActivity.CPU]) as prof, \
                (recorder.active() if active else contextlib.nullcontext()):
            step()
        counts.append(sum(1 for e in prof.events() if e.name.startswith("aten::")))
    r.release()
    assert sum(len(v) for v in recorder.calls.values()) > 0
    assert counts[1] == counts[0] == counts[2], counts
