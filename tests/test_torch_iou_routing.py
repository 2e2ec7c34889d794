"""Every pairwise IoU of the port's models goes through kernel #10's wrapper
(``basedet_tpu_torch/ops/iou_kernel.py::box_iou``), which a CUDA tensor takes
to the kernel and a CPU tensor to the plain version: Faster R-CNN's RPN
targets and R-CNN sampling, YOLOX's SimOTA (in f32 and under the bf16
policy), RetinaNet's anchor assignment, ATSS's assignment (once a step) and
FreeAnchor's bag loss (twice a step), YOLOv3's anchor match and ignore mask
(twice a step); DETR calls it never; and OTA's dynamic-k matching goes
through ``ops/matching_kernel.py::dynamic_k_matching`` once a step.

On the CPU the wrapper returns the plain version's result, so the callers'
outputs are unchanged bit for bit: the RPN targets with the anchors shared by
every image ((R, 4), the kernel's ``b2_batch_stride = 0`` form) equal those
of the broadcast ``anchors[None]`` that the plain version took before. The
count tests patch the wrapper's own reference to the plain version, so they
see only the calls that went through the wrapper. No JAX here: the port's own
configs, shrunk with ``tests/tiny.py``.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch import build_model
from basedet_tpu_torch.configs import (ATSSConfig, DETRConfig, FasterRCNNConfig, FreeAnchorConfig, OTAConfig,
                                       YOLOv3Config, YOLOXSConfig)
from basedet_tpu_torch.layers.common.matcher import Matcher
from basedet_tpu_torch.layers.head import rcnn
from basedet_tpu_torch.layers.precision import precision_policy
from basedet_tpu_torch.layers.common import matcher
from basedet_tpu_torch.models.det import atss, free_anchor, retinanet, rpn, yolov3, yolox
from basedet_tpu_torch.ops import iou_kernel
from basedet_tpu_torch.ops.iou_kernel import box_iou_plain
from basedet_tpu_torch.structures import BoxCoder
from basedet_tpu_torch.utils.dummy import DummyLoader
from chip_smoke import _iou_boxes
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401


@pytest.mark.parametrize("caller", [rpn, rcnn, yolox, retinanet, atss, free_anchor, yolov3],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_callers_take_the_wrapper(caller):
    assert caller.box_iou is iou_kernel.box_iou


def test_rpn_ground_truth_with_shared_anchors_is_unchanged(monkeypatch):
    """(R, 4) anchors give what ``anchors[None]`` gave through the plain
    version, bit for bit: labels, sampling and offsets."""
    rng = np.random.RandomState(0)
    B, K, R = 2, 10, 900
    gt = torch.zeros(B, K, 5)
    gt[0, :4, :4] = _iou_boxes(rng, (4, 4), 300.0)
    gt[1, :2, :4] = _iou_boxes(rng, (2, 4), 300.0)
    gt[..., 4] = torch.where(gt[..., 2] > 0, 1.0, 0.0)
    num_valid = torch.tensor([4, 2])
    anchors = _iou_boxes(rng, (R, 4), 300.0)
    noise_pos, noise_neg = (torch.from_numpy(rng.uniform(size=(B, R)).astype(np.float32)) for _ in range(2))
    args = (noise_pos, noise_neg, anchors, gt, num_valid, Matcher((0.3, 0.7), (0, -1, 1), True),
            BoxCoder((0.0, 0.0, 0.0, 0.0), (1.0, 1.0, 1.0, 1.0)), 256, 128)

    labels, offsets = rpn.rpn_ground_truth(*args)
    monkeypatch.setattr(rpn, "box_iou", lambda boxes1, anchors: box_iou_plain(boxes1, anchors[None]))
    old_labels, old_offsets = rpn.rpn_ground_truth(*args)
    assert (labels == 1).any() and (labels == 0).any()
    assert torch.equal(labels, old_labels)
    assert torch.equal(offsets.view(torch.int32), old_offsets.view(torch.int32))


def _counting(monkeypatch):
    """Count the calls that reach the plain version through the wrapper, with
    the shapes and dtypes they carried."""
    seen = []

    def plain(boxes1, boxes2):
        seen.append((tuple(boxes1.shape), tuple(boxes2.shape), boxes1.dtype, boxes2.dtype))
        return box_iou_plain(boxes1, boxes2)

    monkeypatch.setattr(iou_kernel, "box_iou_plain", plain)
    return seen


def _tiny(cfg, image_size, max_instances):
    shrink(cfg)
    cfg.DATA.MAX_INSTANCES = max_instances
    torch.manual_seed(0)
    model = build_model(cfg, "cpu").train()
    batch = DummyLoader(batch_size=2, image_size=image_size, max_instances=max_instances).make_batch(0)
    return model, batch


def test_faster_rcnn_get_losses_takes_the_wrapper_twice(monkeypatch):
    model, batch = _tiny(FasterRCNNConfig(), (128, 192), 6)
    seen = _counting(monkeypatch)
    plain = box_iou_plain.calls
    model.get_losses(batch)
    assert box_iou_plain.calls - plain == len(seen) == 2  # RPN targets, then R-CNN sampling
    (rpn_b1, rpn_b2, *rpn_dtypes), (rcnn_b1, rcnn_b2, *rcnn_dtypes) = seen
    assert rpn_b1 == (2, 6, 4) and len(rpn_b2) == 2  # the anchors shared by every image
    assert rcnn_b1 == (2, model.cfg.MODEL.RPN.TRAIN_POST_NMS_TOPK + 6, 4) and rcnn_b2 == (2, 6, 4)
    assert set(rpn_dtypes + rcnn_dtypes) == {torch.float32}


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16 policy"])
def test_yolox_get_losses_takes_the_wrapper_once(monkeypatch, amp):
    """SimOTA's IoU takes f32 boxes under the bf16 policy too: the head's
    outputs become f32 before the decode, so the wrapper never refuses them."""
    model, batch = _tiny(YOLOXSConfig(), (128, 128), 8)
    seen = _counting(monkeypatch)
    with precision_policy(torch.bfloat16 if amp else None):
        model.get_losses(batch)
    num_anchors = sum((128 // s) ** 2 for s in (8, 16, 32))
    assert seen == [((2, 8, 4), (2, num_anchors, 4), torch.float32, torch.float32)]


def test_atss_get_losses_takes_the_wrapper_once(monkeypatch):
    """The gts against the pseudo-anchors shared by every image, (B, K, 4) x
    (R, 4), once a step."""
    model, batch = _tiny(ATSSConfig(), (128, 192), 6)
    seen = _counting(monkeypatch)
    model.get_losses(batch)
    num_points = sum((128 // s) * (192 // s) for s in (8, 16, 32)) + 2 * 3 + 1 * 2
    assert seen == [((2, 6, 4), (num_points, 4), torch.float32, torch.float32)]


def test_free_anchor_get_losses_takes_the_wrapper_twice(monkeypatch):
    """The gts against each image's predicted boxes, (B, K, 4) x (B, R, 4),
    then against the shared anchors, (R, 4)."""
    model, batch = _tiny(FreeAnchorConfig(), (128, 192), 6)
    seen = _counting(monkeypatch)
    model.get_losses(batch)
    R = 2 * (sum((128 // s) * (192 // s) for s in (8, 16, 32)) + 2 * 3 + 1 * 2)
    assert seen == [((2, 6, 4), (2, R, 4), torch.float32, torch.float32),
                    ((2, 6, 4), (R, 4), torch.float32, torch.float32)]


def test_ota_get_losses_takes_the_matching_wrapper_once(monkeypatch):
    """OTA's dynamic-k matching: one call over the batch, (B, K, R) cost and
    ious, through the wrapper that sends a CUDA tensor to kernel #2."""
    model, batch = _tiny(OTAConfig(), (128, 192), 6)
    seen = []
    fn = matcher.dynamic_k_matching
    monkeypatch.setattr(matcher, "dynamic_k_matching",
                        lambda *args: seen.append(tuple(a.shape for a in args[:3]) + args[3:]) or fn(*args))
    model.get_losses(batch)
    R = sum((128 // s) * (192 // s) for s in (8, 16, 32)) + 2 * 3 + 1 * 2
    assert seen == [((2, 6, R), (2, 6, R), (2, 6), 10)]


def test_yolov3_get_losses_takes_the_wrapper_twice(monkeypatch):
    """The gts' centred (0, 0, w, h) boxes against the 9 anchors, (B, K, 4) x
    (9, 4); then every level's decoded boxes, detached, against each image's
    gts in one call, (B, R, 4) x (B, K, 4), the JAX package's operand order."""
    cfg = YOLOv3Config()
    cfg.MODEL.BACKBONE.NAME = "darknet21"
    cfg.MODEL.BACKBONE.OUT_CHANNELS = 8
    model, batch = _tiny(cfg, (128, 192), 6)
    seen = _counting(monkeypatch)
    model.get_losses(batch)
    R = 3 * sum((128 // s) * (192 // s) for s in (32, 16, 8))
    assert seen == [((2, 6, 4), (9, 4), torch.float32, torch.float32),
                    ((2, R, 4), (2, 6, 4), torch.float32, torch.float32)]


def test_detr_get_losses_never_takes_the_wrapper(monkeypatch):
    """DETR's matching cost takes the elementwise GIoU, not the pairwise IoU."""
    model, batch = _tiny(DETRConfig(), (128, 192), 6)
    seen = _counting(monkeypatch)
    model.get_losses(batch)
    assert seen == []
