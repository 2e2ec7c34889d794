"""The port's FreeAnchor against the JAX package on the CPU, tiny
(``tests/tiny.shrink`` on both configs: resnet10, FPN width 64, two anchors
per location, one conv per subnet, batch 2 of 128x192), on the same
weights: the bag losses and their gradients, and on a batch of crowded
same-class gts, whose top-128 box probabilities hit the same (anchor, class)
entries, the losses again (duplicates resolved by max, as
tests/models/test_free_anchor_variants.py requires of the JAX package) and
the box probability (the predicted boxes set at their anchors, so the gts
share their best anchors) against a loop over the hits. Both pairwise IoUs of a
step go through kernel #10's wrapper (its plain version here): 2 calls per
``get_losses``.

Tolerances: the losses to 1e-4 relative (sums over ~80,000 focal terms in
another order), each gradient to 1e-3 of its tensor's largest entry, as
tests/test_torch_fcos.py; the box probability exactly (a max of the same
values).
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.ops.iou_kernel import box_iou_plain
from tests.test_torch_fcos import (both_models, check_gradients, check_losses, jax_losses_and_grads,
                                   port_losses_and_grads)
from tests.torch_threads import torch_threads  # noqa: F401

LOSSES = {"total_loss", "pos_loss", "neg_loss"}


def crowded(batch):
    """Four near-identical class-1 boxes in each image, each about the P3
    anchor of scale 32 and ratio 0.5 centred at (36, 36) (45.3 x 22.6), so
    that their IoUs with it and its neighbours clear the 0.6 threshold."""
    b = {k: np.array(v) for k, v in batch.items()}
    b["gt_boxes"][:, :4, :4] = np.array([13.0, 25.0, 59.0, 47.0]) + np.arange(4).reshape(1, 4, 1)
    b["gt_boxes"][:, :4, 4] = 1.0
    b["gt_boxes"][:, 4:] = 0.0
    b["im_info"][:, 4] = 4
    return b


@pytest.fixture(scope="module")
def tiny():
    jmodel, variables, port, batch, _ = both_models("FreeAnchorConfig", seed=3)
    jlosses, jgrads = jax_losses_and_grads(jmodel, variables, batch)
    calls = box_iou_plain.calls
    losses, grads, no_grad = port_losses_and_grads(port, batch)
    return dict(jmodel=jmodel, variables=variables, port=port, batch=batch, jlosses=jlosses, jgrads=jgrads,
                losses=losses, grads=grads, no_grad=no_grad, iou_calls=box_iou_plain.calls - calls)


def test_losses_match_jax(tiny):
    assert tiny["iou_calls"] == 2  # gts x predicted boxes, gts x anchors
    check_losses(tiny["losses"], tiny["jlosses"], LOSSES)


def test_gradients_match_jax(tiny):
    check_gradients(tiny["grads"], tiny["jgrads"], tiny["no_grad"],
                    head_keys=("head/cls_score/bias", "head/bbox_pred/kernel"))


def test_duplicate_anchor_hits_resolve_by_max(tiny):
    port, batch = tiny["port"], crowded(tiny["batch"])
    want = jax_losses_and_grads(tiny["jmodel"], tiny["variables"], batch)[0]
    port.train()
    with torch.no_grad():
        got = port.get_losses(batch)[1]
        x = port.pre_process(batch, train=True)
        logits_l, offsets_l = port.module(x["image"])
        anchors = torch.cat(port.anchors(logits_l))
        offsets = torch.zeros_like(torch.cat(port.flatten(logits_l, offsets_l)[1], dim=1))  # boxes = anchors
        gt = x["gt_boxes"]
        a = port.assign(anchors, offsets, gt, x["img_info"][:, 4].long())
        valid, labels, box_prob = a["gt_valid"], a["labels"], a["box_prob"]
    port.eval()
    check_losses({k: float(v) for k, v in got.items()}, {k: float(v) for k, v in want.items()}, LOSSES)

    # the same top-128 hits, max-reduced one by one, with the predicted boxes
    # at their anchors: the crowded gts then share their best anchors
    pred = port.box_coder.decode(anchors[None], offsets)
    overlaps = torch.where(valid[..., None], box_iou_plain(gt[..., :4], pred), 0.0)
    t1 = port.cfg.MODEL.BUCKET.BOX_IOU_THRESH
    t2 = overlaps.amax(-1, keepdim=True).clamp(t1 + 1e-7, 1.0)
    prob = torch.where(valid[..., None], ((overlaps - t1) / (t2 - t1)).clamp(0.0, 1.0), 0.0)
    top, idx = torch.sort(prob, dim=-1, descending=True, stable=True)
    ref = torch.zeros_like(box_prob)
    hits = 0
    for b in range(2):
        for k in range(4):
            for p in range(128):
                r, c = int(idx[b, k, p]), int(labels[b, k])
                hits += bool(top[b, k, p] > 0 and ref[b, r, c] > 0)
                ref[b, r, c] = max(float(ref[b, r, c]), float(top[b, k, p]))
    assert hits > 0  # duplicates are live
    assert torch.equal(box_prob, ref)
