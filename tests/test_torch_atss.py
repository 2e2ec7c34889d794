"""The port's ATSS against the JAX package on the CPU, tiny (as
tests/test_torch_fcos.py shrinks it: resnet10, FPN width 64, one conv per
subnet, batch 2 of 128x192), on the same weights: the assignment, the
losses, their gradients and the detections. The first gt is centred on a
point of the grid's symmetry (64, 64), between four P3 points, so the
per-level top-9 closest centres tie at the ninth place and the lowest index
must win on both sides. The pseudo-anchor IoU goes through kernel #10's
wrapper, which a CPU tensor takes to the plain version, once per
``get_losses``.

Tolerances as in tests/test_torch_fcos.py: labels and ltrb targets exactly,
the target centerness to 2 ulps, the losses to 1e-4 relative, each gradient
to 1e-3 of its tensor's largest entry, detections at least 95% matched.
"""
import pytest
import torch

from basedet_tpu_torch.ops.iou_kernel import box_iou_plain
from tests.test_torch_fcos import (both_models, check_assignment, check_detections, check_gradients,
                                   check_losses, jax_assignment, jax_losses_and_grads, port_losses_and_grads)
from tests.torch_threads import torch_threads  # noqa: F401


def with_symmetric_gt(batch):
    batch["gt_boxes"][0, 0, :4] = [40.0, 40.0, 88.0, 88.0]
    return batch


@pytest.fixture(scope="module")
def tiny():
    jmodel, variables, port, batch, head = both_models("ATSSConfig", seed=1)
    batch = with_symmetric_gt(batch)
    jlosses, jgrads = jax_losses_and_grads(jmodel, variables, batch)
    calls = box_iou_plain.calls
    losses, grads, no_grad = port_losses_and_grads(port, batch)
    return dict(jmodel=jmodel, variables=variables, port=port, batch=batch, head=head, jlosses=jlosses,
                jgrads=jgrads, losses=losses, grads=grads, no_grad=no_grad, iou_calls=box_iou_plain.calls - calls)


def test_candidate_distances_tie_at_the_symmetric_gt(tiny):
    """Centre (64, 64): the P3 points at 60 and 68 on each axis lie at one
    distance, so the nine nearest include a tie the index order decides."""
    points = tiny["port"].points([torch.zeros(1, 1, 16, 24)])[0]
    d = torch.sqrt(((points - torch.tensor([64.0, 64.0])) ** 2).sum(-1))
    ninth = d.sort(stable=True).values[8]
    assert int((d == ninth).sum()) > 1 and int((d < ninth).sum()) < 9


def test_ground_truth_matches_jax(tiny):
    """Top-9 per level, mean + std threshold, in-box gate and argmax IoU:
    labels and targets exactly."""
    labels = check_assignment(tiny["port"], tiny["batch"], jax_assignment(tiny["jmodel"], tiny["head"],
                                                                          tiny["batch"]))
    assert int(labels[0].gt(0).sum()) > 0


def test_losses_match_jax(tiny):
    assert tiny["iou_calls"] == 1  # the gts against the shared pseudo-anchors, once a step
    check_losses(tiny["losses"], tiny["jlosses"], {"total_loss", "cls_loss", "reg_loss", "ctr_loss"})


def test_gradients_match_jax(tiny):
    check_gradients(tiny["grads"], tiny["jgrads"], tiny["no_grad"])


def test_inference_matches_jax(tiny):
    check_detections(tiny["port"], tiny["jmodel"], tiny["variables"], tiny["batch"])
