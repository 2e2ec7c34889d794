"""The port's OTA against the JAX package on the CPU, tiny (as
tests/test_torch_fcos.py shrinks it), on the same weights: the closed-form
focal cost against the explicit per-class sum (as
tests/models/test_cost_formulas.py checks the JAX package's), the Sinkhorn
plan's marginals and assignment (as tests/layers/test_matchers.py), the
assignment of both ``MATCHING`` values on the JAX package's own head
outputs, and the losses and gradients of the default ``"topk"``, whose
dynamic-k matching goes once per ``get_losses`` through
``ops/matching_kernel.py::dynamic_k_matching`` (its plain version here).

Tolerances: the assignment (labels, ltrb targets) exactly and the matched
IoUs to 1 ulp; the closed-form cost to 1e-4 relative of the explicit sum,
as the JAX test holds its own (80 focal terms of ~1 summed in another
order, then the matched class's two terms taken out again: measured
2.1e-5); the Sinkhorn plan to 1e-5 of its largest entry against the JAX package's (50 log-sum-exp iterations, each
side's exp and log), its marginals to 1e-2 (as the JAX test); the losses to
1e-4 relative and each gradient to 1e-3 of its tensor's largest entry.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu_torch.layers.common.matcher import SinkhornMatcher, sinkhorn_log
from basedet_tpu_torch.layers.losses import iou_loss, sigmoid_focal_loss
from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching_plain
from tests.test_torch_fcos import (both_models, check_gradients, check_losses, jax_losses_and_grads,
                                   port_losses_and_grads, tiny_cfgs)
from tests.torch_threads import torch_threads  # noqa: F401

LEVELS = ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))


@pytest.fixture(scope="module")
def tiny():
    jmodel, variables, port, batch, head = both_models("OTAConfig", seed=2)
    jlosses, jgrads = jax_losses_and_grads(jmodel, variables, batch)
    calls = dynamic_k_matching_plain.calls
    losses, grads, no_grad = port_losses_and_grads(port, batch)
    return dict(jmodel=jmodel, variables=variables, port=port, batch=batch, head=head, jlosses=jlosses,
                jgrads=jgrads, losses=losses, grads=grads, no_grad=no_grad,
                match_calls=dynamic_k_matching_plain.calls - calls)


def _flat_head(jmodel, head):
    from basedet_tpu.models.det.retinanet import _flatten_level

    logits = jnp.concatenate([_flatten_level(x, jmodel.num_classes) for x in head[0]], axis=1)
    offsets = jnp.concatenate([_flatten_level(x, 4) for x in head[1]], axis=1)
    return logits, offsets


def _assign_both(tiny, matching):
    """The JAX package's vmapped ``_ota_assign_single`` and the port's
    ``ground_truth`` on the JAX package's own head outputs."""
    jmodel, port, batch = tiny["jmodel"], tiny["port"], tiny["batch"]
    logits, offsets = _flat_head(jmodel, tiny["head"])
    points_list = jmodel.point_gen(LEVELS)
    points = jnp.concatenate(points_list, axis=0)
    strides = jnp.asarray(np.concatenate([np.full((p.shape[0],), s, np.float32)
                                          for p, s in zip(points_list, jmodel.strides)]))
    jmodel.matching = port.matching = matching
    try:
        want = jax.device_get(jax.jit(jax.vmap(functools.partial(jmodel._ota_assign_single, points, strides)))(
            jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["im_info"][:, 4].astype(np.int32)), offsets, logits))
        x = port.pre_process(batch, train=True)
        points_l = port.points([torch.zeros(1, 1, *s) for s in LEVELS])
        got = port.ground_truth(points_l, x["gt_boxes"], x["img_info"][:, 4].long(),
                                torch.from_numpy(np.array(offsets)), torch.from_numpy(np.array(logits)))
    finally:
        jmodel.matching = port.matching = "topk"
    return [g.numpy() for g in got], want


@pytest.mark.parametrize("matching", ["topk", "sinkhorn"])
def test_assignment_matches_jax(tiny, matching):
    (labels, deltas, ious), (jlabels, jdeltas, jious) = _assign_both(tiny, matching)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(deltas, jdeltas)
    np.testing.assert_allclose(ious, jious, rtol=2.0 ** -23, atol=0)
    fg = labels > 0
    assert fg.sum() > 0 and (ious[fg] > 0).all() and (ious[~fg] == 0).all()


def test_closed_form_cost_equals_the_explicit_focal_sum(tiny):
    """cost - 1.5 · IoU loss - penalties = Σ_c FL(logit_c, onehot_y_c)."""
    port = tiny["port"]
    rng = np.random.RandomState(3)
    B, K = 2, 4
    points_l = port.points([torch.zeros(1, 1, *s) for s in LEVELS])
    R = sum(p.shape[0] for p in points_l)
    logits = torch.from_numpy(rng.randn(B, R, port.num_classes).astype(np.float32) * 3)
    offsets = torch.from_numpy(rng.uniform(1.0, 60.0, (B, R, 4)).astype(np.float32))
    gt = torch.zeros(B, K, 5)
    gt[..., :2] = torch.from_numpy(rng.uniform(0, 80, (B, K, 2)).astype(np.float32))
    gt[..., 2:4] = gt[..., :2] + torch.from_numpy(rng.uniform(20, 90, (B, K, 2)).astype(np.float32))
    gt[..., 4] = torch.from_numpy(rng.randint(1, port.num_classes + 1, (B, K)).astype(np.float32))
    num = torch.tensor([4, 2])
    c = port.costs(points_l, gt, num, offsets, logits)
    loss_delta = iou_loss(offsets[:, None].expand(c["deltas"].shape), c["deltas"], box_mode="ltrb", loss_type="iou")
    focal = c["cost"] - port.reg_weight * loss_delta - 1e6 * (~c["both"]) - 1e9 * (~c["gt_valid"])[..., None]
    onehot = torch.nn.functional.one_hot(gt[..., 4].long() - 1, port.num_classes).float()  # (B, K, C)
    explicit = sigmoid_focal_loss(logits[:, None].expand(B, K, R, -1), onehot[:, :, None].expand(B, K, R, -1),
                                  alpha=0.25, gamma=2).sum(-1)
    keep = c["gt_valid"][..., None] & c["both"]
    assert keep.any()
    np.testing.assert_allclose(focal[keep].numpy(), explicit[keep].numpy(), rtol=1e-4)


def test_sinkhorn_matches_jax():
    """The plan (transport from K+1 supplies to M unit demands) and the
    assignment of the Sinkhorn matcher, on random costs, ious and a padded
    gt."""
    from basedet_tpu.layers.common.matcher import SinkhornMatcher as J
    from basedet_tpu.layers.common.matcher import sinkhorn_log as jlog

    rng = np.random.RandomState(0)
    mu = np.asarray([2.0, 1.0, 7.0], np.float32)
    cost = rng.rand(3, 10).astype(np.float32)
    plan = sinkhorn_log(torch.from_numpy(mu)[None], torch.ones(1, 10), torch.from_numpy(cost)[None], eps=0.05,
                        n_iters=200)[0].numpy()
    np.testing.assert_allclose(plan.sum(axis=1), mu, atol=1e-2)
    np.testing.assert_allclose(plan.sum(axis=0), np.ones(10), atol=1e-2)
    want = np.asarray(jlog(jnp.asarray(mu), jnp.ones((10,)), jnp.asarray(cost), eps=0.05, n_iters=200))
    np.testing.assert_allclose(plan, want, rtol=0, atol=1e-5 * want.max())

    B, K, M = 3, 5, 60
    cost = (rng.uniform(0, 5, (B, K, M)) + 1e6 * (rng.uniform(size=(B, K, M)) > 0.5)).astype(np.float32)
    bg = rng.uniform(0, 3, (B, M)).astype(np.float32)
    ious = (rng.uniform(size=(B, K, M)) ** 3).astype(np.float32)
    valid = np.arange(K)[None] < np.array([[5], [2], [0]])
    matched, fg = SinkhornMatcher()(*(torch.from_numpy(a) for a in (cost, bg, valid, ious)))
    for b in range(B):
        jm, jfg = J()(*(jnp.asarray(a[b]) for a in (cost, bg, valid, ious)))
        np.testing.assert_array_equal(matched[b].numpy(), np.asarray(jm), err_msg=str(b))
        np.testing.assert_array_equal(fg[b].numpy(), np.asarray(jfg), err_msg=str(b))
    assert fg[0].any() and not fg[2].any()


def test_losses_match_jax(tiny):
    assert tiny["match_calls"] == 1  # one dynamic-k matching over the batch per step
    check_losses(tiny["losses"], tiny["jlosses"], {"total_loss", "loss_cls", "loss_offsets", "loss_ious"})


def test_gradients_match_jax(tiny):
    check_gradients(tiny["grads"], tiny["jgrads"], tiny["no_grad"])


def test_norm_reg_targets_false_decodes_by_exp():
    from basedet_tpu_torch import build_model

    cfg = tiny_cfgs("OTAConfig")[1]
    assert build_model(cfg, "cpu").module.head.decode_mode == "relu_scale"
    cfg.MODEL.HEAD.NORM_REG_TARGETS = False
    assert build_model(cfg, "cpu").module.head.decode_mode == "exp_scale"
