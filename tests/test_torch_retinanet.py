"""The port's RetinaNet (basedet_tpu_torch) against the JAX package on the CPU:
the sigmoid focal loss elementwise, the FPN with its ``p6p7`` top block, the
head in both ``share_param`` forms, and tiny RetinaNet (``tests/tiny.shrink``:
resnet10, FPN width 64, two anchors per location, one conv per subnet, batch
2 of 128x192): per-level head outputs in the anchor order, the anchors'
ground truth, the losses, their gradients and the detections, on weights
carried across by ``utils/weights.py``.

Inputs come from numpy with fixed seeds. Tolerances, and why:
  * one layer (the FPN, the head) and the per-level head outputs of the
    tiny model to 1e-5 of each tensor's largest entry: both sides compute
    the same f32 operations and sum each convolution in their own order;
  * the focal loss elementwise to 1e-6 relative (``sigmoid``, ``exp`` and
    ``log1p`` of XLA and of PyTorch may differ by an ulp);
  * the ground truth: labels exactly, offsets to 1e-5 absolute (``log`` of
    the two libraries);
  * the losses to 1e-5 relative: sums over ~160,000 focal terms, taken in
    another order;
  * each gradient to 1e-3 of its tensor's largest entry, the bound of
    tests/test_torch_yolox_train.py, whose docstring measures XLA:CPU's own
    f32 rounding at 4.9e-4 of a tensor's largest magnitude against float64;
  * detections: at least 95% matched one to one (label, IoU >= 0.999,
    |dscore| <= 1e-4) and the matched boxes within 1e-3 absolute (pixels):
    a score that the two sides round differently can reorder near-ties in
    the top-1000 and in NMS.
Frozen parameters (the stem and layer1) get no gradient in the port and a
zero one in the JAX package.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch.layers.backbone.fpn import FPN
from basedet_tpu_torch.layers.head.retina_head import RetinaNetHead
from basedet_tpu_torch.layers.losses import sigmoid_focal_loss
from basedet_tpu_torch.ops.iou_kernel import box_iou_plain
from basedet_tpu_torch.utils.compare import match_detections
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_yolox_train import flat
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

IMG = (128, 192)
MAX_INST = 6
LAYER_RTOL = 1e-5
GRAD_RTOL = 1e-3
LOSSES = {"total_loss", "cls_loss", "reg_loss"}
FROZEN = ("bottom_up/conv1/", "bottom_up/layer1_")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


def randomise(variables, rng):
    """Frozen BN statistics and affine and every bias drawn from rng; the
    class logits' biases (at the prior, -4.6) spread by 2, so that some
    (anchor, class) scores clear the 0.05 threshold and NMS has work."""
    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "mean":
                v = rng.normal(0.0, 0.2, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 2.0, v.shape)
            elif k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias":
                v = v + rng.normal(0.0, 2.0 if path[-1].startswith("cls_score") else 0.3, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.device_get(variables), ())


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2), (-1, 0), (0.5, 1.5)])
def test_sigmoid_focal_loss_matches_jax(alpha, gamma):
    from basedet_tpu.layers.losses import sigmoid_focal_loss as jfocal

    rng = np.random.RandomState(3)
    logits = rng.normal(0.0, 4.0, (3, 50, 7)).astype(np.float32)
    targets = (rng.uniform(size=logits.shape) < 0.2).astype(np.float32)
    want = np.asarray(jfocal(jnp.asarray(logits), jnp.asarray(targets), alpha=alpha, gamma=gamma))
    got = sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets), alpha=alpha,
                             gamma=gamma).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_fpn_p6p7_matches_jax():
    """res3-res5 of an 800x1344 input (100x168, 50x84, 25x42) at narrow
    widths: P3-P5, then P6 13x21 and P7 7x11 from res5."""
    from basedet_tpu.layers.backbone.fpn import FPN as JFPN

    rng = np.random.RandomState(0)
    names, chans = ("res3", "res4", "res5"), (8, 16, 32)
    sizes = ((100, 168), (50, 84), (25, 42))
    bottom_up = {n: rng.randn(1, h, w, c).astype(np.float32) for n, c, (h, w) in zip(names, chans, sizes)}
    jmod = JFPN(in_features=names, strides=(8, 16, 32), out_channels=16, top_block="p6p7",
                top_block_in_feature="res5")
    jin = {k: jnp.asarray(v) for k, v in bottom_up.items()}
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(0), jin))
    variables = jax.tree_util.tree_map(lambda v: v + rng.normal(0.0, 0.1, v.shape).astype(np.float32),
                                       variables)
    want = jax.device_get(jmod.apply(variables, jin))
    port = FPN(names, chans, (8, 16, 32), 16, top_block="p6p7", top_block_in_feature="res5")
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    assert {"fpn_p6.weight", "fpn_p7.bias"} <= set(port.state_dict())
    with torch.no_grad():
        got = port({k: nchw(v) for k, v in bottom_up.items()})
    assert set(got) == set(want) == {"p3", "p4", "p5", "p6", "p7"}
    assert got["p6"].shape[-2:] == (13, 21) and got["p7"].shape[-2:] == (7, 11)
    for k in want:
        assert_rel(nhwc(got[k]), want[k], LAYER_RTOL, k)


def test_fpn_p6_top_block_keeps_its_keys():
    """Faster R-CNN's ``p6`` top block has no parameters: its state_dict keys
    do not change."""
    fpn = FPN(("res2", "res3"), (8, 16), (4, 8), 16)
    assert sorted(fpn.state_dict()) == sorted(
        f"fpn_{kind}_{n}.{leaf}" for kind in ("lateral", "output") for n in ("res2", "res3")
        for leaf in ("weight", "bias"))
    out = fpn({"res2": torch.zeros(1, 8, 8, 12), "res3": torch.zeros(1, 16, 4, 6)})
    assert set(out) == {"p2", "p3", "p4"} and out["p4"].shape[-2:] == (2, 3)


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per-level"])
def test_head_matches_jax(share):
    from basedet_tpu.layers.head.retina_head import RetinaNetHead as JHead

    rng = np.random.RandomState(1)
    feats = [rng.randn(2, h, w, 8).astype(np.float32) for h, w in ((8, 12), (4, 6), (2, 3))]
    jmod = JHead(num_anchors=3, num_classes=5, num_levels=3, num_convs=2, share_param=share)
    jin = [jnp.asarray(f) for f in feats]
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(2), jin))
    variables = jax.tree_util.tree_map(lambda v: v + rng.normal(0.0, 0.1, v.shape).astype(np.float32),
                                       variables)
    want_logits, want_offsets = jax.device_get(jmod.apply(variables, jin))
    port = RetinaNetHead(8, 3, 5, num_levels=3, num_convs=2, share_param=share)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    names = {k.rsplit(".", 1)[0] for k in port.state_dict()}
    assert ("cls_subnet_1" in names) == share and ("bbox_pred_l2" in names) == (not share)
    assert len(names) == (2 * 2 + 2) * (1 if share else 3)
    with torch.no_grad():
        logits, offsets = port([nchw(f) for f in feats])
    for lv in range(3):
        assert_rel(nhwc(logits[lv]), want_logits[lv], LAYER_RTOL, f"logits {lv}")
        assert_rel(nhwc(offsets[lv]), want_offsets[lv], LAYER_RTOL, f"offsets {lv}")


def test_head_init_draws_the_prior_bias():
    head = RetinaNetHead(16, 9, 80, num_convs=2)
    head.init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(head.cls_score.bias.detach().numpy(), -np.log(99.0), rtol=1e-6)
    assert float(head.bbox_pred.bias.detach().abs().max()) == 0.0
    assert 0.008 < float(head.cls_subnet_0.weight.detach().std()) < 0.012


def tiny_cfg():
    cfg = shrink(C.RetinaNetConfig())
    cfg.DATA.MAX_INSTANCES = MAX_INST
    cfg.MODEL.BATCHSIZE = 2
    return cfg


def make_batch():
    batch = DummyLoader(batch_size=2, image_size=IMG, max_instances=MAX_INST).make_batch()
    batch["im_info"][1, 4] = 2
    batch["gt_boxes"][1, 2:] = 0.0
    return batch


def port_with(variables, cfg):
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    return port


@pytest.fixture(scope="module")
def tiny():
    """One batch through both models from the same weights: the JAX eval-mode
    head outputs, ground truth, losses and gradients (one compiled program)
    and detections; the port's the same."""
    all_register()
    cfg = tiny_cfg()
    jmodel = cfg.build_model()
    variables = randomise(jmodel.init_variables(jax.random.PRNGKey(0), image_size=IMG),
                          np.random.RandomState(0))
    batch = make_batch()
    port = port_with(variables, cfg)

    image = jmodel.pre_process(batch, train=False)["image"]
    jlogits, joffsets = jax.device_get(jax.jit(jmodel.make_module(train=False).apply)(variables, image))
    janchors = np.concatenate(jmodel.anchor_gen([x.shape[1:3] for x in jlogits]), axis=0)
    jgt = jax.device_get(jax.jit(jax.vmap(functools.partial(jmodel._assign_single, janchors)))(
        jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["im_info"][:, 4].astype(np.int32))))

    def loss_fn(params):
        total, losses, _ = jmodel.get_losses({**variables, "params": params}, batch)
        return total, losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    jdets = jax.device_get(jmodel.inference_jit(variables, batch))

    port.train()
    port.module.zero_grad(set_to_none=True)
    calls = box_iou_plain.calls
    total, losses = port.get_losses(batch)
    total.backward()
    named = dict(port.module.named_parameters())
    grads = jax_from_state_dict({n: p.grad for n, p in named.items() if p.grad is not None})
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, batch=batch, jlogits=jlogits,
                joffsets=joffsets, janchors=janchors, jgt=jgt, jlosses=jax.device_get(jlosses),
                jgrads=flat(jax.device_get(jgrads)), jdets=jdets, iou_calls=box_iou_plain.calls - calls,
                losses={k: float(v.detach()) for k, v in losses.items()}, grads=flat(grads["params"]),
                no_grad={n for n, p in named.items() if p.grad is None})


def test_head_outputs_match_jax_per_level(tiny):
    port = port_with(tiny["variables"], tiny["cfg"])
    with torch.no_grad():
        logits_l, offsets_l = port.module(port.pre_process(tiny["batch"])["image"])
        flat_logits, flat_offsets = port.flatten(logits_l, offsets_l)
    assert len(logits_l) == 5
    A, Cn = port.anchor_gen.num_anchors, port.num_classes
    for lv, (lg, of, jl, jo) in enumerate(zip(logits_l, offsets_l, tiny["jlogits"], tiny["joffsets"])):
        assert_rel(nhwc(lg), jl, LAYER_RTOL, f"logits p{lv + 3}")
        assert_rel(nhwc(of), jo, LAYER_RTOL, f"offsets p{lv + 3}")
        # the flatten is the JAX package's reshape of NHWC: anchor-minor within each cell
        n, h, w, _ = jl.shape
        assert_rel(flat_logits[lv].numpy(), jl.reshape(n, h * w * A, Cn), LAYER_RTOL, f"flat logits {lv}")
        assert_rel(flat_offsets[lv].numpy(), jo.reshape(n, h * w * A, 4), LAYER_RTOL, f"flat offsets {lv}")


def test_retinanet_module_runs_f32_whatever_the_process_set(tiny):
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    port = port_with(tiny["variables"], tiny["cfg"])
    seen = []
    hook = port.module.head.register_forward_pre_hook(lambda *_: seen.append(flags()))
    saved = flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            port.module(port.pre_process(tiny["batch"])["image"])
        after = flags()
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [(False, False)] and after == (True, True)


def test_ground_truth_matches_jax(tiny):
    """The same anchors; labels equal exactly (foreground, ignored,
    background and low-quality matches all live), offsets to 1e-5."""
    port = port_with(tiny["variables"], tiny["cfg"])
    x = port.pre_process(tiny["batch"], train=True)
    with torch.no_grad():
        logits_l, _ = port.module(x["image"])
    anchors = torch.cat(port.anchors(logits_l), dim=0)
    np.testing.assert_array_equal(anchors.numpy(), tiny["janchors"])
    calls = box_iou_plain.calls
    labels, offsets = port.ground_truth(anchors, x["gt_boxes"], x["img_info"][:, 4].long())
    assert box_iou_plain.calls == calls + 1
    jlabels, joffsets = tiny["jgt"]
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    np.testing.assert_allclose(offsets.numpy(), joffsets, rtol=0, atol=1e-5)
    ious = box_iou_plain(x["gt_boxes"][..., :4], anchors)
    valid = torch.arange(MAX_INST)[None, :] < x["img_info"][:, 4:5].long()
    best = torch.where(valid[..., None], ious, -1.0).amax(1)
    fg = labels > 0
    assert fg.sum() > 0 and (labels == -1).sum() > 0 and (labels == 0).sum() > 0
    assert (fg & (best < 0.5)).sum() > 0  # low-quality matches
    assert set(labels[fg].unique().tolist()) <= set(range(1, 81))


def test_losses_match_jax(tiny):
    assert tiny["iou_calls"] == 1  # one IoU per train step, all images at once
    assert set(tiny["losses"]) == LOSSES == set(tiny["jlosses"])
    for k, v in tiny["losses"].items():
        ref = float(tiny["jlosses"][k])
        assert ref > 0, k
        assert abs(v - ref) <= 1e-5 * abs(ref), (k, v, ref)


def test_gradients_match_jax(tiny):
    frozen = {k for k in tiny["jgrads"] if k.startswith(FROZEN)}
    assert frozen and set(tiny["grads"]) == set(tiny["jgrads"]) - frozen
    for k in frozen:  # cut by stop_gradient there, by requires_grad here
        assert np.abs(tiny["jgrads"][k]).max() == 0, k
    assert tiny["no_grad"] == {"bottom_up.conv1.weight", "bottom_up.layer1_0.conv1.weight",
                               "bottom_up.layer1_0.conv2.weight"}
    for k, got in tiny["grads"].items():
        assert_rel(got, tiny["jgrads"][k], GRAD_RTOL, k)


def test_inference_matches_jax(tiny):
    port = port_with(tiny["variables"], tiny["cfg"])
    want = tiny["jdets"]
    got = {k: v.numpy() for k, v in port.inference(tiny["batch"]).items()}
    assert want["valid"].sum() > 0 and got["valid"].sum() > 0
    assert match_detections(want, got) >= 0.95
    # the matched slots: the same label and score rank, boxes to 1e-3
    same = want["valid"] & got["valid"] & (want["box_labels"] == got["box_labels"])
    assert same.sum() >= 0.95 * want["valid"].sum()
    np.testing.assert_allclose(got["boxes"][same], want["boxes"][same], rtol=0, atol=1e-3)


def test_retinanet_trains_under_amp():
    """``--amp`` (``TRAINER.AMP.ENABLE``) on tiny RetinaNet: one train step
    under the bf16 policy with finite losses and f32 parameters, the IoU
    through the wrapper once (``tests/test_torch_amp_families.py`` holds the
    losses to the JAX package's)."""
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.layers import precision
    from basedet_tpu_torch.solver import DetSolver

    cfg = tiny_cfg()
    cfg.merge(["TRAINER.AMP.ENABLE", "True"])
    port = build_model(cfg, "cpu").train()
    solver = DetSolver.build(cfg)
    calls = box_iou_plain.calls
    metrics = make_train_step(port, solver, cfg)(TrainState(port, solver), make_batch())
    assert box_iou_plain.calls - calls == 1
    assert set(metrics) == LOSSES | {"lr"} and all(np.isfinite(float(v)) for v in metrics.values())
    assert precision.compute_dtype() is None
    assert all(p.dtype == torch.float32 for p in port.module.parameters())
