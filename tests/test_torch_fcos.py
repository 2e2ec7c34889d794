"""The port's FCOS (basedet_tpu_torch) against the JAX package on the CPU: the
anchor points, ``extract_topk_mask`` on rows with ties, ``iou_loss`` in ltrb
and the elementwise GIoU of the other modes (values and gradients), the
point head in both ``share_param`` forms and both decode modes, its weights
carried across by ``utils/weights.py`` (GroupNorm and ``scales``), and tiny
FCOS (``tests/tiny.shrink`` on both packages' configs: resnet10, FPN width
64, one conv per subnet, batch 2 of 128x192): per-level head outputs, the
points' ground truth, the losses, their gradients and the detections.

Inputs come from numpy with fixed seeds, f32 with TF32 off. Tolerances, and
why:
  * anchor points, ``extract_topk_mask`` and the assignment (labels and
    ltrb targets) exactly: the same f32 operations on the same inputs, ties
    broken to the lower index on both sides; the target centerness,
    sqrt(min/max · min/max), to 2 ulps (measured: 2 of 1024 entries differ
    by 1 ulp, XLA:CPU's division or square root against PyTorch's);
  * the point head per level to 1e-5 of each tensor's largest entry (both
    sides sum each convolution in their own order; GroupNorm takes flax's
    epsilon, 1e-6);
  * ``iou_loss`` elementwise to 1e-6 relative, its gradient to 1e-5
    relative of the largest entry (``log`` of XLA and of PyTorch may differ
    by an ulp);
  * the losses to 1e-4 relative (sums over ~40,000 focal terms in another
    order) and each gradient to 1e-3 of its tensor's largest entry, the
    bound of tests/test_torch_retinanet.py;
  * detections: at least 95% matched one to one (label, IoU >= 0.999,
    |dscore| <= 1e-4), matched boxes within 1e-3 pixels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch import configs as P
from basedet_tpu_torch.layers.common.anchor_generator import AnchorPointGenerator
from basedet_tpu_torch.layers.common.function import extract_topk_mask
from basedet_tpu_torch.layers.head.point_head import PointHead
from basedet_tpu_torch.layers.losses import iou_loss
from basedet_tpu_torch.utils.compare import match_detections
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_retinanet import assert_rel, nchw, nhwc
from tests.test_torch_yolox_train import flat
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

IMG = (128, 192)
MAX_INST = 6
LAYER_RTOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
FROZEN = ("bottom_up/conv1/", "bottom_up/layer1_")


def test_anchor_points_match_jax():
    from basedet_tpu.layers.common.anchor_generator import AnchorPointGenerator as J

    sizes = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
    for offset in (0.5, 0.0):
        want = J(strides=(8, 16, 32, 64, 128), offset=offset)(sizes)
        got = AnchorPointGenerator((8, 16, 32, 64, 128), offset)(sizes, "cpu")
        assert sum(g.shape[0] for g in got) == 22400
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 3, 9])
def test_extract_topk_mask_matches_jax_with_ties(k):
    """Rows of few distinct values, so ties cross the k-th place: the same
    values and the same members, the lowest index first."""
    from basedet_tpu.layers.common.function import extract_topk_mask as jmask

    rng = np.random.RandomState(k)
    values = rng.randint(0, 4, (7, 40)).astype(np.float32)
    values[3] = 1.0  # one row all ties
    want_top, want_mask = jmask(jnp.asarray(values), k)
    top, mask = extract_topk_mask(torch.from_numpy(values), k)
    np.testing.assert_array_equal(top.numpy(), np.asarray(want_top))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert mask[3].nonzero()[:, 0].tolist() == list(range(k))


def _ltrb_pairs(rng, n):
    pred = rng.uniform(0.0, 40.0, (n, 4)).astype(np.float32)
    target = rng.uniform(0.0, 40.0, (n, 4)).astype(np.float32)
    pred[:5] = 0.0  # relu zeros: a degenerate prediction
    target[5:8] = pred[5:8]  # exact matches
    return pred, target


@pytest.mark.parametrize("box_mode,loss_type", [("ltrb", "iou"), ("ltrb", "giou"), ("ltrb", "linear_iou"),
                                                ("xyxy", "giou"), ("xcycwh", "giou"), ("xywh", "square_iou")])
def test_iou_loss_matches_jax(box_mode, loss_type):
    from basedet_tpu.layers.losses import iou_loss as jloss

    rng = np.random.RandomState(2)
    pred, target = _ltrb_pairs(rng, 64)
    if box_mode != "ltrb":
        pred[:, 2:] += 45.0
        target[:, 2:] += 45.0
    jfn = lambda p: jnp.sum(jloss(p, jnp.asarray(target), box_mode=box_mode, loss_type=loss_type) * jnp.arange(64))
    want_loss, want_iou = jloss(jnp.asarray(pred), jnp.asarray(target), box_mode=box_mode, loss_type=loss_type,
                                return_iou=True)
    want_grad = np.asarray(jax.grad(jfn)(jnp.asarray(pred)))
    p = torch.from_numpy(pred).requires_grad_(True)
    loss, ious = iou_loss(p, torch.from_numpy(target), box_mode=box_mode, loss_type=loss_type, return_iou=True)
    (loss * torch.arange(64)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_loss), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ious.detach().numpy(), np.asarray(want_iou), rtol=1e-6, atol=1e-7)
    assert_rel(p.grad.numpy(), want_grad, 1e-5, "grad")


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per-level"])
@pytest.mark.parametrize("decode", ["relu_scale", "exp_scale"])
def test_point_head_matches_jax(share, decode):
    from basedet_tpu.layers.head.point_head import PointHead as JHead

    rng = np.random.RandomState(1)
    strides = (8, 16, 32)
    feats = [rng.randn(2, h, w, 64).astype(np.float32) for h, w in ((8, 12), (4, 6), (2, 3))]
    jmod = JHead(num_classes=5, strides=strides, num_convs=2, share_param=share, decode_mode=decode)
    jin = [jnp.asarray(f) for f in feats]
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(2), jin))
    variables = jax.tree_util.tree_map(lambda v: v + rng.normal(0.0, 0.1, v.shape).astype(np.float32),
                                       variables)
    want = jax.device_get(jmod.apply(variables, jin))
    port = PointHead(64, 5, strides, num_convs=2, share_param=share, decode_mode=decode)
    sd = state_dict_from_jax(variables, port.state_dict())
    port.load_state_dict(sd)
    names = {k.rsplit(".", 1)[0] for k in sd if "." in k}
    assert ("cls_gn_1" in names) == share and ("bbox_gn_l2_1" in names) == (not share)
    assert "scales" in sd and tuple(sd["scales"].shape) == (3,)
    back = flat(jax_from_state_dict(port.state_dict()))
    assert set(back) == set(flat(variables))
    for k, v in flat(variables).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with torch.no_grad():
        got = port([nchw(f) for f in feats])
    for name, g, w in zip(("logits", "offsets", "ctrness"), got, want):
        for lv in range(3):
            assert_rel(nhwc(g[lv]), w[lv], LAYER_RTOL, f"{name} {lv}")


def test_point_head_init():
    head = PointHead(64, 80, num_convs=2, prior_prob=0.01)
    head.init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(head.cls_score.bias.detach().numpy(), -np.log(99.0), rtol=1e-6)
    assert float(head.ctrness.bias.detach().abs().max()) == 0.0
    assert float(head.bbox_pred.bias.detach().abs().max()) == 0.0
    assert torch.equal(head.scales.detach(), torch.ones(5))
    assert torch.equal(head.cls_gn_0.weight.detach(), torch.ones(64)) and head.cls_gn_0.eps == 1e-6
    assert 0.008 < float(head.bbox_subnet_1.weight.detach().std()) < 0.012


# -- tiny models: the JAX package and the port on the same weights -------------------------------

def randomise(variables, rng):
    """Frozen BN statistics and affine, GroupNorm affine, every bias and the
    per-level ``scales`` drawn from rng; the class biases (at the prior,
    -4.6) spread by 2, so some scores clear the threshold and NMS works."""
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
            elif k in ("scale", "scales"):
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias":
                v = v + rng.normal(0.0, 2.0 if path[-1].startswith("cls_score") else 0.3, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.device_get(variables), ())


def tiny_cfgs(name):
    """(the JAX package's config, the port's), both shrunk alike."""
    out = []
    for cfg in (getattr(C, name)(), getattr(P, name)()):
        shrink(cfg)
        cfg.DATA.MAX_INSTANCES = MAX_INST
        cfg.MODEL.BATCHSIZE = 2
        out.append(cfg)
    return out


def make_batch():
    batch = DummyLoader(batch_size=2, image_size=IMG, max_instances=MAX_INST).make_batch()
    batch["im_info"][1, 4] = 2
    batch["gt_boxes"][1, 2:] = 0.0
    return batch


def port_with(variables, cfg):
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    return port


def jax_losses_and_grads(jmodel, variables, batch):
    """The JAX package's losses and gradients, from one compiled program per
    model that takes the batch as an argument (another batch of the same
    shapes reuses it)."""
    fn = getattr(jmodel, "_losses_and_grads", None)
    if fn is None:
        def loss_fn(params, others, batch):
            total, losses, _ = jmodel.get_losses({**others, "params": params}, batch)
            return total, losses

        fn = jmodel._losses_and_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    others = {k: v for k, v in variables.items() if k != "params"}
    (_, losses), grads = fn(variables["params"], others, batch)
    return jax.device_get(losses), flat(jax.device_get(grads))


def port_losses_and_grads(port, batch):
    port.train()
    port.module.zero_grad(set_to_none=True)
    total, losses = port.get_losses(batch)
    total.backward()
    named = dict(port.module.named_parameters())
    grads = jax_from_state_dict({n: p.grad for n, p in named.items() if p.grad is not None})
    port.eval()
    return ({k: float(v.detach()) for k, v in losses.items()}, flat(grads["params"]),
            {n for n, p in named.items() if p.grad is None})


def both_models(name, seed=0):
    """The JAX model, its randomised variables, the port on them, the batch
    and the JAX eval-mode head outputs (NHWC)."""
    all_register()
    jcfg, pcfg = tiny_cfgs(name)
    jmodel = jcfg.build_model()
    variables = randomise(jmodel.init_variables(jax.random.PRNGKey(seed), image_size=IMG),
                          np.random.RandomState(seed))
    batch = make_batch()
    image = jmodel.pre_process(batch, train=False)["image"]
    head = jax.device_get(jax.jit(jmodel.make_module(train=False).apply)(variables, image))
    return jmodel, variables, port_with(variables, pcfg), batch, head


def check_losses(got, want, names):
    assert set(got) == set(names) == set(want)
    for k, v in got.items():
        ref = float(want[k])
        assert ref > 0, k
        assert abs(v - ref) <= LOSS_RTOL * abs(ref), (k, v, ref)


def check_gradients(grads, jgrads, no_grad, head_keys=("head/scales", "head/cls_gn_0/scale", "head/bbox_gn_0/bias")):
    frozen = {k for k in jgrads if k.startswith(FROZEN)}
    assert frozen and set(grads) == set(jgrads) - frozen
    for k in frozen:  # cut by stop_gradient there, by requires_grad here
        assert np.abs(jgrads[k]).max() == 0, k
    assert no_grad == {"bottom_up.conv1.weight", "bottom_up.layer1_0.conv1.weight",
                       "bottom_up.layer1_0.conv2.weight"}
    assert set(head_keys) <= set(grads)
    for k, got in grads.items():
        assert_rel(got, jgrads[k], GRAD_RTOL, k)


def check_head(port, batch, head):
    with torch.no_grad():
        got = port.module(port.pre_process(batch)["image"])
    assert [len(x) for x in got] == [5, 5, 5]
    for name, g, w in zip(("logits", "offsets", "ctrness"), got, head):
        for lv in range(5):
            assert_rel(nhwc(g[lv]), w[lv], LAYER_RTOL, f"{name} p{lv + 3}")


def check_detections(port, jmodel, variables, batch):
    want = jax.device_get(jmodel.inference_jit(variables, batch))
    got = {k: v.numpy() for k, v in port.inference(batch).items()}
    assert want["valid"].sum() > 0 and got["valid"].sum() > 0
    assert match_detections(want, got) >= 0.95
    same = want["valid"] & got["valid"] & (want["box_labels"] == got["box_labels"])
    assert same.sum() >= 0.95 * want["valid"].sum()
    np.testing.assert_allclose(got["boxes"][same], want["boxes"][same], rtol=0, atol=1e-3)


def jax_assignment(jmodel, head, batch):
    """The JAX package's ``_assign_batch`` on the padded batch: (labels,
    offsets, centerness)."""
    feat_sizes = [tuple(x.shape[1:3]) for x in head[0]]
    return jax.device_get(jax.jit(lambda g, n: jmodel._assign_batch(feat_sizes, g, n))(
        jnp.asarray(batch["gt_boxes"]), jnp.asarray(batch["im_info"][:, 4].astype(np.int32))))


def check_assignment(port, batch, jgt):
    x = port.pre_process(batch, train=True)
    points_l = port.points([torch.zeros(1, 1, *s) for s in ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))])
    labels, offsets, ctr = port.ground_truth(points_l, x["gt_boxes"], x["img_info"][:, 4].long())
    jlabels, joffsets, jctr = jgt
    np.testing.assert_array_equal(labels.numpy(), jlabels)
    np.testing.assert_array_equal(offsets.numpy(), joffsets)
    np.testing.assert_allclose(ctr.numpy(), jctr, rtol=2 * 2.0 ** -23, atol=0)
    fg = labels > 0
    assert fg.sum() > 0 and (~fg).sum() > 0
    return labels


@pytest.fixture(scope="module")
def tiny():
    jmodel, variables, port, batch, head = both_models("FCOSConfig")
    jlosses, jgrads = jax_losses_and_grads(jmodel, variables, batch)
    losses, grads, no_grad = port_losses_and_grads(port, batch)
    return dict(jmodel=jmodel, variables=variables, port=port, batch=batch, head=head, jlosses=jlosses,
                jgrads=jgrads, losses=losses, grads=grads, no_grad=no_grad)


def test_head_outputs_match_jax_per_level(tiny):
    check_head(tiny["port"], tiny["batch"], tiny["head"])


def test_ground_truth_matches_jax(tiny):
    """Sizes of interest, centre sampling and the least-area gt."""
    labels = check_assignment(tiny["port"], tiny["batch"], jax_assignment(tiny["jmodel"], tiny["head"],
                                                                          tiny["batch"]))
    assert set(labels[labels > 0].unique().tolist()) <= set(range(1, 81))


def test_losses_match_jax(tiny):
    check_losses(tiny["losses"], tiny["jlosses"], {"total_loss", "cls_loss", "reg_loss", "ctr_loss"})


def test_gradients_match_jax(tiny):
    check_gradients(tiny["grads"], tiny["jgrads"], tiny["no_grad"])


def test_inference_matches_jax(tiny):
    check_detections(tiny["port"], tiny["jmodel"], tiny["variables"], tiny["batch"])


def test_fcos_trains_under_amp():
    """``--amp`` (``TRAINER.AMP.ENABLE``) on tiny FCOS: one train step under the
    bf16 policy with finite losses and f32 parameters
    (``tests/test_torch_amp_families.py`` holds it to the JAX package's)."""
    from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
    from basedet_tpu_torch.layers import precision
    from basedet_tpu_torch.solver import DetSolver

    cfg = tiny_cfgs("FCOSConfig")[1]
    cfg.merge(["TRAINER.AMP.ENABLE", "True"])
    port = build_model(cfg, "cpu").train()
    solver = DetSolver.build(cfg)
    metrics = make_train_step(port, solver, cfg)(TrainState(port, solver), make_batch())
    assert all(np.isfinite(float(v)) for v in metrics.values()) and metrics["total_loss"] > 0
    assert precision.compute_dtype() is None
    assert all(p.dtype == torch.float32 for p in port.module.parameters())
