"""The port's YOLOX training path (basedet_tpu_torch) against the JAX package on
the CPU: SimOTA assignment, the losses and their gradients, train-mode BN, the
multiscale schedule and resize.

Tiny YOLOX-S (depth 0.33, width 0.25, 128² images, MAX_INSTANCES 8, batch 2,
the second image with 2 of its 5 boxes valid). Weights come from the JAX
``init_variables`` tree, randomised as tests/test_torch_yolox.py does, through
``utils/weights.py``. Inputs come from numpy with a fixed seed.

Tolerances: the assignment is held exactly where both sides get the same
inputs. Through the whole network the two frameworks sum each convolution in
their own order, which moves f32 values by ulps per layer (tests/
test_torch_yolox.py holds the head outputs to 1e-4 absolute): the losses are
held to 1e-5 relative, and the BN running statistics to 1e-6 absolute for one
block; through the network, to 1e-5 absolute or 1e-4 relative, as the stem's
batch variances are ~180 and flax takes them as E[x²] - E[x]² in f32. Each gradient is held to 1e-3 of its own
largest magnitude: against the same gradients taken in float64 (the port's
model cast to double), the JAX package's f32 gradients on this batch are off
by up to 4.9e-4 of a tensor's largest magnitude and the port's by up to
9.3e-5, so a bound of 1e-4 between the two would measure XLA:CPU's rounding.
Tensors that get no gradient (the stride-32 class branch: no foreground
anchor on that level here) are exactly zero on both sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.layers.blocks.yolo_block import CSPLayer as JCSPLayer
from basedet_tpu.layers.blocks.yolo_block import _ConvBNAct as JConvBNAct
from basedet_tpu.models.det.retinanet import _flatten_level as jflatten
from basedet_tpu.utils import all_register
from basedet_tpu.utils.dummy import DummyLoader
from basedet_tpu_torch import build_model
from basedet_tpu_torch.layers.blocks.yolo_block import ConvBNAct, CSPLayer
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_yolox import _randomise
from tests.tiny import shrink

IMG = 128
MAX_INST = 8


def tiny_cfg():
    cfg = shrink(C.YOLOXSConfig())
    cfg.DATA.MAX_INSTANCES = MAX_INST
    cfg.MODEL.BATCHSIZE = 2
    return cfg


def make_pair(cfg, seed=0):
    """(JAX model, its randomised variables as numpy, the port's model with
    the same weights in train mode). The box-size biases rise by log 4, so
    predicted boxes span a few strides, dynamic k exceeds 1 and gts compete
    for anchors."""
    all_register()
    jmodel = cfg.build_model()
    variables = _randomise(
        jmodel.init_variables(jax.random.PRNGKey(seed), image_size=(IMG, IMG)),
        np.random.RandomState(seed),
    )
    for lv in range(3):
        variables["params"]["head"][f"reg_pred_{lv}"]["bias"][2:] += np.float32(np.log(4.0))
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    return jmodel, variables, port.train()


def make_batch(it=0, size=IMG):
    batch = DummyLoader(batch_size=2, image_size=(size, size), max_instances=MAX_INST,
                        num_instances=5).make_batch(it)
    batch["im_info"][1, 4] = 2
    batch["gt_boxes"][1, 2:] = 0.0
    return batch


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_cfg()
    cfg.MODEL.USE_L1 = True  # every loss term live
    jmodel, variables, port = make_pair(cfg)
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, port=port, batch=make_batch())


def _jax_assign_inputs(jmodel, variables, batch):
    """get_losses up to the assignment, as the JAX package writes it, then
    its vmapped ``_assign_single``."""
    inputs = jmodel.pre_process(batch, train=True)
    (logits_l, offsets_l, objs_l), _ = jmodel.make_module(train=True).apply(
        variables, inputs["image"], mutable=["batch_stats"])
    grids_l, strides_l = jmodel.point_gen([tuple(x.shape[1:3]) for x in logits_l])
    anchors, strides_vec = jnp.concatenate(grids_l), jnp.concatenate(strides_l)
    cls = jnp.concatenate([jflatten(x, jmodel.num_classes) for x in logits_l], axis=1)
    raw = jnp.concatenate([jflatten(x, 4) for x in offsets_l], axis=1)
    obj = jnp.concatenate([jflatten(x, 1) for x in objs_l], axis=1)
    xy = raw[..., :2] * strides_vec[None, :, None] + anchors[None]
    wh = jnp.exp(raw[..., 2:4]) * strides_vec[None, :, None]
    pred = jnp.concatenate([xy, wh], axis=-1)
    num_valid = inputs["img_info"][:, 4].astype(jnp.int32)
    outs = jax.vmap(functools.partial(jmodel._assign_single, anchors, strides_vec))(
        inputs["gt_boxes"], num_valid, pred, cls, obj)
    return (anchors, strides_vec, inputs["gt_boxes"], num_valid, pred, cls, obj), outs


def test_assign_matches_jax_exactly(pair):
    ins, (fg, matched, pred_iou) = jax.jit(functools.partial(_jax_assign_inputs, pair["jmodel"]))(
        pair["variables"], pair["batch"])
    t_ins = [torch.from_numpy(np.array(x)) for x in ins]
    got_fg, got_matched, got_iou = pair["port"].assign(*t_ins)
    fg = np.asarray(fg)
    assert fg.sum() >= 10 and fg[1].sum() > 0
    np.testing.assert_array_equal(got_fg.numpy(), fg)
    np.testing.assert_array_equal(got_matched.numpy()[fg], np.asarray(matched)[fg])
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(pred_iou), rtol=0, atol=1e-6)
    # more than one gt competes for some anchor in the first image
    assert len(np.unique(got_matched.numpy()[0][fg[0]])) >= 2


@pytest.fixture(scope="module")
def losses_and_grads(pair):
    jmodel, variables, port = pair["jmodel"], pair["variables"], pair["port"]

    def loss_fn(params, batch_stats, batch):
        total, loss_dict, new = jmodel.get_losses({"params": params, "batch_stats": batch_stats},
                                                  batch)
        return total, (loss_dict, new)

    (_, (jlosses, jstate)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], pair["batch"])
    port.module.zero_grad(set_to_none=True)
    total, losses = port.get_losses(pair["batch"])
    total.backward()
    grads = jax_from_state_dict({n: p.grad for n, p in port.module.named_parameters()})
    stats = jax_from_state_dict(port.module.state_dict())["batch_stats"]
    return dict(jlosses=jax.device_get(jlosses), jgrads=flat(jax.device_get(jgrads)),
                jstats=flat(jax.device_get(jstate["batch_stats"])),
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads=flat(grads["params"]), stats=flat(stats))


def test_losses_match_jax(losses_and_grads):
    r = losses_and_grads
    assert set(r["losses"]) == {"total_loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss"}
    for k, v in r["losses"].items():
        ref = float(r["jlosses"][k])
        assert ref > 0, k
        assert abs(v - ref) <= 1e-5 * abs(ref), (k, v, ref)


def test_gradients_match_jax(losses_and_grads):
    r = losses_and_grads
    assert r["grads"].keys() == r["jgrads"].keys()
    live = 0
    for k, ref in r["jgrads"].items():
        scale = np.abs(ref).max()
        err = np.abs(r["grads"][k] - ref).max()
        assert err <= 1e-3 * scale, (k, err, scale)
        live += scale > 0
    assert live >= 0.9 * len(r["jgrads"])


def test_bn_running_stats_match_jax_through_the_network(losses_and_grads):
    r = losses_and_grads
    assert r["stats"].keys() == r["jstats"].keys()
    for k, ref in r["jstats"].items():
        np.testing.assert_allclose(r["stats"][k], ref, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("block", ["conv_bn_act", "csp"])
def test_bn_train_mode_matches_flax(block):
    """One train-mode forward: output, and the new running mean and var (the
    biased batch variance, at momentum 0.97) against flax's batch_stats."""
    rng = np.random.RandomState(3)
    x = (rng.normal(0, 1, (2, 5, 5, 16)) * 2 + 0.5).astype(np.float32)
    if block == "conv_bn_act":
        jmod, port = JConvBNAct(8, 3, train=True), ConvBNAct(16, 8, 3)
    else:
        jmod, port = JCSPLayer(16, n=2, train=True), CSPLayer(16, 16, n=2)
    variables = _randomise(jax.jit(JConvBNAct(8, 3).init if block == "conv_bn_act"
                                   else JCSPLayer(16, n=2).init)(jax.random.PRNGKey(1), x), rng)
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    ref, new = jmod.apply(variables, x, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref), rtol=0, atol=1e-5)
    stats = flat(jax_from_state_dict(port.state_dict())["batch_stats"])
    jstats = flat(jax.device_get(new["batch_stats"]))
    assert stats.keys() == jstats.keys()
    for k, v in jstats.items():
        assert not np.allclose(v, flat(variables["batch_stats"])[k]), k  # the update moved it
        np.testing.assert_allclose(stats[k], v, rtol=0, atol=1e-6, err_msg=k)


def test_target_size_for_step_matches_jax(pair):
    jmodel, port = pair["jmodel"], pair["port"]
    sizes = [port.target_size_for_step(s) for s in range(1, 101)]
    assert sizes == [jmodel.target_size_for_step(s) for s in range(1, 101)]
    assert len(set(sizes)) > 3


@pytest.mark.parametrize("target", [96, 160], ids=["downscale", "upscale"])
def test_resize_batch_matches_jax(pair, target):
    batch = make_batch(2)
    ref = pair["jmodel"].resize_batch(batch, (target, target))
    got = pair["port"].resize_batch(batch, (target, target))
    # bilinear weights summed in another order: a few 1e-5 on 0..255 pixels
    np.testing.assert_allclose(got["data"].numpy(), np.asarray(ref["data"]), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got["gt_boxes"].numpy(), np.asarray(ref["gt_boxes"]))
    np.testing.assert_array_equal(got["im_info"].numpy(), np.asarray(ref["im_info"]))
    assert pair["port"].resize_batch(batch, (IMG, IMG)) is batch
