"""The port's Faster R-CNN inference (basedet_tpu_torch) against the JAX
package on the CPU; tests/test_torch_faster_rcnn_train.py holds its training.

Tiny Faster R-CNN (``tests/tiny.shrink``: resnet10, FPN width 64, one anchor
per location, RPN top-k 200 before and 100 after NMS) on two 128x192
images. Weights come from the JAX ``init_variables`` tree with the frozen BN
statistics and affine and every bias randomised, the class logits' biases
widely (so that detections pass the 0.05 score threshold), converted through
``utils/weights.py`` into the port. Inputs come from numpy with a fixed seed.

Tolerances, and why:
  * FPN levels within 1e-4 absolute: XLA:CPU and oneDNN sum each convolution
    in their own order, a few f32 ulps per layer over a dozen layers
    (docs/PARITY.md:58-66 budgets ~1e-3 per stage across backends);
  * RPN proposals: the same valid slots, boxes within 1e-3 (decoded from
    offsets that carry the FPN's error, times exp, in pixels);
  * pooled features, class scores and class-specific boxes within 1e-3 of
    the JAX values on the same proposals (a 3136-wide fc1 sum on inputs
    that carry the FPN's error);
  * detections matched one-to-one by label, IoU >= 0.999 and |dscore| <=
    1e-4, at least 99% of them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.layers.backbone.fpn import _upsample2x
from basedet_tpu.layers.common.anchor_generator import DefaultAnchorGenerator as JAnchors
from basedet_tpu.layers.head.rcnn import RCNNPredictor as JRCNNPredictor
from basedet_tpu.models.det.rpn import find_top_proposals_single
from basedet_tpu.ops.roi_align_separable import multilevel_roi_align_batched as jax_roi_align
from basedet_tpu.structures import BoxCoder as JBoxCoder
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch.layers.backbone.fpn import upsample_like
from basedet_tpu_torch.layers.common.anchor_generator import DefaultAnchorGenerator
from basedet_tpu_torch.layers.head.rcnn import RCNNPredictor
from basedet_tpu_torch.structures import BoxCoder
from basedet_tpu_torch.utils.compare import match_detections
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

IMG = (128, 192)
FPN_ATOL = 1e-4
HEAD_ATOL = 1e-3


def _randomise(variables, rng):
    """Frozen BN mean/var/scale/bias and every bias drawn from rng; the class
    logits' biases spread by 2 so that some classes stand out."""
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
                v = v + rng.normal(0.0, 2.0 if "pred_cls" in path else 0.3, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.device_get(variables), ())


@pytest.fixture(scope="module")
def frcnn():
    all_register()
    cfg = shrink(C.FasterRCNNConfig())
    jmodel = cfg.build_model()
    variables = _randomise(jmodel.init_variables(jax.random.PRNGKey(0), image_size=IMG),
                           np.random.RandomState(0))
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    batch = DummyLoader(batch_size=2, image_size=IMG, max_instances=6).make_batch()
    batch = {k: batch[k] for k in ("data", "im_info")}
    batch["im_info"][1, :4] = (120, 180, 240, 360)  # a smaller, rescaled second image
    inputs = jmodel.pre_process(batch, train=False)
    module = jmodel.make_module(train=False)
    (jboxes, jscores, jvalid), inter = jax.jit(
        lambda v, x, i: module.apply(v, x, i, capture_intermediates=True))(
        variables, inputs["image"], inputs["img_info"])
    inter = jax.device_get(inter["intermediates"])
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, port=port, batch=batch,
                img_info=np.asarray(inputs["img_info"]),
                fpn=inter["fpn"]["__call__"][0], rpn=inter["rpn"]["__call__"][0],
                jout=jax.device_get((jboxes, jscores, jvalid)))


@pytest.fixture(scope="module")
def port_stages(frcnn):
    port = frcnn["port"]
    with torch.inference_mode():
        x = port.pre_process(frcnn["batch"])
        feats = port.module.features(x["image"])
        proposals, valid = port.module.proposals(feats, x["img_info"])
        pooled = port.module.pool(feats, proposals)
        boxes, scores = port.module.box_head(pooled, proposals)
    return dict(feats=feats, proposals=proposals, valid=valid, pooled=pooled, boxes=boxes,
                scores=scores)


def _jax_proposals(frcnn):
    """The module's proposal step on the JAX side, from its captured RPN
    outputs, as ``FasterRCNNModule.__call__`` runs it."""
    m = frcnn["cfg"].MODEL
    fpn = frcnn["fpn"]
    names = [f"p{int(np.log2(s))}" for s in m.FPN.STRIDES]
    anchors = JAnchors(m.ANCHOR.SCALES, m.ANCHOR.RATIOS, tuple(m.FPN.STRIDES), m.ANCHOR.OFFSET)(
        [fpn[n].shape[1:3] for n in names])
    logits_l, offsets_l = frcnn["rpn"]
    B = logits_l[0].shape[0]
    coder = JBoxCoder(tuple(m.RPN_BOX_REG.MEAN), tuple(m.RPN_BOX_REG.STD))
    return jax.vmap(lambda lg, of, info: find_top_proposals_single(
        lg, of, anchors, (info[0], info[1]), coder, m.RPN.TEST_PREV_NMS_TOPK,
        m.RPN.TEST_POST_NMS_TOPK, m.RPN.NMS_THRESHOLD))(
        [jnp.asarray(x).reshape(B, -1) for x in logits_l],
        [jnp.asarray(x).reshape(B, -1, 4) for x in offsets_l], jnp.asarray(frcnn["img_info"]))


def _flatten(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def test_weight_bridge_round_trips_frozen_and_dense(frcnn):
    sd = frcnn["port"].module.state_dict()
    back = jax_from_state_dict(sd)
    want = {k: np.asarray(v) for k, v in _flatten(frcnn["variables"]).items()}
    got = _flatten(back)
    assert set(got) == set(want)
    assert {k[0] for k in got} == {"params", "frozen"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))
    # fc1 keeps flax's (h, w, c) row order: the port pools channels last, so
    # the bridge only transposes; a permuted (c, h, w) layout would fail here
    np.testing.assert_array_equal(sd["rcnn.fc1.weight"].numpy(),
                                  np.asarray(frcnn["variables"]["params"]["rcnn"]["fc1"]["kernel"]).T)
    assert "bottom_up.layer1_0.FrozenBatchNorm_1.running_var" in sd


def test_box_head_flattens_like_flax(frcnn):
    """The port's predictor on the same channels-last pooled features as the
    flax one: a wrong fc1 row order (CHW against HWC) fails here."""
    rng = np.random.RandomState(1)
    pooled = rng.normal(0, 1, (5, 7, 7, 64)).astype(np.float32)
    params = {"params": frcnn["variables"]["params"]["rcnn"]}
    jl, jd = JRCNNPredictor(num_classes=80).apply(params, jnp.asarray(pooled))
    head = RCNNPredictor(7 * 7 * 64, 80)
    head.load_state_dict({k.split(".", 1)[1]: v for k, v in
                          state_dict_from_jax(frcnn["variables"]).items() if k.startswith("rcnn.")})
    with torch.no_grad():
        pl, pd = head(torch.from_numpy(pooled))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=1e-4)


def test_fpn_levels_match(frcnn, port_stages):
    for name, want in frcnn["fpn"].items():
        got = port_stages["feats"][name].permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=FPN_ATOL, err_msg=name)
    assert set(port_stages["feats"]) == {"p2", "p3", "p4", "p5", "p6"}


def test_rpn_proposals_match(frcnn, port_stages):
    jboxes, _, jvalid = jax.device_get(_jax_proposals(frcnn))
    valid = port_stages["valid"].numpy()
    np.testing.assert_array_equal(valid, jvalid)
    assert valid.sum(1).min() > 20
    np.testing.assert_allclose(port_stages["proposals"].numpy()[valid], jboxes[jvalid], atol=HEAD_ATOL)


def test_pooled_features_and_heads_match(frcnn, port_stages):
    fpn = frcnn["fpn"]
    proposals = port_stages["proposals"].numpy()
    want = jax_roi_align([jnp.asarray(fpn[n]) for n in ("p2", "p3", "p4", "p5")],
                         jnp.asarray(proposals), (4, 8, 16, 32), (7, 7))
    np.testing.assert_allclose(port_stages["pooled"].numpy(), np.asarray(want), atol=HEAD_ATOL)
    jboxes, jscores, jvalid = frcnn["jout"]
    np.testing.assert_array_equal(port_stages["valid"].numpy(), jvalid)
    np.testing.assert_allclose(port_stages["scores"].numpy(), jscores, atol=HEAD_ATOL)
    np.testing.assert_allclose(port_stages["boxes"].numpy(), jboxes, atol=HEAD_ATOL)


def test_detections_match(frcnn):
    want = jax.device_get(jax.jit(frcnn["jmodel"].inference)(frcnn["variables"], frcnn["batch"]))
    got = {k: v.numpy() for k, v in frcnn["port"].inference(frcnn["batch"]).items()}
    assert want["valid"].sum() > 10
    assert got["valid"].sum() == want["valid"].sum()
    assert match_detections(want, got) >= 0.99


def test_boxcoder_against_jax_and_golden():
    mean, std = (0.1, 0.2, 0.0, 0.0), (1.0, 1.0, 2.0, 2.0)
    anchors = np.float32([[0.0, 0.0, 10.0, 10.0], [5.0, 5.0, 9.0, 13.0]])
    gt = np.float32([[1.0, 2.0, 11.0, 9.0], [4.0, 4.0, 10.0, 12.0]])
    port, jcoder = BoxCoder(mean, std), JBoxCoder(mean, std)
    deltas = port.encode(torch.from_numpy(anchors), torch.from_numpy(gt))
    # anchor 0: (dx, dy, dw, dh) = (0.1, 0.05, 0, log 0.7), whitened
    np.testing.assert_allclose(deltas[0].numpy(), [0.0, -0.15, 0.0, np.log(0.7) / 2], atol=1e-6)
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jcoder.encode(anchors, gt)), atol=1e-6)
    np.testing.assert_allclose(port.decode(torch.from_numpy(anchors), deltas).numpy(), gt,
                               rtol=1e-4, atol=1e-3)
    rng = np.random.RandomState(0)
    d = rng.normal(0, 1, (2, 3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        port.decode(torch.from_numpy(anchors)[:, None, :], torch.from_numpy(d)).numpy(),
        np.asarray(jcoder.decode(anchors[:, None, :], d)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("src,dst", [((6, 10), (12, 20)), ((13, 21), (25, 42)), ((7, 5), (13, 9))])
def test_fpn_upsample_matches_jax_resize(src, dst):
    """Half-pixel bilinear, borders included, at even and odd sizes."""
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2, *src, 3)).astype(np.float32)
    like = np.zeros((2, *dst, 3), np.float32)
    want = np.asarray(_upsample2x(jnp.asarray(x), jnp.asarray(like)))
    got = upsample_like(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                        torch.from_numpy(like.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5)


def test_anchor_generator_matches_jax_at_full_scale():
    """Faster R-CNN's anchors (scales 32-512, ratios 0.5/1/2, offset 0.5) for
    an 800x1344 input, P2 200x336 ... P6 13x21: equal, element for element."""
    kw = dict(anchor_scales=[[32], [64], [128], [256], [512]], anchor_ratios=[[0.5, 1, 2]],
              strides=(4, 8, 16, 32, 64), offset=0.5)
    sizes = [(200, 336), (100, 168), (50, 84), (25, 42), (13, 21)]
    got = DefaultAnchorGenerator(**kw)(sizes, "cpu")
    want = JAnchors(**kw)(sizes)
    assert DefaultAnchorGenerator(**kw).num_anchors == 3
    assert [a.shape[0] for a in got] == [h * w * 3 for h, w in sizes]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
