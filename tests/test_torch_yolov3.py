"""The port's YOLOv3 (basedet_tpu_torch) against the JAX package on the CPU,
in f32: ``ConvBNAct`` with Darknet's BN (eps 1e-5, flax decay 0.9) and with
YOLOX's (unchanged), Darknet-21's features, ``YOLOFPN``'s maps, ``YOLOHead``,
and tiny YOLOv3 (Darknet-21 at width 8, batch 2 of 128x192, weights carried
across by ``utils/weights.py``): the anchor match, the targets and the ignore
mask exactly, the losses, gradients and new BN statistics, and the
detections.

The JAX package's ``YOLOv3Module`` always builds Darknet-53 at width 32; the
tiny model here is the JAX package's own ``Darknet`` and ``YOLOFPN`` at
depth 21 and width 8, under its ``YOLOv3`` losses and inference
(``make_module`` overridden). The JAX side's targets and ignore masks are
read from inside its ``get_losses``: its ``jnp.full`` scatters and its
``jax.vmap`` results are recorded during the one trace of the loss and its
gradient and returned beside them.

The batch holds two colliding gts (one cell and anchor, other classes: the
highest gt index writes the regression targets, XLA:CPU's order, and both
classes are set), gts whose centre lies off the grid (dropped) and one at a
negative x that truncates into column 0 (kept, as int32 truncation gives
it), and gts shaped like anchors at cell centres, so that some rows are
ignored.

Tolerances, and why:
  * one layer and the tiny model's maps to 1e-5 of each tensor's largest
    entry: the same f32 operations, each convolution summed in its own order;
  * targets, anchor match and ignore mask exactly (the same f32 operations
    on the same gts; the ignore mask on decoded boxes that agree to 1e-6,
    with no IoU within 1e-4 of the threshold);
  * losses to 1e-5 relative; gradients to 1e-3 of each tensor's largest
    entry, as tests/test_torch_yolox_train.py; BN statistics to 1e-4 of
    max(|value|, 1);
  * detections at least 95% matched one to one (label, IoU >= 0.999,
    |dscore| <= 1e-4): near-equal scores may order differently in the
    top-1000 and in NMS.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from basedet_tpu import configs as C
from basedet_tpu.layers.backbone.yolo_fpn import YOLOFPN as JYOLOFPN
from basedet_tpu.models.cls.darknet import Darknet as JDarknet
from basedet_tpu.models.cls.darknet import darknet_feature_channels
from basedet_tpu.models.det import yolov3 as jyolov3
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch.configs import YOLOv3Config
from basedet_tpu_torch.layers.backbone.yolo_fpn import YOLOFPN
from basedet_tpu_torch.layers.blocks.yolo_block import DARKNET_KW, ConvBNAct
from basedet_tpu_torch.layers.head.yolo_head import YOLOHead
from basedet_tpu_torch.models.cls.darknet import Darknet
from basedet_tpu_torch.utils.compare import match_detections
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_retinanet import assert_rel, nchw, nhwc
from tests.test_torch_yolox_train import flat
from tests.torch_threads import torch_threads  # noqa: F401

IMG = (128, 192)
MAX_INST = 8
WIDTH = 8
LAYER_RTOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
STATS_RTOL = 1e-4
LOSSES = ("total_loss", "loss_xy", "loss_wh", "loss_conf", "loss_cls")


def spread(variables, rng, pred_scale=1.0):
    """BN statistics and affine and every bias drawn from rng; prediction
    kernels (``*_pred``) scaled by ``pred_scale``, so that a prediction is
    mostly its bias; the objectness and class biases spread by 2."""
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
            elif k == "kernel" and path[-1].endswith("pred"):
                v = v * pred_scale
            elif k == "bias":
                noise = rng.normal(0.0, 0.3, v.shape)
                if path[-1].endswith("pred"):  # channels (a, 5 + C): spread conf and classes
                    per = noise.reshape(3, -1)
                    per[:, 4:] = rng.normal(-2.0, 2.0, per[:, 4:].shape)
                    noise = per.reshape(-1)
                v = v + noise
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.device_get(variables), ())


def _jax_block(module, x, rng, train):
    """One compiled init and apply of a flax block (eager dispatch compiles
    every primitive apart, several times slower on the CPU)."""
    variables = spread(jax.jit(module.init)(jax.random.PRNGKey(0), x), rng)
    if train:
        out, state = jax.jit(lambda v, x: module.apply(v, x, mutable=["batch_stats"]))(variables, x)
        return variables, out, state
    return variables, jax.jit(module.apply)(variables, x), None


@pytest.mark.parametrize("kind", ["darknet", "yolox"])
def test_conv_bn_act_matches_jax_in_train_mode(kind):
    """Outputs and the new running statistics, Darknet's BN (eps 1e-5, flax
    decay 0.9 = torch momentum 0.1) and YOLOX's unchanged (1e-3, 0.97 = 0.03)."""
    from basedet_tpu.layers.blocks.yolo_block import _ConvBNAct

    rng = np.random.RandomState(0)
    x = rng.normal(0.0, 1.0, (2, 12, 14, 6)).astype(np.float32)
    jkw = dict(act="lrelu", bn_eps=1e-5, bn_momentum=0.9) if kind == "darknet" else {}
    variables, want, state = _jax_block(_ConvBNAct(8, 3, 2, train=True, **jkw), jnp.asarray(x), rng, True)
    port = ConvBNAct(6, 8, 3, 2, **(DARKNET_KW if kind == "darknet" else {}))
    assert (port.bn.eps, port.bn.momentum) == ((1e-5, 0.1) if kind == "darknet" else (1e-3, 0.03))
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    port.train()
    with torch.no_grad():
        got = port(nchw(x))
    assert_rel(nhwc(got), np.asarray(want), LAYER_RTOL)
    for leaf, buf in (("mean", port.bn.running_mean), ("var", port.bn.running_var)):
        want_s = np.asarray(state["batch_stats"]["BatchNorm_0"][leaf])
        assert np.abs(buf.numpy() - want_s).max() <= STATS_RTOL * max(1.0, np.abs(want_s).max()), leaf


def test_darknet21_features_match_jax():
    rng = np.random.RandomState(1)
    x = rng.normal(0.0, 1.0, (1, 64, 96, 3)).astype(np.float32)
    jmod = JDarknet(depth=21, out_channels=WIDTH, out_features=("dark3", "dark4", "dark5"))
    variables, want, _ = _jax_block(jmod, jnp.asarray(x), rng, False)
    port = Darknet(21, WIDTH).eval()
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    assert {"stem.conv.weight", "dark1_down.bn.running_var", "dark5_block0.layer2.conv.weight"} <= set(port.state_dict())
    with torch.no_grad():
        got = port(nchw(x))
    assert set(got) == set(want) == {"dark3", "dark4", "dark5"}
    chans = darknet_feature_channels(WIDTH)
    for k in want:
        assert got[k].shape[1] == chans[k]
        assert_rel(nhwc(got[k]), want[k], LAYER_RTOL, k)


def test_yolo_fpn_matches_jax():
    """Coarse to fine outputs, the fifth conv's tap and the lateral path."""
    rng = np.random.RandomState(2)
    chans = darknet_feature_channels(WIDTH)
    feats = [rng.normal(0.0, 1.0, (2, 32 // s, 48 // s, chans[n])).astype(np.float32)
             for s, n in ((1, "dark3"), (2, "dark4"), (4, "dark5"))]
    mids = [(chans["dark4"], chans["dark5"]), (chans["dark3"], chans["dark4"]), (chans["dark2"], chans["dark3"])]
    jmod = JYOLOFPN(out_channels=[21, 21, 21], mid_channels=mids)
    jin = [jnp.asarray(f) for f in feats]
    variables, want, _ = _jax_block(jmod, jin, rng, False)
    port = YOLOFPN([chans["dark3"], chans["dark4"], chans["dark5"]], [21, 21, 21], mids).eval()
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    with torch.no_grad():
        got = port([nchw(f) for f in feats])
    assert [tuple(g.shape[-2:]) for g in got] == [(8, 12), (16, 24), (32, 48)]
    for lv in range(3):
        assert_rel(nhwc(got[lv]), want[lv], LAYER_RTOL, lv)


def test_yolo_head_matches_jax():
    from basedet_tpu.layers.head.yolo_head import YOLOHead as JHead

    rng = np.random.RandomState(3)
    feats = [rng.normal(0.0, 1.0, (2, h, w, c)).astype(np.float32) for h, w, c in ((4, 6, 16), (8, 12, 8))]
    jin = [jnp.asarray(f) for f in feats]
    variables, want, _ = _jax_block(JHead(num_classes=4, num_anchors=3), jin, rng, False)
    port = YOLOHead(4, [16, 8], num_anchors=3).eval()
    port.load_state_dict(state_dict_from_jax(variables, port.state_dict()))
    with torch.no_grad():
        got = port([nchw(f) for f in feats])
    for lv in range(2):
        assert got[lv].shape[1] == 3 * 9
        assert_rel(nhwc(got[lv]), want[lv], LAYER_RTOL, lv)


# -- tiny YOLOv3 ---------------------------------------------------------------------------------

class _TinyModule(fnn.Module):
    """The JAX package's YOLOv3Module at Darknet-21 and width 8."""

    num_classes: int = 80
    train: bool = False

    @fnn.compact
    def __call__(self, image):
        feats = JDarknet(depth=21, out_channels=WIDTH, out_features=("dark3", "dark4", "dark5"),
                         train=self.train, name="bottom_up")(image)
        c = darknet_feature_channels(WIDTH)
        mids = [(c["dark4"], c["dark5"]), (c["dark3"], c["dark4"]), (c["dark2"], c["dark3"])]
        return JYOLOFPN(out_channels=[3 * (5 + self.num_classes)] * 3, mid_channels=mids, train=self.train,
                        name="fpn")([feats["dark3"], feats["dark4"], feats["dark5"]])


class _TinyYOLOv3(jyolov3.YOLOv3):
    def make_module(self, train):
        return _TinyModule(num_classes=self.num_classes, train=train)


def tiny_cfg():
    cfg = YOLOv3Config()
    cfg.MODEL.BACKBONE.NAME = "darknet21"
    cfg.MODEL.BACKBONE.OUT_CHANNELS = WIDTH
    cfg.DATA.MAX_INSTANCES = MAX_INST
    cfg.MODEL.BATCHSIZE = 2
    return cfg


def make_batch():
    """Image 0: a colliding pair (same centre cell at stride 8, sizes that pick
    the same anchor, classes 3 and 7), a gt centred past the right edge, one
    at x = -40 (column -1: dropped) and one at x = -5 (truncates to column
    0: kept), two anchor-shaped gts at cell centres. Image 1: DummyLoader's
    three gts and padding."""
    rng = np.random.RandomState(5)
    h, w = IMG
    batch = {"data": rng.uniform(0, 255, (2, h, w, 3)).astype(np.float32),
             "gt_boxes": np.zeros((2, MAX_INST, 5), np.float32),
             "im_info": np.asarray([[h, w, h, w, 7], [h, w, h, w, 3]], np.float32)}

    def box(cx, cy, bw, bh, cls):
        return [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2, cls]

    batch["gt_boxes"][0, :7] = [
        box(52, 44, 12, 14, 3), box(53, 45, 11, 13, 7),   # one cell (6, 5) at stride 8, anchor (10, 13)
        box(w + 20, 60, 40, 30, 1),                        # centre off the grid
        box(-40, 70, 30, 62, 2),                           # column -1: dropped
        box(-5, 90, 16, 30, 5),                            # truncates to column 0
        box(16 * 3 + 8, 16 * 2 + 8, 30, 61, 4),            # anchor (30, 61) at a stride-16 centre
        box(8 * 10 + 4, 8 * 9 + 4, 16, 30, 6),             # anchor (16, 30) at a stride-8 centre
    ]
    from basedet_tpu_torch.utils.dummy import DummyLoader

    other = DummyLoader(batch_size=1, image_size=IMG, max_instances=MAX_INST).make_batch()
    batch["gt_boxes"][1] = other["gt_boxes"][0]
    return batch


class _Recorder:
    """Stands in for a module's ``jnp`` (``full`` scatters recorded) or
    ``jax`` (``vmap`` results recorded) during one trace."""

    def __init__(self, real, seen):
        self._real, self._seen = real, seen

    def __getattr__(self, name):
        return getattr(self._real, name)

    def vmap(self, fn, *args, **kwargs):
        mapped = self._real.vmap(fn, *args, **kwargs)

        def run(*a):
            out = mapped(*a)
            self._seen.append(("vmap", out))
            return out
        return run

    def full(self, shape, fill, dtype=None):
        real, seen = self._real, self._seen

        class _At:
            def __getitem__(self, idx):
                base = real.full(shape, fill, dtype)
                return types.SimpleNamespace(set=lambda v, **kw: seen.append(("full", base.at[idx].set(v, **kw)))
                                             or seen[-1][1])
        return types.SimpleNamespace(at=_At())


def port_with(variables, cfg):
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    return port


@pytest.fixture(scope="module")
def tiny():
    """One batch through both models from the same weights. JAX: one compiled
    loss-and-gradient program that also returns its targets, anchor match and
    ignore masks, then the detections; the port: the same pieces."""
    all_register()
    cfg = tiny_cfg()
    jcfg = C.YOLOv3Config()
    jcfg.DATA.MAX_INSTANCES = MAX_INST
    jmodel = _TinyYOLOv3(jcfg)
    variables = spread(jmodel.init_variables(jax.random.PRNGKey(0), image_size=IMG), np.random.RandomState(0),
                       pred_scale=0.05)
    batch = make_batch()

    def loss_fn(params):
        seen = []
        saved = jyolov3.jnp, jyolov3.jax
        jyolov3.jnp, jyolov3.jax = _Recorder(jnp, seen), _Recorder(jax, seen)
        try:
            total, losses, state = jmodel.get_losses({**variables, "params": params}, batch)
        finally:
            jyolov3.jnp, jyolov3.jax = saved
        return total, (losses, state, [v for _, v in seen])

    (_, (jlosses, jstate, seen)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    seen = jax.device_get(seen)
    anchor_ious, ignores = seen[0], seen[1::7]
    # per level: 6 scatters (mask, tx, ty, tw, th, tscale) after each level's ignore vmap
    scatters = [seen[2 + 7 * lv: 8 + 7 * lv] for lv in range(3)]
    jdets = jax.device_get(jmodel.inference_jit(variables, batch))

    port = port_with(variables, cfg)
    port.train()
    port.module.zero_grad(set_to_none=True)
    total, losses = port.get_losses(batch)
    total.backward()
    named = dict(port.module.named_parameters())
    grads = jax_from_state_dict({n: p.grad for n, p in named.items()})
    stats = {k: v.detach().clone() for k, v in port.module.state_dict().items() if "running" in k}
    return dict(cfg=cfg, variables=variables, batch=batch, anchor_ious=anchor_ious, ignores=ignores,
                scatters=scatters, jlosses=jax.device_get(jlosses), jgrads=flat(jax.device_get(jgrads)),
                jstats=flat(jax.device_get(jstate["batch_stats"])), jdets=jdets,
                losses={k: float(v.detach()) for k, v in losses.items()}, grads=flat(grads["params"]),
                stats=flat(jax_from_state_dict(stats)["batch_stats"]))


def _port_pieces(tiny):
    """The port's maps, targets and ignore mask on the batch, in train mode
    from the same weights (a fresh model, so the BN statistics are the
    loaded ones)."""
    port = port_with(tiny["variables"], tiny["cfg"])
    port.train()
    with torch.no_grad():
        x = port.pre_process(tiny["batch"], train=True)
        preds = port.module(x["image"])
        gt, nv = x["gt_boxes"], x["img_info"][:, 4].to(torch.int32)
        pred = port.flatten(preds)
        hw = [tuple(p.shape[-2:]) for p in preds]
        t = port.targets(gt, nv, hw, float(x["image"].shape[2]))
        dec = port.decode(pred, port.grids(preds))
        ignore = port.ignore_mask(dec, gt, nv)
    sizes = [h * w * 3 for h, w in hw]
    return port, t, ignore, sizes, dec, gt


def test_targets_match_jax_exactly(tiny):
    port, t, _, sizes, _, _ = _port_pieces(tiny)
    names = ("mask", "tx", "ty", "tw", "th", "tscale")
    for lv in range(3):
        for name, want in zip(names, tiny["scatters"][lv]):
            got = t[name].split(sizes, dim=1)[lv].numpy()
            assert got.shape == want.shape, (lv, name)
            assert np.array_equal(got.view(np.int32), np.asarray(want, np.float32).view(np.int32)), (lv, name)
    # the colliding pair: one written slot carrying the second gt's targets, both classes set
    gt = torch.from_numpy(tiny["batch"]["gt_boxes"][0, :2])
    cx = (gt[:, 0] + gt[:, 2]) * 0.5
    row = sizes[0] + sizes[1] + (int((gt[0, 1] + gt[0, 3]) * 0.5 / 8) * 24 + int(cx[0] / 8)) * 3
    tx = t["tx"][0].reshape(-1)
    assert t["mask"][0].sum() == 4  # 7 gts: the pair shares a slot, two off the grid
    assert float(tx[row]) == float(cx[1] / 8 - int(cx[1] / 8))
    assert int(cx[0] / 8) == int(cx[1] / 8)
    cls_set = (t["tcls"][0].sum(-1) > 0).nonzero().flatten().tolist()
    classes = t["tcls"][0][row].nonzero().flatten().tolist()
    assert classes == [2, 6] and row in cls_set


def test_anchor_match_and_ignore_mask_match_jax_exactly(tiny):
    from basedet_tpu_torch.ops.iou_kernel import box_iou

    port, _, ignore, sizes, dec, gt = _port_pieces(tiny)
    all_anchors = port.anchors.reshape(-1, 2)
    wh = torch.stack([gt[..., 2] - gt[..., 0], gt[..., 3] - gt[..., 1]], dim=-1)
    ious = box_iou(torch.cat([-wh / 2, wh / 2], -1), torch.cat([-all_anchors / 2, all_anchors / 2], 1))
    assert np.array_equal(ious.numpy(), tiny["anchor_ious"])
    for lv in range(3):
        want = np.asarray(tiny["ignores"][lv])
        got = ignore.split(sizes, dim=1)[lv].numpy()
        assert np.array_equal(got, want), lv
    assert ignore.any() and not ignore.all()
    k_valid = torch.arange(MAX_INST)[None, :] < torch.tensor([7, 3])[:, None]
    best = torch.where(k_valid[:, None], box_iou(dec, gt[..., :4].contiguous()), 0.0).amax(2)
    assert float((best - port.ignore_threshold).abs().min()) > 1e-4  # no row on the threshold's edge


def test_losses_grads_and_bn_stats_match_jax(tiny):
    for k in LOSSES:
        want = float(tiny["jlosses"][k])
        assert abs(tiny["losses"][k] - want) <= LOSS_RTOL * abs(want), (k, tiny["losses"][k], want)
    assert set(tiny["grads"]) == set(tiny["jgrads"])
    for k, want in tiny["jgrads"].items():
        assert_rel(tiny["grads"][k], want, GRAD_RTOL, k)
    assert set(tiny["stats"]) == set(tiny["jstats"])
    for k, want in tiny["jstats"].items():
        err = np.abs(tiny["stats"][k] - want).max()
        assert err <= STATS_RTOL * max(1.0, np.abs(want).max()), (k, err)


def test_detections_match_jax(tiny):
    port = port_with(tiny["variables"], tiny["cfg"])
    got = {k: v.numpy() for k, v in port.inference(tiny["batch"]).items()}
    want = tiny["jdets"]
    assert want["valid"].sum() > 0
    assert match_detections(want, got) >= 0.95
    assert match_detections(got, want) >= 0.95


def test_yolov3_refuses_other_backbones():
    cfg = tiny_cfg()
    cfg.MODEL.BACKBONE.NAME = "darknet19"
    with pytest.raises(NotImplementedError, match="darknet19"):
        build_model(cfg, "cpu")
