"""The FPN detectors of the port on a Darknet or CSPDarknet backbone, against
the JAX package on the CPU.

``MODEL.BACKBONE.NAME`` ``darknet21`` or ``csp_darknet`` under tiny
RetinaNet (``tests/tiny.shrink`` apart from the backbone; ``dark3``-``dark5``
with the ``p6p7`` top block on ``dark5``) and tiny Faster R-CNN (``dark2``-
``dark5`` under P2-P6), batch 2 of 128x192, from the same JAX variables
(train-mode BN statistics, BN affine and every bias drawn from a seed)
carried across by ``utils/weights.py``: the eval-mode outputs, the losses
and their gradients of one step, the BN running statistics that step
writes, and the detections. ``layers/backbone/build.py::feature_channels``
is held to the widths the backbones give.

Tolerances, and why:
  * RetinaNet's per-level eval outputs to 1e-4 of each tensor's largest
    entry, not the 1e-5 of tests/test_torch_retinanet.py: these backbones
    are 20 to 60 convolutions deep with a BN after each, where resnet10 is
    ten, and tests/test_torch_norm_backbones.py holds the two backbones
    alone to 1e-4; Faster R-CNN's box head scores and boxes per proposal
    slot to 1e-3 absolute, as tests/test_torch_faster_rcnn.py holds them,
    where up to 1% of the slots may hold their neighbour's: two proposals
    whose objectness differs by a rounding error come out of the RPN's
    top-k in either order (CSPDarknet swaps slots 92 and 93 of the first
    image; its FPN levels agree to 6e-6);
  * the losses to 1e-5 relative (RetinaNet) and 1e-4 (Faster R-CNN), as
    tests/test_torch_retinanet.py and tests/test_torch_faster_rcnn_train.py
    hold them;
  * the whole gradient, all tensors as one vector, to 1e-3 of its norm
    (measured: 5.1e-5 to 3.8e-4), and each tensor to 2e-2 of its largest
    entry, not the 1e-3 of the FrozenBN ResNet tests, whose trunk is frozen:
    here every convolution feeds a train-mode BN, whose backward removes the
    gradient's mean and its projection on the output, so a weight's gradient
    can be a small remainder of large terms. Darknet-21's
    ``dark3_block1/layer2`` kernel is one: 1.8e-2 of its largest entry apart
    under Faster R-CNN, 6.3e-3 under RetinaNet (every other tensor within
    4.1e-3), while the losses agree to 1e-7; moving the input images by 1e-3
    of a grey level moves the port's own gradients by up to 6.2e-3 of a
    tensor's largest entry. tests/test_torch_centernet.py measures XLA:CPU's
    f32 gradients through a train-mode BN backbone at 7.8e-3 from a float64
    run;
  * the BN running statistics to 1e-5 absolute, as
    tests/test_torch_norm_backbones.py;
  * detections as tests/test_torch_retinanet.py matches them (95% one to
    one) and Faster R-CNN's as tests/test_torch_faster_rcnn.py (99%).
"""
import jax
import numpy as np
import pytest
import torch

from basedet_tpu import configs as C
from basedet_tpu.utils import all_register
from basedet_tpu_torch import build_model
from basedet_tpu_torch.layers.backbone.build import feature_channels, make_backbone
from basedet_tpu_torch.utils.compare import match_detections
from basedet_tpu_torch.utils.weights import jax_from_state_dict, state_dict_from_jax
from tests.test_torch_faster_rcnn_train import IMG, MAX_INST, make_batch, port_noise
from tests.test_torch_yolox_train import flat
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

OUT_RTOL = 1e-4
FRCNN_ATOL = 1e-3
SWAPPED = 0.01  # share of Faster R-CNN's proposal slots that may hold the other side's neighbour
LOSS_RTOL = {"retinanet": 1e-5, "faster_rcnn": 1e-4}
GRAD_RTOL, GRAD_L2_RTOL = 2e-2, 1e-3
STATS_ATOL = 1e-5
MATCHED = {"retinanet": 0.95, "faster_rcnn": 0.99}
BACKBONES = ("darknet21", "csp_darknet")
MODELS = ("retinanet", "faster_rcnn")


def tiny_cfg(model, backbone):
    cfg = shrink({"retinanet": C.RetinaNetConfig, "faster_rcnn": C.FasterRCNNConfig}[model]())
    b = cfg.MODEL.BACKBONE
    b.NAME = backbone
    if model == "retinanet":
        b.OUT_FEATURES = ("dark3", "dark4", "dark5")
        cfg.MODEL.FPN.TOP_BLOCK_IN_FEATURE = "dark5"
    else:
        b.OUT_FEATURES = ("dark2", "dark3", "dark4", "dark5")
    cfg.DATA.MAX_INSTANCES = MAX_INST
    cfg.MODEL.BATCHSIZE = 2
    return cfg


def randomise(variables, rng):
    """BN running statistics and affine and every bias drawn from rng; the
    class logits' biases spread by 2, so that some scores clear the
    detection threshold."""
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
                cls = path[-1].startswith("cls_score") or path[-1] == "pred_cls"
                v = v + rng.normal(0.0, 2.0 if cls else 0.3, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(jax.device_get(variables), ())


def port_with(cfg, variables):
    port = build_model(cfg, "cpu")
    port.module.load_state_dict(state_dict_from_jax(variables, port.module.state_dict()))
    return port


@pytest.fixture(scope="module", params=[(m, b) for m in MODELS for b in BACKBONES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """One batch through both models from the same weights: eval-mode
    outputs, detections, then one train pass's losses, gradients and new BN
    statistics."""
    model, backbone = request.param
    all_register()
    cfg = tiny_cfg(model, backbone)
    jmodel = cfg.build_model()
    variables = randomise(jmodel.init_variables(jax.random.PRNGKey(0), image_size=IMG), np.random.RandomState(0))
    assert "batch_stats" in variables and "frozen" not in variables
    batch = make_batch()
    port = port_with(cfg, variables)
    rng = jax.random.PRNGKey(11)
    out = dict(model=model, cfg=cfg, variables=variables, batch=batch)

    image = jmodel.pre_process(batch, train=False)["image"]
    if model == "retinanet":
        out["jout"] = jax.device_get(jax.jit(jmodel.make_module(train=False).apply)(variables, image))
        with torch.no_grad():
            out["out"] = port.module(port.pre_process(batch)["image"])
    else:
        img_info = jmodel.pre_process(batch, train=False)["img_info"]
        out["jout"] = jax.device_get(jax.jit(jmodel.make_module(train=False).apply)(variables, image, img_info))
        with torch.inference_mode():
            x = port.pre_process(batch)
            feats = port.module.features(x["image"])
            proposals, valid = port.module.proposals(feats, x["img_info"])
            boxes, scores = port.module.box_head(port.module.pool(feats, proposals), proposals)
        out["out"] = (proposals, valid, boxes, scores)
    out["jdets"] = jax.device_get(jmodel.inference_jit(variables, batch))
    out["dets"] = {k: v.numpy() for k, v in port.inference(batch).items()}

    def loss_fn(params):
        total, losses, new_state = jmodel.get_losses({**variables, "params": params}, batch, rng)
        return total, (losses, new_state)

    (_, (jlosses, jstate)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    port.train()
    port.module.zero_grad(set_to_none=True)
    noise = {"noise": port_noise(port, rng)} if model == "faster_rcnn" else {}
    total, losses = port.get_losses(batch, **noise)
    total.backward()
    named = dict(port.module.named_parameters())
    grads = jax_from_state_dict({n: p.grad for n, p in named.items() if p.grad is not None})
    out.update(jlosses=jax.device_get(jlosses), jstats=flat(jax.device_get(jstate)["batch_stats"]),
               jgrads=flat(jax.device_get(jgrads)), losses={k: float(v.detach()) for k, v in losses.items()},
               grads=flat(grads["params"]), no_grad={n for n, p in named.items() if p.grad is None},
               stats=flat(jax_from_state_dict(port.module.state_dict())["batch_stats"]))
    return out


def _rel(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("name", BACKBONES)
def test_feature_channels_are_the_backbones_widths(name):
    feats = ("stem", "dark2", "dark3", "dark4", "dark5")
    with torch.no_grad():
        got = make_backbone(name, feats)(torch.zeros(1, 3, 64, 64))
    assert {k: v.shape[1] for k, v in got.items()} == {k: feature_channels(name)[k] for k in feats}
    assert feature_channels("resnet50")["res5"] == 2048
    with pytest.raises(ValueError, match="unknown hf backbone 'tiny'"):
        feature_channels("hf_tiny")


def test_eval_outputs_match_jax(run):
    if run["model"] == "retinanet":
        (logits, offsets), (jlogits, joffsets) = run["out"], run["jout"]
        assert len(logits) == len(jlogits) == 5
        for lv, (lg, of, jl, jo) in enumerate(zip(logits, offsets, jlogits, joffsets)):
            _rel(lg.permute(0, 2, 3, 1).numpy(), jl, OUT_RTOL, f"logits p{lv + 3}")
            _rel(of.permute(0, 2, 3, 1).numpy(), jo, OUT_RTOL, f"offsets p{lv + 3}")
        return
    _, valid, boxes, scores = run["out"]
    jboxes, jscores, jvalid = run["jout"]
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    got = np.concatenate([boxes.numpy().reshape(*jvalid.shape, -1), scores.numpy().reshape(*jvalid.shape, -1)], -1)
    want = np.concatenate([np.reshape(jboxes, (*jvalid.shape, -1)), np.reshape(jscores, (*jvalid.shape, -1))], -1)
    close = lambda a, b: np.abs(a - b).max(-1) <= FRCNN_ATOL
    in_place = close(got, want)
    # two proposals whose objectness the two sides round to the other order swap slots
    swapped = np.zeros_like(in_place)
    swapped[:, :-1] |= close(got[:, :-1], want[:, 1:]) & close(got[:, 1:], want[:, :-1])
    swapped[:, 1:] |= swapped[:, :-1].copy()
    assert (in_place | swapped).all(), np.argwhere(~(in_place | swapped))
    assert (~in_place).sum() <= SWAPPED * in_place.size, (~in_place).sum()


def test_detections_match_jax(run):
    want, got = run["jdets"], run["dets"]
    assert want["valid"].sum() > 0 and got["valid"].sum() > 0
    assert match_detections(want, got) >= MATCHED[run["model"]]


def test_losses_match_jax(run):
    assert set(run["losses"]) == set(run["jlosses"])
    for k, v in run["losses"].items():
        ref = float(run["jlosses"][k])
        assert ref > 0, k
        assert abs(v - ref) <= LOSS_RTOL[run["model"]] * abs(ref), (k, v, ref)


def test_gradients_match_jax(run):
    """Every parameter of these backbones trains (no ``FREEZE_AT``, as in the
    JAX package, which passes it to ResNet alone)."""
    assert run["no_grad"] == set()
    assert set(run["grads"]) == set(run["jgrads"])
    assert any(k.startswith("bottom_up/dark2") for k in run["grads"])
    keys = sorted(run["grads"])
    got = np.concatenate([run["grads"][k].ravel() for k in keys]).astype(np.float64)
    want = np.concatenate([run["jgrads"][k].ravel() for k in keys]).astype(np.float64)
    assert np.linalg.norm(got - want) <= GRAD_L2_RTOL * np.linalg.norm(want)
    for k in keys:
        _rel(run["grads"][k], run["jgrads"][k], GRAD_RTOL, k)


def test_bn_statistics_match_jax(run):
    assert set(run["stats"]) == set(run["jstats"]) and run["stats"]
    for k, got in run["stats"].items():
        np.testing.assert_allclose(got, run["jstats"][k], rtol=0, atol=STATS_ATOL, err_msg=k)
