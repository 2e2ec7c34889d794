"""The HF backbone zoo of the port (``basedet_tpu_torch/layers/backbone/
hf_adaptor.py``: ResNet and RegNet X/Y written as plain PyTorch) against the
JAX package's ``HFBackboneAdapter``, which wraps transformers' Flax modules,
on the CPU.

Weights come from the port's init with the BN running statistics and affine
and the squeeze-excitation biases drawn from a seed, carried to the JAX tree
by ``utils/weights.py`` (so no flax init runs), or from a directory that
``FlaxResNetModel`` / ``FlaxRegNetModel.save_pretrained`` writes here and
the port's ``load_hf_weights`` reads with its own msgpack decoder.

Configs are tiny dicts (depths of one or two layers, widths up to 64, 64x64
images), not presets, so the JAX side compiles quickly. Their widths differ
from the features' planes: the JAX adapter tells NHWC from the NCHW hidden
states transformers returns by the channel count alone, and hands a
feature whose width equals its channels back transposed.

transformers 4.57's ``FlaxRegNetXLayer`` passes ``in_channels`` to
``FlaxRegNetXLayerCollection``, which has no such field, so the JAX package
cannot build any RegNet X (``hf_regnetx_016`` raises TypeError there). The
X cases hold the port to the Flax X layer with that one field added
(``_x_layer_fixed``); the port builds the X presets as it builds the Y ones.

Tolerances, and why:
  * features to 1e-3 absolute per stage (docs/PARITY.md's per-stage
    yardstick), f32 with TF32 off (the CPU has none); measured 2e-5 at most,
    in train mode, where each BN normalises by a batch statistic of 2 images;
  * the running statistics after one train-mode pass to 1e-5 absolute, as
    tests/test_torch_norm_backbones.py holds them (measured 1e-5 at most);
  * tiny RetinaNet on an HF backbone: the head outputs to 1e-4 of each
    level's largest entry and the losses to 1e-5 relative, as
    tests/test_torch_backbone_dispatch.py holds the train-mode-BN backbones;
    detections 95% one to one, as tests/test_torch_retinanet.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basedet_tpu_torch import build_model
from basedet_tpu_torch.layers.backbone import hf_adaptor as P
from basedet_tpu_torch.layers.backbone.build import feature_channels, make_backbone
from basedet_tpu_torch.layers.precision import precision_policy
from basedet_tpu_torch.utils.compare import match_detections
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.registry import registers
from basedet_tpu_torch.utils.weights import jax_from_state_dict
from tests.test_torch_yolox_train import flat
from tests.torch_threads import torch_threads  # noqa: F401

FEAT_ATOL = 1e-3
STATS_ATOL = 1e-5
OUT_RTOL = 1e-4
LOSS_RTOL = 1e-5
MATCHED = 0.95
FEATURES = ("res2", "res3", "res4", "res5")

CONFIGS = {
    "basic": dict(model_type="resnet", embedding_size=24, hidden_sizes=[24, 32, 48, 64], depths=[1, 1, 1, 1],
                  layer_type="basic"),
    "bottleneck": dict(model_type="resnet", embedding_size=16, hidden_sizes=[32, 48, 64, 64], depths=[1, 1, 1, 1],
                       layer_type="bottleneck"),
    "x": dict(model_type="regnet", embedding_size=16, hidden_sizes=[24, 32, 48, 64], depths=[1, 1, 1, 1],
              groups_width=8, layer_type="x"),
    "y": dict(model_type="regnet", embedding_size=16, hidden_sizes=[24, 40, 48, 64], depths=[1, 2, 1, 1],
              groups_width=8, layer_type="y"),
}
# a tiny preset for the detectors, which take a backbone by name
TINY = "tiny_resnet"
TINY_PRESET = (16, (24, 40, 48, 64), (1, 1, 1, 1), "bottleneck")


@pytest.fixture(autouse=True)
def _x_layer_fixed(monkeypatch):
    """transformers' Flax RegNet X layer collection with the ``in_channels``
    field its caller passes (see the module docstring)."""
    from transformers.models.regnet import modeling_flax_regnet as mfr

    class XLayerCollection(mfr.FlaxRegNetXLayerCollection):
        in_channels: int = 0

    monkeypatch.setattr(mfr, "FlaxRegNetXLayerCollection", XLayerCollection)


def hf_pretrained_config(cfg):
    from transformers import RegNetConfig, ResNetConfig

    kind = ResNetConfig if cfg["model_type"] == "resnet" else RegNetConfig
    return kind(**{k: v for k, v in cfg.items() if k != "model_type"})


def randomised(module, seed):
    """``module``'s state with BN statistics and affine and every conv bias
    drawn from a seed."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        v = v.clone()
        if k.endswith("running_mean") or (k.endswith(".bias") and v.is_floating_point()):
            v = torch.randn(v.shape, generator=g) * 0.3
        elif k.endswith("running_var"):
            v = torch.rand(v.shape, generator=g) * 1.5 + 0.5
        elif k.endswith("normalization.weight"):
            v = torch.rand(v.shape, generator=g) + 0.5
        sd[k] = v
    return sd


def image(seed=0, size=64):
    return np.random.RandomState(seed).standard_normal((2, size, size, 3)).astype(np.float32)


def jax_features(cfg, variables, x, train):
    """The JAX adapter's features (NHWC) and, in train mode, its new batch
    statistics."""
    from basedet_tpu.layers.backbone.hf_adaptor import HFBackboneAdapter

    m = HFBackboneAdapter(name_or_cfg=hf_pretrained_config(cfg), out_features=FEATURES, train=train)
    if train:
        out, new = jax.jit(lambda v, x: m.apply(v, x, mutable=["batch_stats"]))(variables, x)
        return jax.device_get(out), flat(jax.device_get(new["batch_stats"]))
    return jax.device_get(jax.jit(m.apply)(variables, x)), None


def port_features(module, x, train):
    module.train(train)
    with torch.no_grad():
        out = module(torch.from_numpy(x).permute(0, 3, 1, 2))
    stats = flat(jax_from_state_dict(module.state_dict())["batch_stats"]) if train else None
    return {k: v.permute(0, 2, 3, 1).numpy() for k, v in out.items()}, stats


def assert_features(got, want):
    assert got.keys() == want.keys() == set(FEATURES)
    for f in FEATURES:
        assert got[f].shape == want[f].shape, f
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=FEAT_ATOL, err_msg=f)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_features_match_jax(kind, train):
    """The four layer types, eval and train mode: every stage's features, and
    after a train-mode pass every BN's running statistics (a RegNet layer's
    inner BNs keep theirs, as the Flax layers run them on running
    statistics; the stem's and the shortcuts' move)."""
    cfg = CONFIGS[kind]
    port = P.HFBackboneAdapter(cfg, FEATURES)
    sd = randomised(port, 1)
    port.load_state_dict(sd)
    variables = jax_from_state_dict(sd)
    x = image()
    want, want_stats = jax_features(cfg, variables, x, train)
    got, stats = port_features(port, x, train)
    assert_features(got, want)
    if train:
        assert stats.keys() == want_stats.keys()
        for k, v in want_stats.items():
            np.testing.assert_allclose(stats[k], v, rtol=0, atol=STATS_ATOL, err_msg=k)
        before = flat(variables["batch_stats"])
        moved = {k for k in before if not np.array_equal(before[k], stats[k])}
        if cfg["model_type"] == "regnet":
            assert moved and all("embedder" in k or "shortcut" in k for k in moved), sorted(moved)
        else:
            assert moved == set(before)


def test_bf16_policy_leaves_the_backbone_f32():
    """The HF modules use flax's own ``nn.Conv`` (f32), not the JAX package's
    policy-aware one: under the bf16 policy the JAX adapter takes a bf16
    image to the f32 features it gives for that image in f32, bit for bit,
    and the port's adapter gives f32 features too, equal to them."""
    from basedet_tpu.layers import precision as jprecision

    cfg = CONFIGS["y"]
    port = P.HFBackboneAdapter(cfg, FEATURES)
    sd = randomised(port, 2)
    port.load_state_dict(sd)
    variables = jax_from_state_dict(sd)
    x = jnp.asarray(image(1), jnp.bfloat16)
    want, _ = jax_features(cfg, variables, np.asarray(x.astype(jnp.float32)), False)
    with jprecision.precision_policy(jnp.bfloat16):
        jbf, _ = jax_features(cfg, variables, x, False)
    assert {v.dtype for v in jbf.values()} == {np.dtype(np.float32)}
    for f in FEATURES:
        np.testing.assert_array_equal(jbf[f], want[f], err_msg=f)
    port.eval()
    with torch.no_grad(), precision_policy(torch.bfloat16):
        got = port(torch.from_numpy(np.array(x.astype(jnp.float32))).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert {v.dtype for v in got.values()} == {torch.float32}
    assert_features({k: v.permute(0, 2, 3, 1).numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("family", ["resnet", "regnet"])
def test_load_hf_weights_from_save_pretrained(family, tmp_path):
    """A directory written by ``FlaxResNetModel`` / ``FlaxRegNetModel``
    ``.save_pretrained`` (its random init at seed 0): the port's
    ``load_hf_weights`` gives the adapter's state_dict, whose features in
    eval and train mode are the JAX adapter's on the weights the JAX
    ``load_hf_weights`` returns (for RegNet, flax's own ``msgpack_restore``
    of the file, which that function reads through ``from_pretrained``)."""
    transformers = pytest.importorskip("transformers")
    from basedet_tpu.layers.backbone.hf_adaptor import load_hf_weights as jload

    cfg = CONFIGS["bottleneck" if family == "resnet" else "y"]
    model_cls = transformers.FlaxResNetModel if family == "resnet" else transformers.FlaxRegNetModel
    model = model_cls(hf_pretrained_config(cfg), input_shape=(1, 64, 64, 3), _do_init=False)
    params = jax.jit(model.init_weights, static_argnums=1)(jax.random.PRNGKey(0), (1, 64, 64, 3))
    model.save_pretrained(str(tmp_path), params=params)
    sd = P.load_hf_weights(str(tmp_path))
    port = P.HFBackboneAdapter(P.read_hf_config(str(tmp_path)), FEATURES)
    port.load_state_dict(sd)
    if family == "resnet":  # the JAX function; it takes ~20 s (from_pretrained inits at 224x224)
        tree = jload(str(tmp_path))["hf"]
    else:
        from flax import serialization

        tree = serialization.msgpack_restore((tmp_path / "flax_model.msgpack").read_bytes())
    assert set(tree) == {"params", "batch_stats"}
    variables = {coll: {"hf": leaves} for coll, leaves in tree.items()}
    assert flat(jax.device_get(variables)).keys() == flat(jax_from_state_dict(sd)).keys()
    for k, v in flat(jax.device_get(variables)).items():
        np.testing.assert_array_equal(flat(jax_from_state_dict(sd))[k], v, err_msg=k)
    x = image(2)
    for train in (False, True):
        want, _ = jax_features(cfg, variables, x, train)
        got, _ = port_features(port, x, train)
        assert_features(got, want)


def test_msgpack_decoder_matches_flax():
    """The port's decoder against flax's ``msgpack_restore`` on what
    ``to_bytes`` writes: nested maps, f32/f16/bf16/int arrays, numpy scalars,
    Python ints of every width, floats, bools, None, str and bytes; a chunked
    array raises, naming the marker."""
    import msgpack
    from flax import serialization

    tree = {"a": {"k": np.arange(24, dtype=np.float32).reshape(2, 3, 4), "h": np.ones(3, np.float16),
                  "b": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16)), "i": np.arange(5, dtype=np.int64)},
            "s": np.float32(3.5), "ints": [0, 1, 127, 128, 255, 65536, 2 ** 40, -1, -33, -200, -70000, -2 ** 40],
            "f": 0.25, "t": True, "n": None, "str": "x" * 40, "bin": b"\x00\x01" * 200}
    data = serialization.to_bytes(tree)
    got = P._MsgpackReader(data).read()
    want = serialization.msgpack_restore(data)
    assert got["a"]["b"].dtype == np.float32 and np.array_equal(got["a"]["b"], [1.5, -2.25])
    got["a"]["b"] = want["a"]["b"] = None
    jax.tree_util.tree_map(lambda g, w: np.testing.assert_array_equal(np.asarray(g), np.asarray(w)), got, want)
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}, "chunks": {}}})
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        P._MsgpackReader(chunked).read()


def test_channel_tables_presets_and_auto_convert():
    """The JAX test's channel asserts; the presets are the JAX package's;
    every ``hf_<preset>`` name builds (on the meta device) with the widths
    ``feature_channels`` gives at strides 4-32; regnety_004's second stage
    opens with an SE of 12 (round(48 / 4)) and a (3, 3, 8, 104) grouped
    kernel; ``auto_convert_cfg_to_hf`` writes what the JAX one writes."""
    from basedet_tpu import configs as C
    from basedet_tpu.layers.backbone import hf_adaptor as J

    assert P.get_channel_setting("resnet18") == (128, 256, 512)
    assert P.get_channel_setting("resnet50") == (512, 1024, 2048)
    assert P.get_channel_setting("regnety_016") == (120, 336, 888)
    assert P.get_channel_setting("regnetx_040") == (240, 560, 1360)
    assert P.get_feature_setting("resnet50") == ("res3", "res4", "res5")
    assert (P._RESNET_PRESETS, P._REGNET_PRESETS, P._STAGE_INDEX) == (J._RESNET_PRESETS, J._REGNET_PRESETS,
                                                                       J._STAGE_INDEX)
    for preset in [*P._RESNET_PRESETS, *P._REGNET_PRESETS]:
        assert P.get_channel_setting(preset) == J.get_channel_setting(preset)
        name = "hf_" + preset
        module = make_backbone(name, FEATURES, device="meta")
        out = module(torch.empty(1, 3, 64, 96, device="meta"))
        assert {f: (v.shape[1], 64 // v.shape[2], 96 // v.shape[3]) for f, v in out.items()} == {
            f: (feature_channels(name)[f], 2 ** (i + 2), 2 ** (i + 2)) for i, f in enumerate(FEATURES)}
    block = make_backbone("hf_regnety_004", device="meta").hf.encoder.stages[1].layers[0].layer
    assert block.get_submodule("2.attention.0").weight.shape == (12, 104, 1, 1)
    assert block.get_submodule("1.convolution").weight.permute(2, 3, 1, 0).shape == (3, 3, 8, 104)
    from basedet_tpu_torch import configs as PC

    jcfg, pcfg = C.RetinaNetConfig(), PC.RetinaNetConfig()
    J.auto_convert_cfg_to_hf(jcfg, "regnety_040")
    P.auto_convert_cfg_to_hf(pcfg, "regnety_040")
    assert pcfg.MODEL.BACKBONE.NAME == "hf_regnety_040"
    for node in ("BACKBONE", "FPN"):
        for k in ("NAME", "OUT_FEATURES", "OUT_FEATURE_CHANNELS", "TOP_BLOCK_IN_FEATURE", "TOP_BLOCK_IN_CHANNELS"):
            if k in jcfg.MODEL[node]:
                assert pcfg.MODEL[node][k] == jcfg.MODEL[node][k], (node, k)
    with pytest.raises(ValueError, match="unknown hf backbone"):
        feature_channels("hf_nope")


def test_make_backbone_takes_a_registered_name():
    """A name registered in ``registers.models`` gives the registered object
    as it is, as the JAX branch does, and ``feature_channels`` its
    ``feature_channels``; an unknown name raises."""
    backbone = P.HFBackboneAdapter(CONFIGS["basic"], ("res4", "res5"))
    backbone.feature_channels = {"res4": 48, "res5": 64}
    registers.models.register(backbone, name="my_backbone")
    try:
        assert make_backbone("my_backbone", ("res5",)) is backbone
        assert feature_channels("my_backbone") == {"res4": 48, "res5": 64}
    finally:
        registers.models._map.pop("my_backbone")
    with pytest.raises(ValueError, match="unknown backbone 'my_backbone'"):
        make_backbone("my_backbone")


@pytest.fixture
def tiny_preset(monkeypatch):
    from basedet_tpu.layers.backbone import hf_adaptor as J

    monkeypatch.setitem(J._RESNET_PRESETS, TINY, TINY_PRESET)
    monkeypatch.setitem(P._RESNET_PRESETS, TINY, TINY_PRESET)


def _retina_cfg():
    from basedet_tpu import configs as C
    from basedet_tpu.layers.backbone.hf_adaptor import auto_convert_cfg_to_hf
    from tests.tiny import shrink

    cfg = shrink(C.RetinaNetConfig())
    auto_convert_cfg_to_hf(cfg, TINY)
    cfg.DATA.MAX_INSTANCES = 4
    cfg.MODEL.BATCHSIZE = 2
    return cfg


def test_tiny_retinanet_on_an_hf_backbone_matches_jax(tiny_preset):
    """Tiny RetinaNet on an ``hf_`` backbone (``auto_convert_cfg_to_hf``):
    eval-mode head outputs, detections, then one train pass's losses and BN
    statistics, against the JAX package from the same weights (the class
    biases spread so that detections clear the threshold)."""
    from basedet_tpu.utils import all_register

    all_register()
    cfg = _retina_cfg()
    port = build_model(cfg, "cpu")
    sd = randomised(port.module, 3)
    g = torch.Generator().manual_seed(4)
    sd["head.cls_score.bias"] = sd["head.cls_score.bias"] * 0 - 2.0 + torch.randn(sd["head.cls_score.bias"].shape,
                                                                                   generator=g)
    port.module.load_state_dict(sd)
    variables = jax_from_state_dict(sd)
    jmodel = cfg.build_model()
    batch = DummyLoader(batch_size=2, image_size=(64, 96), max_instances=4).make_batch()

    jout = jax.device_get(jax.jit(jmodel.make_module(train=False).apply)(
        variables, jmodel.pre_process(batch, train=False)["image"]))
    port.eval()
    with torch.no_grad():
        logits, offsets = port.module(port.pre_process(batch)["image"])
    for lv, (lg, of, jl, jo) in enumerate(zip(logits, offsets, *jout)):
        for got, want in ((lg, jl), (of, jo)):
            got = got.permute(0, 2, 3, 1).numpy()
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= OUT_RTOL * np.abs(want).max(), lv
    jdets = jax.device_get(jmodel.inference_jit(variables, batch))
    dets = {k: v.numpy() for k, v in port.inference(batch).items()}
    assert jdets["valid"].sum() > 0 and match_detections(jdets, dets) >= MATCHED

    total, jlosses, jstate = jax.jit(jmodel.get_losses)(variables, batch, jax.random.PRNGKey(0))
    port.train()
    with torch.no_grad():
        ptotal, losses = port.get_losses(batch)
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        assert abs(float(v) - float(jlosses[k])) <= LOSS_RTOL * abs(float(jlosses[k])), k
    stats = flat(jax_from_state_dict(port.module.state_dict())["batch_stats"])
    jstats = flat(jax.device_get(jstate)["batch_stats"])
    assert stats.keys() == jstats.keys() and all(k.startswith("bottom_up/hf/") for k in stats)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k], v, rtol=0, atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("model", ["FasterRCNN", "CenterNet", "DETR"])
def test_detectors_build_and_train_on_an_hf_name(model, tiny_preset):
    """Faster R-CNN (``res2``-``res5`` under P2-P6), CenterNet and DETR
    (``res5``, sized by ``feature_channels``) build on an ``hf_`` name and
    give finite losses whose gradient reaches every parameter: the HF
    backbone trains whole (no ``FREEZE_AT``), and the solvers' frozen-stage
    rule leaves it all in the optimizer."""
    from basedet_tpu_torch import configs as PC
    from basedet_tpu_torch.solver import DetrSolver, DetSolver
    from tests.tiny import shrink

    cfg = shrink(getattr(PC, {"FasterRCNN": "FasterRCNNConfig", "CenterNet": "CenterNetConfig",
                              "DETR": "DETRConfig"}[model])())
    cfg.MODEL.BACKBONE.NAME = "hf_" + TINY
    if model == "FasterRCNN":
        cfg.MODEL.BACKBONE.OUT_FEATURES = list(FEATURES)
    cfg.MODEL.BATCHSIZE = 2
    cfg.DATA.MAX_INSTANCES = 4
    port = build_model(cfg, "cpu")
    port.train()
    draws = {"seed": 0, "step": 0} if getattr(port, "draws_per_step", False) else {}
    total, losses = port.get_losses(DummyLoader(batch_size=2, image_size=(64, 96), max_instances=4).make_batch(),
                                    **draws)
    assert all(math.isfinite(float(v.detach())) for v in losses.values())
    total.backward()
    named = dict(port.module.named_parameters())
    assert any(k.startswith("bottom_up.hf.") for k in named)
    assert [k for k, p in named.items() if p.grad is None or not torch.isfinite(p.grad).all()] == []
    solver = (DetrSolver if model == "DETR" else DetSolver).build(cfg, 1)
    optimized = {id(p) for group in solver.make_optimizer(port.module).param_groups for p in group["params"]}
    assert all(id(p) in optimized for k, p in named.items() if k.startswith("bottom_up."))
