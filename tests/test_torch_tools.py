"""The port's tools against the JAX package's on the CPU: the export
(``BaseNet.dump_static_graph``, ``tools/trace_net.py``), ``analyze_net``,
``dump_cfg``, ``parity_diff`` (with ``layers/common/module_inspector.py``),
``parity_eval --rehearse``, ``profile_net``, and the small modules
``layers/common/module_utils.py``, ``layers/blocks/pool.py`` and
``evaluators/visualize.py``.

Tolerances, and why:
  * an exported and reloaded program runs the eager module's ATen
    operations on the same inputs: equal to it bit for bit, its discrete
    outputs too; tiny YOLOX-S's reloaded head against the JAX module's to
    ``tests/test_torch_yolox.py``'s 1e-4 absolute;
  * parameter counts exactly; the toy's FLOPs exactly (hand-counted);
  * tiny RetinaNet's stages against the JAX dump's at ``parity_diff``'s
    own default, rtol and atol 1e-4;
  * the fused conv against conv + BN to 1e-5 of the output's magnitude (one
    product and sum order against another); ``fuse_conv_bn`` against the
    JAX function to 1e-6 relative; Caffe pooling to the JAX test's 1e-5.
"""
import json
import os
import pickle
import textwrap

import numpy as np
import pytest
import torch

from basedet_tpu_torch import build_model
from basedet_tpu_torch.configs import DETRConfig, FasterRCNNConfig, RetinaNetConfig, YOLOXSConfig
from basedet_tpu_torch.models.base_net import load_static_graph
from basedet_tpu_torch.ops.nms_kernel import nms_keep_plain
from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain
from basedet_tpu_torch.tools import analyze_net, dump_cfg, parity_diff, parity_eval, profile_net, trace_net
from basedet_tpu_torch.utils.dummy import DummyLoader
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAYGROUNDS = sorted(os.listdir(os.path.join(REPO, "basedet_tpu_torch", "playground")))
YOLOX_IMG = 96
HEAD_ATOL = 1e-4


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _assert_same(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# -- export ----------------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def yolox_jax():
    """Tiny YOLOX-S with the JAX test's randomised weights, on both sides:
    (JAX head outputs on one image, the port's weights file, the image)."""
    import jax
    import jax.numpy as jnp

    from basedet_tpu import configs as C
    from basedet_tpu.utils import all_register
    from basedet_tpu_torch.utils.weights import state_dict_from_jax
    from tests.test_torch_yolox import _randomise

    all_register()
    jmodel = shrink(C.YOLOXSConfig()).build_model()
    variables = _randomise(jmodel.init_variables(jax.random.PRNGKey(0), image_size=(YOLOX_IMG, YOLOX_IMG)),
                           np.random.RandomState(0))
    port = build_model(shrink(YOLOXSConfig()), "cpu")
    sd = state_dict_from_jax(variables, port.module.state_dict())
    data = DummyLoader(batch_size=1, image_size=(YOLOX_IMG, YOLOX_IMG)).make_batch()["data"]
    head = jax.device_get(jax.jit(jmodel.make_module(train=False).apply)(variables, jnp.asarray(data)))
    return {"head": head, "sd": sd, "data": data}


def test_trace_net_yolox_reloads_equal_to_eager_and_jax(yolox_jax, tmp_path):
    """``trace_net -w`` loads the weights as det_test does; the reloaded
    program equals the eager module and holds the JAX module's head."""
    weights, out = str(tmp_path / "w.pt"), str(tmp_path / "yolox.pt2")
    torch.save(yolox_jax["sd"], weights)
    config = os.path.join(REPO, "basedet_tpu_torch/playground/yolox_s/config.py")
    trace_net.main(["-f", config, "-w", weights, "--device", "cpu", "--height", str(YOLOX_IMG), "--width",
                    str(YOLOX_IMG), "--out", out, "MODEL.WIDTH_FACTOR", "0.25", "MODEL.DEPTH_FACTOR", "0.33",
                    "GLOBAL.OUTPUT_DIR", str(tmp_path)])
    port = build_model(shrink(YOLOXSConfig()), "cpu")
    port.module.load_state_dict(yolox_jax["sd"])
    image = port.pre_process({"data": yolox_jax["data"], "im_info": np.zeros((1, 5), np.float32)})["image"]
    with torch.no_grad():
        eager = port.module(image)
        got = load_static_graph(out)(image)
    _assert_same(got, eager)
    for ref_l, got_l in zip(yolox_jax["head"], got):
        for r, g in zip(ref_l, got_l):
            np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), r, rtol=0, atol=HEAD_ATOL)


def test_faster_rcnn_export_holds_the_kernels_as_custom_ops(tmp_path):
    """Tiny Faster R-CNN's program calls NMS and RoIAlign as the custom ops
    ``basedet::nms_keep`` and ``basedet::roi_align``; reloaded, it equals
    the eager module, proposal validity included, and reaches each op as
    often as the eager module (on the CPU, their plain versions)."""
    model = build_model(shrink(FasterRCNNConfig()), "cpu", generator=torch.Generator().manual_seed(3))
    program = model.dump_static_graph(str(tmp_path / "frcnn.pt2"), image_size=(128, 192))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("basedet.nms_keep.default") == 1 and targets.count("basedet.roi_align.default") == 1
    batch = DummyLoader(batch_size=1, image_size=(128, 192)).make_batch()
    inputs = model.pre_process(batch)
    args = (inputs["image"], inputs["img_info"])
    reloaded = load_static_graph(str(tmp_path / "frcnn.pt2"))
    calls = []
    for fn in (lambda: model.module(*args), lambda: reloaded(*args)):
        nms_keep_plain.calls = multilevel_roi_align_plain.calls = 0
        with torch.no_grad():
            calls.append((fn(), nms_keep_plain.calls, multilevel_roi_align_plain.calls))
    (eager, *eager_calls), (got, *got_calls) = calls
    assert eager_calls == got_calls == [1, 1]
    _assert_same(got, eager)
    assert got[2].dtype == torch.bool and bool(got[2].any())


# -- analyze ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["YOLOXSConfig", "RetinaNetConfig", "DETRConfig"])
def test_analyze_params_match_the_jax_tool(name):
    """``params_M`` as the JAX tool reports it, and the exact count of the
    JAX model's ``params`` collection, which is what that tool sums. The JAX
    tool cannot analyze DETR (its forward is called without the pixel mask
    and raises); there the count alone is held."""
    import jax

    from basedet_tpu import configs as C
    from basedet_tpu.tools.analyze_net import analyze as janalyze
    from basedet_tpu.utils import all_register

    all_register()
    size = (64, 64)
    jcfg = shrink(getattr(C, name)())
    variables = jcfg.build_model().init_variables(jax.random.PRNGKey(0), image_size=size)
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(variables["params"]))
    got = analyze_net.analyze(shrink({"YOLOXSConfig": YOLOXSConfig, "RetinaNetConfig": RetinaNetConfig,
                                      "DETRConfig": DETRConfig}[name]()), size, "cpu")
    assert got["params"] == n_params and got["params_M"] == round(n_params / 1e6, 3)
    assert got["forward_gflops"] > 0
    if name == "DETRConfig":
        with pytest.raises(TypeError, match="mask"):
            janalyze(jcfg, size)
    else:
        assert got["params_M"] == janalyze(jcfg, size)["params_M"]


def test_flops_of_a_toy_are_counted_by_hand():
    """3x3 conv 3 → 8 on 16x16 (bias uncounted) and a Linear 2048 → 10: two
    operations per multiply-add."""
    toy = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.Flatten(), torch.nn.Linear(8 * 16 * 16, 10))
    want = 2 * (8 * 16 * 16) * (3 * 3 * 3) + 2 * (8 * 16 * 16) * 10
    assert analyze_net.forward_flops(toy, (torch.zeros(1, 3, 16, 16),)) == want


# -- dump_cfg --------------------------------------------------------------------------------------

def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_dump_cfg_round_trip_simple(tmp_path):
    """``tests/configs/test_dump_cfg.py``'s case on the port's configs."""
    from basedet_tpu_torch.tools.misc import import_config

    src = _write(tmp_path, "config.py", """
        from basedet_tpu_torch.configs import RetinaNetConfig

        class Cfg(RetinaNetConfig):
            def __init__(self):
                super().__init__()
                self.merge(dict(MODEL=dict(BATCHSIZE=4),
                                SOLVER=dict(MAX_EPOCH=7, BASIC_LR=float('inf'))))
        """)
    cfg = import_config(src)
    out = str(tmp_path / "dumped.py")
    with open(out, "w") as f:
        f.write(dump_cfg.dump_config_source(cfg))
    dump_cfg.check_round_trip(cfg, out)
    text = open(out).read()
    assert "dict(" in text and "float('inf')" in text and "basedet_tpu_torch.configs" in text
    new_cfg = import_config(out)
    assert new_cfg.MODEL.BATCHSIZE == 4 and new_cfg.SOLVER.MAX_EPOCH == 7


def test_dump_cfg_methods_carried_over(tmp_path):
    from basedet_tpu_torch.tools.misc import import_config

    src = _write(tmp_path, "config.py", """
        from basedet_tpu_torch.configs import RetinaNetConfig

        class Cfg(RetinaNetConfig):
            def __init__(self):
                super().__init__()
                self.MODEL.BATCHSIZE = 3

            def custom_helper(self):
                return self.MODEL.BATCHSIZE * 10
        """)
    cfg = import_config(src)
    out = str(tmp_path / "dumped.py")
    with open(out, "w") as f:
        f.write(dump_cfg.dump_config_source(cfg))
    assert import_config(out).custom_helper() == 30


@pytest.mark.parametrize("name", PLAYGROUNDS)
def test_dump_cfg_round_trips_each_port_config_as_the_jax_tool_dumps_it(name, tmp_path):
    """``dump_cfg`` on each port config round-trips, and the dumped config
    equals the JAX tool's dump of the JAX package's config of that name."""
    from basedet_tpu.tools import dump_cfg as jdump
    from basedet_tpu.tools.misc import import_config as jimport
    from basedet_tpu_torch.tools.misc import import_config

    out = dump_cfg.main(["-f", os.path.join(REPO, "basedet_tpu_torch", "playground", name, "config.py"),
                         "-o", str(tmp_path / "port.py")])
    jout = str(tmp_path / "jax.py")
    with open(jout, "w") as f:
        f.write(jdump.dump_config_source(jimport(os.path.join(REPO, "playground", name, "config.py"))))
    assert import_config(out).to_dict() == jimport(jout).to_dict()


# -- parity_diff -----------------------------------------------------------------------------------

def _parity_cfg(cls):
    cfg = cls()
    cfg.MODEL.BACKBONE.NAME = "resnet18"
    cfg.DATA.NUM_CLASSES = 3
    return cfg


@pytest.fixture(scope="module")
def tiny_dump():
    """``tests/tools/test_parity_diff.py``'s RetinaNet (ResNet-18, 3 classes,
    64×64): the port's dump, and the JAX tool's on the same weights and
    pixels."""
    import jax

    from basedet_tpu import configs as C
    from basedet_tpu.tools.parity_diff import dump_activations as jdump
    from basedet_tpu.utils import all_register
    from basedet_tpu_torch.utils.weights import jax_from_state_dict

    model = build_model(_parity_cfg(RetinaNetConfig), "cpu")
    img = np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3)).astype(np.float32)
    acts = parity_diff.dump_activations(model, img)
    all_register()
    jmodel = _parity_cfg(C.RetinaNetConfig).build_model()
    variables = jax_from_state_dict(model.module.state_dict())
    ref = {k: np.asarray(v) for k, v in jdump(jmodel, variables, img).items()}
    return {"ours": acts, "jax": ref}


def test_port_dump_diffs_clean_against_the_jax_dump(tiny_dump):
    rows, ok = parity_diff.diff_dumps(tiny_dump["ours"], tiny_dump["jax"], rtol=1e-4, atol=1e-4)
    assert ok and rows and all(r["status"] == "OK" for r in rows), [r for r in rows if r["status"] != "OK"]
    assert len(rows) == len(tiny_dump["jax"]) == len(tiny_dump["ours"])


def test_dump_has_canonical_seams(tiny_dump):
    keys = set(tiny_dump["ours"])
    assert {"res3", "res4", "res5"} <= keys
    assert {"p3", "p4", "p5", "p6", "p7"} <= keys
    assert {"head.0.0", "head.1.4", "head/cls_score", "output.0.0"} <= keys
    assert tiny_dump["ours"]["res3"].shape[3] == 128  # NHWC


def test_self_diff_clean(tiny_dump):
    ours = tiny_dump["ours"]
    rows, ok = parity_diff.diff_dumps(ours, dict(ours))
    assert ok and all(r["status"] == "OK" and r["max_abs"] == 0.0 for r in rows)


def test_perturbed_stage_flagged(tiny_dump):
    ours = tiny_dump["ours"]
    ref = {k: v.copy() for k, v in ours.items()}
    ref["res4"] = ref["res4"] + 0.01
    order = ["res3", "res4", "res5"]
    rows, ok = parity_diff.diff_dumps(ours, ref, order=order)
    bad = [r for r in rows if r["status"] == "DIVERGED"]
    assert not ok and [r["stage"] for r in bad] == ["res4"]
    assert bad[0]["max_abs"] == pytest.approx(0.01, rel=1e-3)
    assert [r["stage"] for r in rows[:3]] == order


def test_nchw_reference_auto_transposed(tiny_dump):
    ours = tiny_dump["ours"]
    ref = {k: np.transpose(v, (0, 3, 1, 2)) if v.ndim == 4 else v for k, v in ours.items()}
    assert parity_diff.diff_dumps(ours, ref)[1]


def test_one_sided_keys_reported(tiny_dump):
    ref = dict(tiny_dump["ours"])
    ref["ref_extra_seam"] = np.zeros((2, 2), np.float32)
    ours = dict(tiny_dump["ours"])
    del ours["res3"]
    rows, ok = parity_diff.diff_dumps(ours, ref)
    statuses = {r["stage"]: r["status"] for r in rows}
    assert statuses["ref_extra_seam"] == "REF-ONLY" and statuses["res3"] == "REF-ONLY" and ok


def test_canonical_name():
    assert parity_diff.canonical_name("backbone/bottom_up/layer1_0/__call__") == "layer1_0"
    assert parity_diff.canonical_name("bottom_up/layer1_0/FrozenBatchNorm_0") == "layer1_0/frozenbatchnorm_0"
    assert parity_diff.canonical_name("head/cls_score/__call__") == "head/cls_score"
    assert parity_diff.canonical_name("__call__") == parity_diff.canonical_name("") == "output"


def test_container_flatten_nested():
    flat = parity_diff._flatten_containers({
        "bottom_up/__call__": {"res2": torch.ones((1, 2, 2, 3))},
        "fpn/__call__": [np.zeros((1, 2)), np.ones((1, 2))],
    })
    assert set(flat) == {"res2", "fpn.0", "fpn.1"} and isinstance(flat["res2"], np.ndarray)


def test_diff_cli_warns_on_same_device(tmp_path, capsys):
    payload = {"activations": {"res3": np.ones((1, 2, 2, 3), np.float32)},
               "input": np.zeros((1, 4, 4, 3), np.float32),
               "meta": {"backend": "torch", "device": "NVIDIA H100 80GB HBM3"}}
    a, b = tmp_path / "a.pkl", tmp_path / "b.pkl"
    for path in (a, b):
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    assert parity_diff.main(["diff", str(a), str(b)]) == 0
    out = capsys.readouterr().out
    assert "SAME device" in out and "PARITY OK" in out


def test_dump_cli_records_the_device(tmp_path):
    out = tmp_path / "dump.pkl"
    parity_diff.main(["dump", "--size", "64", "--device", "cpu", "-o", str(out),
                      "MODEL.BACKBONE.NAME", "resnet18", "DATA.NUM_CLASSES", "3"])
    with open(out, "rb") as f:
        payload = pickle.load(f)
    assert payload["meta"]["backend"] == "torch" and payload["meta"]["device"] == "cpu"
    assert payload["activations"] and payload["input"].shape == (1, 64, 64, 3)


# -- parity_eval, profile_net ----------------------------------------------------------------------

def test_parity_eval_rehearsal_loads_strictly(tmp_path, capsys):
    results, stats = parity_eval.main(["--rehearse", "--rehearse-images", "2", "--device", "cpu",
                                       "--out-dir", str(tmp_path)])
    assert stats["matched"] > 300 and not stats["missing"] and not stats["unused"]
    out = capsys.readouterr().out
    assert "retinanet" in out and "[MODEL_ZOO.md:26]" in out and "[rehearse] OK" in out
    assert json.loads([line for line in out.splitlines() if line.startswith("{")][0])["AP"] == results["AP"]
    assert len(os.listdir(tmp_path / "val_images")) == 2


def test_profile_net_writes_a_chrome_trace(tmp_path):
    path = profile_net.main(["-f", os.path.join(REPO, "basedet_tpu_torch/playground/retinanet_r50_1x/config.py"),
                             "--device", "cpu", "--iters", "1", "--trace-dir", str(tmp_path),
                             "MODEL.BACKBONE.NAME", "resnet10", "MODEL.FPN.OUT_CHANNELS", "32",
                             "MODEL.HEAD.NUM_CONVS", "1", "MODEL.BATCHSIZE", "1", "DATA.DUMMY_IMAGE_SIZE", "(64,64)",
                             "GLOBAL.OUTPUT_DIR", str(tmp_path)])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)


# -- module_utils, pool, visualize -----------------------------------------------------------------

def test_fuse_conv_bn_matches_jax_and_conv_plus_bn():
    from basedet_tpu.layers.common.module_utils import fuse_conv_bn as jfuse
    from basedet_tpu_torch.layers.common.module_utils import fuse_conv_bn, rename_tree_key

    g = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(4, 6, 3, padding=1)
    bn = torch.nn.BatchNorm2d(6, eps=1e-5).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(6, generator=g))
        bn.running_var.copy_(torch.rand(6, generator=g) + 0.5)
    w, b = fuse_conv_bn(conv.weight.detach(), conv.bias.detach(), bn.weight.detach(), bn.bias.detach(),
                        bn.running_mean, bn.running_var, eps=1e-5)
    jw, jb = jfuse(conv.weight.detach().numpy().transpose(2, 3, 1, 0), conv.bias.detach().numpy(),
                   bn.weight.detach().numpy(), bn.bias.detach().numpy(), bn.running_mean.numpy(),
                   bn.running_var.numpy(), eps=1e-5)
    np.testing.assert_allclose(w.numpy().transpose(2, 3, 1, 0), jw, rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), jb, rtol=1e-6, atol=1e-7)
    x = torch.randn(2, 4, 9, 9, generator=g)
    with torch.no_grad():
        want = bn(conv(x))
    got = torch.nn.functional.conv2d(x, w, b, padding=1)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    renamed = rename_tree_key({"bottom_up.bn.weight": 1, "bn.bias": 2, "bnx.bn": 3}, "bn", "norm")
    assert renamed == {"bottom_up.norm.weight": 1, "norm.bias": 2, "bnx.norm": 3}


@pytest.mark.parametrize("hwksp", [(7, 7, 3, 2, 0), (8, 9, 3, 2, 1), (5, 5, 2, 2, 1), (10, 11, 3, 3, 1)])
@pytest.mark.parametrize("mode", ["max", "average"])
def test_caffe_pooling_matches_jax(hwksp, mode):
    """``tests/layers/test_caffe_pool.py``'s cases, NCHW against its NHWC."""
    import jax.numpy as jnp

    from basedet_tpu.layers import caffe_pooling_2d as jpool
    from basedet_tpu_torch.layers.blocks.pool import caffe_pooling_2d

    H, W, k, s, p = hwksp
    x = np.random.RandomState(0).randn(2, H, W, 4).astype(np.float32)
    want = np.asarray(jpool(jnp.asarray(x), k, s, p, mode))
    got = caffe_pooling_2d(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), k, s, p, mode).numpy()
    assert got.shape == (2, 4, *want.shape[1:3])
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-5)
    if (H, k, s, p) == (8, 3, 2, 1) or (H, k, s, p) == (7, 3, 2, 0):
        assert caffe_pooling_2d(torch.ones(1, 1, 8, 8), 3, 2, 0, mode).shape[2:] == (4, 4)  # ceil, not floor


def test_visualize_draws_the_outline_in_its_colour():
    from basedet_tpu_torch.evaluators.visualize import visualize_detection

    img = np.full((64, 64, 3), 7, np.uint8)
    dets = np.array([[10, 20, 40, 50, 0.9, 1], [44, 4, 60, 16, 0.2, 0]], np.float32)
    out = visualize_detection(img, dets, class_names=["a", "b"], color=(0, 0, 255))
    assert out.shape == img.shape and out.dtype == np.uint8 and (img == 7).all()
    for y, x in ((35, 10), (35, 40), (20, 25), (50, 25), (35, 11)):
        assert tuple(out[y, x]) == (0, 0, 255), (y, x)
    assert tuple(out[35, 25]) == (7, 7, 7)  # inside the box: untouched
    assert (out[4:17, 44:61] == 7).all()  # below the threshold: not drawn
