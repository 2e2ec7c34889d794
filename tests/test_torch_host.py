"""The port's own copies of the JAX package's host code, held to their
originals: config trees (with the same CLI overrides), the synthetic
loader's batches, the meters, and COCO mAP. The port keeps these copies so
that it never imports ``basedet_tpu``; these tests keep them from drifting.
"""
import numpy as np
import pytest

from basedet_tpu import configs as jax_configs
from basedet_tpu.evaluators.coco_metrics import evaluate_coco_map as jax_map
from basedet_tpu.tools.misc import import_config as jax_import_config
from basedet_tpu.utils.dummy import DummyLoader as JaxDummyLoader
from basedet_tpu.utils.meters import MeterBuffer as JaxMeterBuffer
from basedet_tpu_torch import configs as port_configs
from basedet_tpu_torch.evaluators import evaluate_coco_map
from basedet_tpu_torch.tools import import_config
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.meters import MeterBuffer
from basedet_tpu_torch.utils.registry import Registry

OVERRIDES = ["SOLVER.BASIC_LR", "0.02", "MODEL.BACKBONE.NAME", "resnet18",
             "DATA.DUMMY_IMAGE_SIZE", "(800,1333)", "TEST.CLS_THRESHOLD", "0.0",
             "MODEL.ANCHOR.RATIOS", "[[1.0]]", "GLOBAL.OUTPUT_DIR", "out/x", "NEW.KEY", "False"]


@pytest.mark.parametrize("name", ["YOLOXSConfig", "YOLOXTinyConfig", "YOLOXNanoConfig",
                                  "FasterRCNNConfig", "CenterNetConfig"])
def test_config_trees_equal_the_jax_package(name):
    port, ref = getattr(port_configs, name)(), getattr(jax_configs, name)()
    assert port.to_dict() == ref.to_dict()
    assert port.merge(OVERRIDES).to_dict() == ref.merge(OVERRIDES).to_dict()
    assert port.MODEL.BACKBONE.NAME == "resnet18" and port.NEW.KEY is False
    assert port.DATA.DUMMY_IMAGE_SIZE == (800, 1333)


@pytest.mark.parametrize("model", ["yolox_s", "faster_rcnn_r50_1x", "centernet_r50"])
def test_playground_configs_equal_the_jax_package(model):
    port = import_config(f"basedet_tpu_torch/playground/{model}/config.py")
    ref = jax_import_config(f"playground/{model}/config.py")
    assert port.to_dict() == ref.to_dict()
    assert type(port).__mro__[1].__module__.startswith("basedet_tpu_torch.configs")


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=2, image_size=(96, 128), max_instances=6),
    dict(batch_size=1, image_size=(64, 64), max_instances=100, num_classes=3, seed=7),
])
def test_dummy_loader_batches_are_byte_equal(kwargs):
    port, ref = DummyLoader(length=3, **kwargs), JaxDummyLoader(length=3, **kwargs)
    assert len(port) == len(ref) == 3
    for got, want in zip(port, ref):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_meters_equal_the_jax_package():
    port, ref = MeterBuffer(window_size=3), JaxMeterBuffer(window_size=3)
    for i, v in enumerate([1.0, 4.0, 2.0, 8.0, 5.0]):
        port.update({"loss": v}, lr=0.1 * i)
        ref.update({"loss": v}, lr=0.1 * i)
    for k in ("loss", "lr"):
        for attr in ("latest", "avg", "median", "global_avg"):
            assert getattr(port[k], attr) == getattr(ref[k], attr), (k, attr)


def test_registry_refuses_a_second_name():
    reg = Registry("things")
    reg.register(int)
    reg.register(int)  # the same object again is allowed
    with pytest.raises(KeyError, match="already registered"):
        reg.register(float, name="int")
    with pytest.raises(KeyError, match="known"):
        reg.get("missing")
    assert "int" in reg and reg.get("int") is int


def _synthetic_coco(seed):
    """Ground truth and jittered, partly wrong detections on 6 images x 3
    classes, crowd boxes and every area range included."""
    rng = np.random.RandomState(seed)
    gts, dts = {}, {}
    for img in range(6):
        for cat in (1, 2, 3):
            n = rng.randint(0, 5)
            xy = rng.uniform(0, 400, (n, 2))
            wh = rng.uniform(10, 200, (n, 2))
            gts[(img, cat)] = [dict(bbox=[*p, *s], area=float(s[0] * s[1]), iscrowd=int(rng.rand() < 0.1))
                               for p, s in zip(xy, wh)]
            dets = [dict(bbox=list(np.r_[p + rng.normal(0, 4, 2), s * rng.uniform(0.8, 1.2, 2)]),
                         score=float(rng.rand())) for p, s in zip(xy, wh) if rng.rand() < 0.8]
            dets += [dict(bbox=[*rng.uniform(0, 400, 2), *rng.uniform(5, 100, 2)],
                          score=float(rng.rand())) for _ in range(rng.randint(0, 3))]
            if dets:
                dts[(img, cat)] = dets
    return gts, dts, list(range(6)), [1, 2, 3]


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_map_equals_the_jax_package(seed):
    gts, dts, imgs, cats = _synthetic_coco(seed)
    got, want = evaluate_coco_map(gts, dts, imgs, cats), jax_map(gts, dts, imgs, cats)
    assert got.keys() == want.keys() and len(got) == 12
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert 0.0 < got["AP"] < 1.0
