"""basedet_tpu_torch runs where JAX, flax, optax and cv2 are absent, as on
the GPU machine, and never imports the JAX package ``basedet_tpu``, not even
its host code: its det_test and its det_train (YOLOX-S, in f32 and under the
bf16 policy with the fused CSP chain, tiny Faster R-CNN and tiny CenterNet)
run in a subprocess that cannot import any of them. ``"basedet_tpu_torch"``'s
first dotted part is not ``"basedet_tpu"``, so the port itself is not
blocked."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path


REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("basedet_tpu", "jax", "jaxlib", "flax", "optax", "cv2")
YOLOX = "basedet_tpu_torch/playground/yolox_s/config.py"
FRCNN = "basedet_tpu_torch/playground/faster_rcnn_r50_1x/config.py"
CENTERNET = "basedet_tpu_torch/playground/centernet_r50/config.py"
# tiny CenterNet as tests/tiny.py shrinks it, on 128x128 images
_TINY_CENTERNET = ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.HEAD.DECONV_CHANNEL", "[512,64,32,16]",
                   "MODEL.HEAD.IN_CHANNELS", "16", "DATA.DUMMY_IMAGE_SIZE", "(128,128)"]

_BLOCK = r"""
import importlib, json, pkgutil, sys

BLOCKED = {blocked!r}

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)

sys.meta_path.insert(0, _Block())
"""

_SCRIPT = _BLOCK + r"""
import torch
import basedet_tpu_torch
for info in pkgutil.walk_packages(basedet_tpu_torch.__path__, "basedet_tpu_torch."):
    importlib.import_module(info.name)

from basedet_tpu_torch import build_model
from basedet_tpu_torch.tools import det_test, import_config

opts = {opts!r} + ["GLOBAL.OUTPUT_DIR", {out!r}]
cfg = import_config({config!r})
cfg.merge(opts)
torch.save(build_model(cfg, "cpu").module.state_dict(), {out!r} + "/w.pt")
results = det_test.main(["-f", {config!r}, "-w", {out!r} + "/w.pt", "--device", "cpu", *opts])
print(json.dumps({{"results": results, "leaked": sorted(m for m in sys.modules
                                                       if m.split(".")[0] in BLOCKED)}}))
"""


_TRAIN_SCRIPT = _BLOCK + r"""
from basedet_tpu_torch.tools import det_train

opts = {opts!r} + ["MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "8", "DATA.TRAIN.name", "dummy",
                   "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1",
                   "GLOBAL.OUTPUT_DIR", {out!r}, "GLOBAL.CKPT_SAVE_DIR", {out!r} + "/ckpt"]
trainer = det_train.main(["-f", {config!r}, "--device", "cpu", *{flags!r}, *opts])
print(json.dumps({{"steps": trainer.state.step,
                   "loss": trainer.meters["total_loss"].latest,
                   "leaked": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)}}))
"""


def _run_blocked(script):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


_TEST_OPTS = {
    "yolox_s": (YOLOX, ["MODEL.WIDTH_FACTOR", "0.25", "DATA.TEST.name", "dummy",
                        "DATA.DUMMY_IMAGE_SIZE", "(96,96)"]),
    # tiny Faster R-CNN as tests/tiny.py shrinks it; threshold 0 so that the
    # untrained head's ~1/81 class scores give detections
    "faster_rcnn": (FRCNN, ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.FPN.OUT_CHANNELS", "64",
                            "MODEL.RPN.TEST_PREV_NMS_TOPK", "200", "MODEL.RPN.TEST_POST_NMS_TOPK",
                            "100", "TEST.CLS_THRESHOLD", "0.0", "DATA.TEST.name", "dummy",
                            "DATA.DUMMY_IMAGE_SIZE", "(128,192)"]),
    "centernet": (CENTERNET, [*_TINY_CENTERNET, "DATA.TEST.name", "dummy"]),
}


def _det_test_blocked(tmp_path, model):
    config, opts = _TEST_OPTS[model]
    out = _run_blocked(_SCRIPT.format(blocked=BLOCKED, out=str(tmp_path), config=config, opts=opts))
    assert out["leaked"] == []
    assert out["results"]["num_detections"] > 0
    records = json.loads((tmp_path / "predict_coco.json").read_text())
    assert len(records) == out["results"]["num_detections"]
    assert {r["image_id"] for r in records} == set(range(8))


def test_det_test_runs_without_jax(tmp_path):
    _det_test_blocked(tmp_path, "yolox_s")


def test_faster_rcnn_det_test_runs_without_jax(tmp_path):
    _det_test_blocked(tmp_path, "faster_rcnn")


def test_centernet_det_test_runs_without_jax(tmp_path):
    _det_test_blocked(tmp_path, "centernet")


_TRAIN_OPTS = {
    "yolox_s": (YOLOX, ["MODEL.WIDTH_FACTOR", "0.25", "AUG.TRAIN_SETTING.INPUT_SIZE", "(64,64)",
                        "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(2,3)"]),
    "faster_rcnn": (FRCNN, ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.FPN.OUT_CHANNELS", "64",
                            "MODEL.RPN.TRAIN_PREV_NMS_TOPK", "200", "MODEL.RPN.TRAIN_POST_NMS_TOPK",
                            "100", "MODEL.RCNN.NUM_ROIS", "64", "DATA.DUMMY_IMAGE_SIZE", "(128,192)"]),
    "centernet": (CENTERNET, _TINY_CENTERNET),
}


def _det_train_blocked(tmp_path, model, flags=(), extra=()):
    config, opts = _TRAIN_OPTS[model]
    out = _run_blocked(_TRAIN_SCRIPT.format(blocked=BLOCKED, out=str(tmp_path), config=config,
                                            opts=[*opts, *extra], flags=list(flags)))
    assert out["leaked"] == []
    assert out["steps"] == 2 and out["loss"] > 0
    assert (tmp_path / "ckpt" / "dumped_model.pt").exists()


def test_det_train_runs_without_jax(tmp_path):
    _det_train_blocked(tmp_path, "yolox_s")


def test_faster_rcnn_det_train_runs_without_jax(tmp_path):
    _det_train_blocked(tmp_path, "faster_rcnn")


def test_centernet_det_train_runs_without_jax(tmp_path):
    _det_train_blocked(tmp_path, "centernet")


def test_det_train_amp_fused_runs_without_jax(tmp_path):
    """The bf16 policy with the fused CSP chain (its plain versions here)."""
    _det_train_blocked(tmp_path, "yolox_s", flags=["--amp"], extra=["TRAINER.AMP.FUSED_BN", "True"])


def test_faster_rcnn_refuses_amp(tmp_path):
    """``--amp`` is ported for YOLOX only: Faster R-CNN's ResNet, FPN, RPN and
    RoIAlign kernels have no bf16 path, and det_train says so by model name."""
    import pytest

    from basedet_tpu_torch.tools import det_train

    config, opts = _TRAIN_OPTS["faster_rcnn"]
    opts = [*opts, "MODEL.BATCHSIZE", "2", "DATA.TRAIN.name", "dummy", "GLOBAL.OUTPUT_DIR", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="FasterRCNN"):
        det_train.main(["-f", config, "--device", "cpu", "--amp", *opts])


def test_port_sources_never_import_jax():
    """No file of the port (its configs included) and not chip_smoke.py
    imports JAX or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(basedet_tpu|jax|jaxlib|flax|optax|cv2)\b", re.M)
    sources = [*(REPO / "basedet_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("from basedet_tpu.utils import logger")
    assert not pattern.search("from basedet_tpu_torch.utils import logger")
