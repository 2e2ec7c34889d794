"""basedet_tpu_torch runs where JAX, flax, optax and cv2 are absent, as on
the GPU machine, and never imports the JAX package ``basedet_tpu``, not even
its host code: its det_test and its det_train (YOLOX-S, in f32 and under the
bf16 policy with the fused CSP chain, tiny Faster R-CNN (also with
``--amp --remat``), tiny CenterNet and
tiny RetinaNet, tiny ATSS, tiny YOLOv3 and tiny DETR, and YOLOX-S on a
synthetic PNG set through the data slice), and its tools (trace_net,
analyze_net and dump_cfg on tiny YOLOX-S, parity_eval --rehearse)
run in a subprocess that cannot import any of them, nor Pillow, which only
JPEG needs. ``"basedet_tpu_torch"``'s
first dotted part is not ``"basedet_tpu"``, so the port itself is not
blocked."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest


REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("basedet_tpu", "jax", "jaxlib", "flax", "optax", "cv2", "PIL")
YOLOX = "basedet_tpu_torch/playground/yolox_s/config.py"
FRCNN = "basedet_tpu_torch/playground/faster_rcnn_r50_1x/config.py"
CENTERNET = "basedet_tpu_torch/playground/centernet_r50/config.py"
RETINANET = "basedet_tpu_torch/playground/retinanet_r50_1x/config.py"
ATSS = "basedet_tpu_torch/playground/atss_r50_1x/config.py"
YOLOV3 = "basedet_tpu_torch/playground/yolov3_darknet53/config.py"
DETR = "basedet_tpu_torch/playground/detr_r50_150e/config.py"
# tiny YOLOv3: Darknet-21 at width 8 (the port's width knob), on 128x192 images
_TINY_YOLOV3 = ["MODEL.BACKBONE.NAME", "darknet21", "MODEL.BACKBONE.OUT_CHANNELS", "8",
                "DATA.DUMMY_IMAGE_SIZE", "(128,192)"]
# tiny DETR as tests/tiny.py shrinks it (resnet10, 1 + 1 layers, 16 queries), on 128x192 images
_TINY_DETR = ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.TRANSFORMER.NUM_ENCODERS", "1",
              "MODEL.TRANSFORMER.NUM_DECODERS", "1", "MODEL.NUM_QUERIES", "16", "DATA.DUMMY_IMAGE_SIZE", "(128,192)"]
# tiny RetinaNet as tests/tiny.py shrinks it (one conv per subnet), on 128x192 images
_TINY_RETINANET = ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.FPN.OUT_CHANNELS", "64", "MODEL.HEAD.NUM_CONVS", "1",
                   "DATA.DUMMY_IMAGE_SIZE", "(128,192)"]
# tiny ATSS as tests/tiny.py shrinks it, on 128x192 images
_TINY_ATSS = ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.FPN.OUT_CHANNELS", "64", "MODEL.HEAD.NUM_CONVS", "1",
              "DATA.DUMMY_IMAGE_SIZE", "(128,192)"]
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
                   "DATA.TEST.name", "dummy",
                   "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1",
                   "GLOBAL.OUTPUT_DIR", {out!r}, "GLOBAL.CKPT_SAVE_DIR", {out!r} + "/ckpt"]
trainer = det_train.main(["-f", {config!r}, "--device", "cpu", *{flags!r}, *opts])
print(json.dumps({{"steps": trainer.state.step,
                   "loss": trainer.meters["total_loss"].latest,
                   "leaked": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)}}))
"""


_DATA_SCRIPT = _BLOCK + r"""
from basedet_tpu_torch.data import register_dataset
from basedet_tpu_torch.tools import det_train
from basedet_tpu_torch.tools.sanity_e2e import make_synthetic_coco

train, val = make_synthetic_coco({out!r}, n_train=8, n_val=4, size=64)
register_dataset("blocked_train", *train)
register_dataset("blocked_val", *val)
opts = ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.BATCHSIZE", "2", "DATA.NUM_CLASSES", "3", "DATA.MAX_INSTANCES", "8",
        "DATA.TRAIN.name", "blocked_train", "DATA.TEST.name", "blocked_val", "DATA.NUM_WORKERS", "2",
        "AUG.TRAIN_SETTING.INPUT_SIZE", "(64,64)", "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(2,2)",
        "AUG.TRAIN_SETTING.NO_AUG_EPOCH", "1", "TEST.IMG_MIN_SIZE", "64", "TEST.IMG_MAX_SIZE", "64",
        "SOLVER.MAX_EPOCH", "2", "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1",
        "GLOBAL.OUTPUT_DIR", {out!r}, "GLOBAL.CKPT_SAVE_DIR", {out!r} + "/ckpt"]
trainer = det_train.main(["-f", {config!r}, "--device", "cpu", *opts])
print(json.dumps({{"steps": trainer.state.step, "forks": trainer.dataloader.forks,
                   "eval": sorted(trainer.eval_results), "AP": trainer.eval_results["EMA"]["AP"],
                   "leaked": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)}}))
"""


_TRAIN_TEST_SCRIPT = _TRAIN_SCRIPT + r"""
from basedet_tpu_torch.tools import det_test

results = det_test.main(["-f", {config!r}, "-w", {out!r} + "/ckpt/dumped_model.pt", "--device", "cpu", *opts,
                         "TEST.CLS_THRESHOLD", "0.0"])
print(json.dumps({{"results": results, "leaked": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)}}))
"""


_TOOLS_SCRIPT = _BLOCK + r"""
from basedet_tpu_torch.models.base_net import load_static_graph
from basedet_tpu_torch.tools import analyze_net, dump_cfg, parity_eval, trace_net

opts = ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.DEPTH_FACTOR", "0.33", "GLOBAL.OUTPUT_DIR", {out!r}]
size = ["--height", "64", "--width", "64"]
trace_net.main(["-f", {config!r}, "--device", "cpu", *size, "--out", {out!r} + "/m.pt2", *opts])
import torch

outputs = load_static_graph({out!r} + "/m.pt2")(torch.zeros(1, 3, 64, 64))
stats = analyze_net.main(["-f", {config!r}, "--device", "cpu", *size, *opts])
dumped = dump_cfg.main(["-f", {config!r}, "-o", {out!r} + "/dumped.py"])
_, rehearsal = parity_eval.main(["--rehearse", "--rehearse-images", "2", "--device", "cpu",
                                 "--out-dir", {out!r} + "/parity"])
print(json.dumps({{"levels": len(outputs), "params": stats["params"], "dumped": dumped,
                   "missing": len(rehearsal["missing"]), "unused": len(rehearsal["unused"]),
                   "leaked": sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)}}))
"""


# one intra-op thread a subprocess: tiny models' small ops otherwise wait on
# the threads of the other test workers
_ENV = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def _run_blocked(script):
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=_ENV,
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
    # threshold 0: at the prior bias every class score is ~0.01, under the 0.05 default
    "retinanet": (RETINANET, [*_TINY_RETINANET, "TEST.CLS_THRESHOLD", "0.0", "DATA.TEST.name", "dummy"]),
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


def test_retinanet_det_test_runs_without_jax(tmp_path):
    _det_test_blocked(tmp_path, "retinanet")


_TRAIN_OPTS = {
    "yolox_s": (YOLOX, ["MODEL.WIDTH_FACTOR", "0.25", "AUG.TRAIN_SETTING.INPUT_SIZE", "(64,64)",
                        "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(2,3)"]),
    "faster_rcnn": (FRCNN, ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.FPN.OUT_CHANNELS", "64",
                            "MODEL.RPN.TRAIN_PREV_NMS_TOPK", "200", "MODEL.RPN.TRAIN_POST_NMS_TOPK",
                            "100", "MODEL.RCNN.NUM_ROIS", "64", "DATA.DUMMY_IMAGE_SIZE", "(128,192)"]),
    "centernet": (CENTERNET, _TINY_CENTERNET),
    "retinanet": (RETINANET, _TINY_RETINANET),
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


def test_retinanet_det_train_runs_without_jax(tmp_path):
    _det_train_blocked(tmp_path, "retinanet")


def _train_test_blocked(tmp_path, config, opts):
    """det_train 2 steps, then det_test on the dumped weights, in one blocked
    process."""
    script = _TRAIN_TEST_SCRIPT.format(blocked=BLOCKED, out=str(tmp_path), config=config, opts=opts, flags=[])
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=_ENV, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    train, test = (json.loads(line) for line in proc.stdout.strip().splitlines()[-2:])
    assert train["leaked"] == [] == test["leaked"]
    assert train["steps"] == 2 and train["loss"] > 0
    assert test["results"]["num_detections"] > 0
    assert {r["image_id"] for r in json.loads((tmp_path / "predict_coco.json").read_text())} == set(range(8))


def test_atss_det_train_and_det_test_run_without_jax(tmp_path):
    """Tiny ATSS trains 2 steps, then det_test serves its dumped weights, in
    one blocked process (its IoU through kernel #10's wrapper, the plain
    version here)."""
    _train_test_blocked(tmp_path, ATSS, _TINY_ATSS)


@pytest.mark.parametrize("model", ["yolov3", "detr"])
def test_last_families_det_train_and_det_test_run_without_jax(tmp_path, model):
    """Tiny YOLOv3 (SGD, its IoUs through kernel #10's wrapper, NMS through
    the NMS kernel's) and tiny DETR (DetrSolver's AdamW, the auction, no
    kernel) train 2 steps and serve their dumped weights, blocked."""
    _train_test_blocked(tmp_path, *{"yolov3": (YOLOV3, _TINY_YOLOV3), "detr": (DETR, _TINY_DETR)}[model])


def test_det_train_on_synthetic_pngs_runs_without_jax_cv2_or_pil(tmp_path):
    """The data slice on the card's terms: the synthetic set written and read
    as PNG by the port, mosaic, mixup and the other augmentations in two
    DataLoader workers, the no-aug switch, and EvalHook on the val split, with
    cv2 and Pillow blocked as well as JAX."""
    out = _run_blocked(_DATA_SCRIPT.format(blocked=BLOCKED, out=str(tmp_path), config=YOLOX))
    assert out["leaked"] == []
    assert out["steps"] == 4 and out["forks"] == 2
    assert out["eval"] == ["EMA", "model"] and -1 <= out["AP"] <= 1


def test_det_train_amp_fused_runs_without_jax(tmp_path):
    """The bf16 policy with the fused CSP chain (its plain versions here)."""
    _det_train_blocked(tmp_path, "yolox_s", flags=["--amp"], extra=["TRAINER.AMP.FUSED_BN", "True"])


def test_faster_rcnn_det_train_amp_remat_runs_without_jax(tmp_path):
    """``det_train --amp --remat`` on tiny Faster R-CNN, blocked: its ResNet,
    FPN, RPN, bf16 RoIAlign (the plain bf16 versions here) and box head
    under the bf16 policy, the network recomputed segment by segment."""
    _det_train_blocked(tmp_path, "faster_rcnn", flags=["--amp", "--remat"])


def test_tools_run_without_jax(tmp_path):
    """trace_net (and the reload of its program), analyze_net and dump_cfg on
    tiny YOLOX-S, and parity_eval's rehearsal, blocked."""
    out = _run_blocked(_TOOLS_SCRIPT.format(blocked=BLOCKED, out=str(tmp_path), config=YOLOX))
    assert out["leaked"] == []
    assert out["levels"] == 3 and out["params"] > 0
    assert os.path.exists(out["dumped"]) and out["missing"] == out["unused"] == 0


def test_port_sources_never_import_jax():
    """No file of the port (its configs included) and not chip_smoke.py
    imports JAX or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(basedet_tpu|jax|jaxlib|flax|optax|cv2)\b", re.M)
    sources = [*(REPO / "basedet_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    scanned = {str(p.relative_to(REPO)) for p in sources}
    assert {f"basedet_tpu_torch/{m}.py" for m in (
        "parallel/mesh", "parallel/tp", "tools/trace_net", "tools/profile_net", "tools/analyze_net",
        "tools/dump_cfg", "tools/parity_diff", "tools/parity_eval", "layers/common/module_inspector",
        "layers/common/module_utils", "layers/blocks/pool", "evaluators/visualize")} <= scanned
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
    assert pattern.search("from basedet_tpu.utils import logger")
    assert not pattern.search("from basedet_tpu_torch.utils import logger")


@pytest.mark.parametrize("tool", ["det_train", "det_test", "trace_net", "analyze_net", "profile_net", "parity_eval",
                                  "parity_diff"])
def test_tools_default_to_cuda_and_raise_without_it(tool, monkeypatch, tmp_path):
    """The entry points run on the card unless the caller asks for the CPU:
    with no --device and no CUDA they raise, naming --device cpu, before
    they build anything."""
    import importlib

    import torch

    main = importlib.import_module(f"basedet_tpu_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {"parity_eval": ["--rehearse", "--out-dir", str(tmp_path)],
            "parity_diff": ["dump", "-o", str(tmp_path / "d.pkl")]}.get(tool, ["-f", YOLOX, "GLOBAL.OUTPUT_DIR",
                                                                             str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(args)
    assert not any(tmp_path.iterdir())
