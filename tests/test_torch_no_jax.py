"""basedet_tpu_torch runs where JAX, flax, optax and cv2 are absent, as on
the GPU machine: its det_test and det_train run in a subprocess that cannot
import them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "cv2")

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

opts = ["MODEL.WIDTH_FACTOR", "0.25", "DATA.TEST.name", "dummy",
        "DATA.DUMMY_IMAGE_SIZE", "(96,96)", "GLOBAL.OUTPUT_DIR", {out!r}]
cfg = import_config("playground/yolox_s/config.py")
cfg.merge(opts)
torch.save(build_model(cfg, "cpu").module.state_dict(), {out!r} + "/w.pt")
results = det_test.main(["-f", "playground/yolox_s/config.py", "-w", {out!r} + "/w.pt",
                         "--device", "cpu", *opts])
print(json.dumps({{"results": results, "leaked": sorted(m for m in sys.modules
                                                       if m.split(".")[0] in BLOCKED)}}))
"""


_TRAIN_SCRIPT = _BLOCK + r"""
from basedet_tpu_torch.tools import det_train

opts = ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "8",
        "DATA.TRAIN.name", "dummy", "AUG.TRAIN_SETTING.INPUT_SIZE", "(64,64)",
        "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(2,3)", "SOLVER.MAX_EPOCH", "1",
        "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1",
        "GLOBAL.OUTPUT_DIR", {out!r}, "GLOBAL.CKPT_SAVE_DIR", {out!r} + "/ckpt"]
trainer = det_train.main(["-f", "playground/yolox_s/config.py", "--device", "cpu", *opts])
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


def test_det_test_runs_without_jax(tmp_path):
    out = _run_blocked(_SCRIPT.format(blocked=BLOCKED, out=str(tmp_path)))
    assert out["leaked"] == []
    assert out["results"]["num_detections"] > 0
    records = json.loads((tmp_path / "predict_coco.json").read_text())
    assert len(records) == out["results"]["num_detections"]
    assert {r["image_id"] for r in records} == set(range(8))


def test_det_train_runs_without_jax(tmp_path):
    out = _run_blocked(_TRAIN_SCRIPT.format(blocked=BLOCKED, out=str(tmp_path)))
    assert out["leaked"] == []
    assert out["steps"] == 2 and out["loss"] > 0
    assert (tmp_path / "ckpt" / "dumped_model.pt").exists()


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|cv2)\b", re.M)
    offenders = [str(p.relative_to(REPO)) for p in (REPO / "basedet_tpu_torch").rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
    smoke = (REPO / "chip_smoke.py").read_text()
    assert not pattern.search(smoke)
    # the smoke drives the port through its own entry points only
    assert not re.search(r"^\s*(import|from)\s+basedet_tpu\b", smoke, re.M)
