"""What decides ``correct`` fails what it should: a run with the timed path
broken underneath, and the lower-precision control in the program's place,
come out not correct under each cell's limits (``limits/<cell>.json``); a
sound run comes out correct. Test sizes, on the CPU; the port trains in f32
here, so that a sound run reads rounding alone."""
from __future__ import annotations

import contextlib

import pytest
import torch

from conftest import BENCH, ROOT  # noqa: F401

TRAIN = ["yolox_s.train_b64", "frcnn_r50.train_b16"]
INFER = ["yolox_s.infer_b32", "frcnn_r50.infer_b8"]


def judged(manifest_path, cell, control=None, seed=2 ** 31 + 21):
    from core import check, manifest

    c = manifest.load_cell(cell, manifest_path)
    r = manifest.kind_module(c.kind).Run(c, seed, "cpu")
    r.setup()
    r.window(0.1)
    r.release()
    readings = r.readings(control)
    ok, _ = check.judge(readings, c.limits)
    return ok, readings


@pytest.mark.parametrize("cell", TRAIN + INFER)
def test_sound_run_is_correct(tiny_f32, cell):
    ok, readings = judged(tiny_f32, cell)
    assert ok, readings


@pytest.mark.parametrize("cell", TRAIN)
def test_step_that_leaves_the_state_unchanged(tiny_f32, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    ok, readings = judged(tiny_f32, cell)
    assert not ok, readings


@pytest.mark.parametrize("cell", TRAIN)
def test_step_on_half_the_batch(tiny_f32, cell, monkeypatch):
    """The whole batch forwarded, the gradient from its first half only,
    doubled: a masking or normaliser fault in the port's losses."""
    from core import port
    from kinds.train import half_batch_gradient

    real, planted = port.build_port_model, contextlib.ExitStack()

    def faulty(config, cfg, seed, device):
        model = real(config, cfg, seed, device)
        planted.enter_context(half_batch_gradient(model.module, config["check"]["grads"], cfg.MODEL.BATCHSIZE))
        return model

    monkeypatch.setattr(port, "build_port_model", faulty)
    with planted:
        ok, readings = judged(tiny_f32, cell)
    assert not ok, readings
    assert readings["image_grad_gap"] > 0.5, readings


@pytest.mark.parametrize("cell", INFER)
def test_detection_altered_where_it_is_made(tiny_f32, cell, monkeypatch):
    from basedet_tpu_torch.models.det.faster_rcnn import FasterRCNN
    from basedet_tpu_torch.models.det.yolox import YOLOX

    for cls in (YOLOX, FasterRCNN):
        real = cls.post_process

        def altered(self, *args, _real=real, **kwargs):
            out = _real(self, *args, **kwargs)
            out["boxes"] = out["boxes"].clone()
            out["boxes"][0, 0] += 8.0  # the best detection of the first image, moved
            return out

        monkeypatch.setattr(cls, "post_process", altered)
    ok, readings = judged(tiny_f32, cell)
    assert not ok, readings


@pytest.mark.parametrize("cell", INFER)
def test_half_the_batch_left_out(tiny_f32, cell, monkeypatch):
    from basedet_tpu_torch.models.base_net import BaseNet

    real = BaseNet.pre_process

    def half(self, batch, train=False):
        out = real(self, batch, train)
        n = out["image"].shape[0] // 2
        out["image"] = out["image"].clone()
        out["image"][n:] = 0.0
        return out

    monkeypatch.setattr(BaseNet, "pre_process", half)
    ok, readings = judged(tiny_f32, cell)
    assert not ok, readings


@pytest.mark.parametrize("cell,control", [(c, "fp8") for c in TRAIN] + [(c, "tf32_rounded") for c in INFER])
def test_lower_precision_control_is_not_correct(tiny_f32, cell, control):
    ok, readings = judged(tiny_f32, cell, control)
    assert not ok, readings
