"""The plain reference against basedet_tpu_torch at test sizes on the CPU,
where the port runs its kernels' plain versions: training in f32 agrees to
rounding and the assignments that rounding flips, inference's detections
exactly."""
from __future__ import annotations

import pytest


@pytest.mark.parametrize("cell", ["yolox_s.train_b64", "frcnn_r50.train_b16"])
def test_train_step_agrees(tiny_f32, cell):
    from core import manifest

    c = manifest.load_cell(cell, tiny_f32)
    r = manifest.kind_module(c.kind).Run(c, 2 ** 31 + 3, "cpu")
    r.setup()
    r.window(0.1)
    r.release()
    got = r.readings()
    # rounding apart (the port's BN and the reference's sum in other orders) can
    # flip a near-tie of SimOTA's costs, which moves one anchor's loss terms
    assert got["loss_gap"] < 1e-2 and got["grad_gap"] < 1e-2 and got["update_gap"] < 0.5, got


@pytest.mark.parametrize("cell", ["yolox_s.infer_b32", "frcnn_r50.infer_b8"])
def test_detections_agree(tiny_f32, cell):
    from core import manifest

    c = manifest.load_cell(cell, tiny_f32)
    r = manifest.kind_module(c.kind).Run(c, 17, "cpu")
    r.setup()
    r.window(0.1)
    r.release()
    assert sum(int(o["valid"].sum()) for o in r.outputs) > 0  # the spread weights give detections
    got = r.readings()
    assert got["score_gap"] < 1e-5 and got["unmatched"] == 0.0, got


def test_name_map_covers_both_models(tiny_f32):
    from core import manifest, port
    from core.weights import to_port

    for name in ("yolox_s.train_b64", "frcnn_r50.train_b16"):
        c = manifest.load_cell(name, tiny_f32)
        cfg = port.port_config(c.config, 2, False, 0)
        model = port.build_port_model(c.config, cfg, 0, "cpu")
        w = port.seeded_weights(c.config, 0, "cpu")
        mapped = to_port(w, manifest.reference_module(c.config), model.module.state_dict().keys())
        assert len(mapped) == len(model.module.state_dict())
