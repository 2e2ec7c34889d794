"""``det_train`` of the port end to end on the CPU, at a tiny size: tiny
YOLOX-S (width 0.25) on synthetic 96² batches of 2, multiscale live (64-128),
two epochs of two steps; then ``det_test`` on what it wrote."""
import json
import math

import torch

from basedet_tpu_torch.tools import det_test, det_train

CONFIG = "basedet_tpu_torch/playground/yolox_s/config.py"


def _opts(out):
    return ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "8",
            "DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(96,96)",
            "AUG.TRAIN_SETTING.INPUT_SIZE", "(96,96)", "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(2,4)",
            "AUG.TRAIN_SETTING.SYNC_ITER", "2", "SOLVER.MAX_EPOCH", "2",
            "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1",
            "GLOBAL.OUTPUT_DIR", str(out), "GLOBAL.CKPT_SAVE_DIR", str(out / "ckpt")]


def test_det_train_then_det_test_on_cpu(tmp_path):
    trainer = det_train.main(["-f", CONFIG, "--device", "cpu", *_opts(tmp_path)])
    assert trainer.state.step == 4 and trainer.progress.current_iter == 4
    for k in ("total_loss", "iou_loss", "obj_loss", "cls_loss", "l1_loss"):
        assert math.isfinite(trainer.meters[k].latest) and trainer.meters[k].latest > 0, k
    # two epochs of a 2-epoch run sit in the 15-epoch no-aug tail: L1 on, LR at its floor
    assert trainer.model.use_l1
    assert trainer.meters["lr"].latest == trainer.solver.base_lr * 0.05
    assert {trainer.model.target_size_for_step(s)[0] for s in range(1, 5)} != {96}

    ckpt_dir = tmp_path / "ckpt"
    assert (ckpt_dir / "last_checkpoint").read_text() == "epoch_2.pt"
    ckpt = torch.load(ckpt_dir / "latest.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["progress"]["epoch"] == 2
    assert set(ckpt["ema"]) == {n for n, _ in trainer.model.module.named_parameters()}
    dumped = torch.load(ckpt_dir / "dumped_model.pt", weights_only=True)
    live = trainer.model.module.state_dict()
    assert dumped.keys() == live.keys()
    for k, v in dumped.items():  # EMA params, live BN buffers
        assert torch.equal(v, ckpt["ema"].get(k, live[k])), k

    results = det_test.main(["-f", CONFIG, "-w", str(ckpt_dir / "dumped_model.pt"),
                             "--device", "cpu", *_opts(tmp_path)])
    records = json.loads((tmp_path / "predict_coco.json").read_text())
    assert results["num_detections"] == len(records) > 0
    assert {r["image_id"] for r in records} == set(range(8))
    # no -w: the checkpoint last_checkpoint names, its live then its EMA weights
    assert det_test.main(["-f", CONFIG, "--eval-ema", "--device", "cpu",
                          *_opts(tmp_path)])["num_detections"] > 0
