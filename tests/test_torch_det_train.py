"""``det_train`` of the port end to end on the CPU, at a tiny size, then
``det_test`` on what it wrote: tiny YOLOX-S (width 0.25) on synthetic 96²
batches of 2, multiscale live (64-128), two epochs of two steps; tiny
Faster R-CNN (as tests/tiny.py shrinks it) on 128x192 batches of 2, likewise;
and tiny CenterNet (likewise) on 128x128 batches of 2."""
import json
import math

import torch

from basedet_tpu_torch.tools import det_test, det_train

CONFIG = "basedet_tpu_torch/playground/yolox_s/config.py"
FRCNN_CONFIG = "basedet_tpu_torch/playground/faster_rcnn_r50_1x/config.py"
CENTERNET_CONFIG = "basedet_tpu_torch/playground/centernet_r50/config.py"


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


def frcnn_opts(out):
    """Tiny Faster R-CNN; score threshold 0 so that a barely trained head's
    ~1/81 class scores give detections."""
    return ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.FPN.OUT_CHANNELS", "64",
            "MODEL.RPN.TRAIN_PREV_NMS_TOPK", "200", "MODEL.RPN.TRAIN_POST_NMS_TOPK", "100",
            "MODEL.RPN.TEST_PREV_NMS_TOPK", "200", "MODEL.RPN.TEST_POST_NMS_TOPK", "100",
            "MODEL.RCNN.NUM_ROIS", "64", "MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "8",
            "DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(128,192)",
            "TEST.CLS_THRESHOLD", "0.0", "SOLVER.MAX_EPOCH", "2", "SOLVER.NUM_IMAGE_PER_EPOCH", "4",
            "GLOBAL.LOG_INTERVAL", "1", "GLOBAL.OUTPUT_DIR", str(out),
            "GLOBAL.CKPT_SAVE_DIR", str(out / "ckpt")]


def test_faster_rcnn_det_train_then_det_test_on_cpu(tmp_path):
    trainer = det_train.main(["-f", FRCNN_CONFIG, "--device", "cpu", *frcnn_opts(tmp_path)])
    assert trainer.state.step == 4 and trainer.progress.current_iter == 4
    for k in ("total_loss", "rpn_cls_loss", "rpn_reg_loss", "rcnn_cls_loss", "rcnn_reg_loss"):
        assert math.isfinite(trainer.meters[k].latest) and trainer.meters[k].latest > 0, k
    # step 3 of a 500-step linear warm-up from 0.001 of BASIC_LR x BATCHSIZE
    base = trainer.solver.base_lr
    assert base == 0.02 / 16 * 2
    assert abs(trainer.meters["lr"].latest - base * (0.001 + 0.999 * 3 / 500)) <= 1e-12
    assert not trainer.ema_enabled and trainer.state.ema_params is None
    # FrozenBN and the frozen stages stay as built; the rest moved
    module = trainer.model.module
    assert not module.bottom_up.conv1.weight.requires_grad
    assert module.rcnn.fc1.weight.grad is not None and module.bottom_up.conv1.weight.grad is None

    ckpt_dir = tmp_path / "ckpt"
    assert (ckpt_dir / "last_checkpoint").read_text() == "epoch_2.pt"
    ckpt = torch.load(ckpt_dir / "latest.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["ema"] is None
    dumped = torch.load(ckpt_dir / "dumped_model.pt", weights_only=True)
    live = module.state_dict()
    assert dumped.keys() == live.keys()
    for k, v in dumped.items():
        assert torch.equal(v, live[k]), k

    results = det_test.main(["-f", FRCNN_CONFIG, "-w", str(ckpt_dir / "dumped_model.pt"),
                             "--device", "cpu", *frcnn_opts(tmp_path)])
    records = json.loads((tmp_path / "predict_coco.json").read_text())
    assert results["num_detections"] == len(records) > 0
    assert {r["image_id"] for r in records} == set(range(8))
    # no -w: the checkpoint that last_checkpoint names
    assert det_test.main(["-f", FRCNN_CONFIG, "--device", "cpu", *frcnn_opts(tmp_path)])["num_detections"] > 0


def centernet_opts(out):
    return ["MODEL.BACKBONE.NAME", "resnet10", "MODEL.HEAD.DECONV_CHANNEL", "[512,64,32,16]",
            "MODEL.HEAD.IN_CHANNELS", "16", "MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "8",
            "DATA.TRAIN.name", "dummy", "DATA.TEST.name", "dummy", "DATA.DUMMY_IMAGE_SIZE", "(128,128)",
            "SOLVER.MAX_EPOCH", "2", "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1",
            "GLOBAL.OUTPUT_DIR", str(out), "GLOBAL.CKPT_SAVE_DIR", str(out / "ckpt")]


def test_centernet_det_train_then_det_test_on_cpu(tmp_path):
    """Four steps through the DCN stages (the scatter's plain version three
    times a step), every stage trained (FREEZE_AT 0), train-mode BN
    statistics moved; then det_test serves the dump."""
    from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain

    calls = scatter_rows_plain.calls
    trainer = det_train.main(["-f", CENTERNET_CONFIG, "--device", "cpu", *centernet_opts(tmp_path)])
    assert trainer.state.step == 4 and scatter_rows_plain.calls - calls == 12
    for k in ("total_loss", "loss_cls", "loss_box_wh", "loss_center_reg"):
        assert math.isfinite(trainer.meters[k].latest) and trainer.meters[k].latest > 0, k
    module = trainer.model.module
    assert module.bottom_up.conv1.weight.grad is not None
    assert not torch.equal(module.bottom_up.bn.running_var, torch.ones(64))
    assert not torch.equal(module.upsample.deconv3.BatchNorm_1.running_mean, torch.zeros(16))

    dumped = tmp_path / "ckpt" / "dumped_model.pt"
    results = det_test.main(["-f", CENTERNET_CONFIG, "-w", str(dumped), "--device", "cpu",
                             *centernet_opts(tmp_path)])
    records = json.loads((tmp_path / "predict_coco.json").read_text())
    assert results["num_detections"] == len(records) > 0
    assert {r["image_id"] for r in records} == set(range(8))


def test_centernet_refuses_a_real_dataset_naming_its_transforms(tmp_path):
    """Only the synthetic loader is ported: a real dataset is refused, with
    the augmentations (CenterAffine and the colour jitters) that would come
    with it."""
    import pytest

    opts = [*centernet_opts(tmp_path), "DATA.TRAIN.name", "coco_2017_train"]
    with pytest.raises(NotImplementedError, match="CenterAffine, RandomHorizontalFlip, RandomBrightness"):
        det_train.main(["-f", CENTERNET_CONFIG, "--device", "cpu", *opts])
