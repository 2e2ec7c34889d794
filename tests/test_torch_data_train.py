"""``det_train`` of the port on a COCO-format set on disk (the synthetic set of
``tools/sanity_e2e.py``, 64² PNGs), on the CPU: tiny YOLOX-S (width 0.25)
with mosaic and mixup through two DataLoader workers, batches of 2, two
epochs of two steps, the last without augmentation. The no-aug switch turns
mosaic and mixup off and forks the workers anew; ``EvalHook`` evaluates the
live and the EMA weights on the val split; ``ResumeHook`` restores module,
optimizer, EMA, step and epoch exactly and goes on at the next epoch; a
worker's error and a test set that cannot be built reach the caller."""
import copy

import pytest
import torch

from basedet_tpu_torch.data import register_dataset
from basedet_tpu_torch.engine.hooks import ResumeHook
from basedet_tpu_torch.tools import det_train
from basedet_tpu_torch.tools.sanity_e2e import make_synthetic_coco
from tests.torch_threads import torch_threads  # noqa: F401

CONFIG = "basedet_tpu_torch/playground/yolox_s/config.py"


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    train, val = make_synthetic_coco(str(tmp_path_factory.mktemp("synth")), n_train=8, n_val=4, size=64)
    register_dataset("test_synth_train", *train)
    register_dataset("test_synth_val", *val)
    return train, val


def _opts(out, epochs=2, test="test_synth_val"):
    return ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.BATCHSIZE", "2", "DATA.NUM_CLASSES", "3", "DATA.MAX_INSTANCES", "8",
            "DATA.TRAIN.name", "test_synth_train", "DATA.TEST.name", test, "DATA.NUM_WORKERS", "2",
            "AUG.TRAIN_SETTING.INPUT_SIZE", "(64,64)", "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(2,2)",
            "AUG.TRAIN_SETTING.NO_AUG_EPOCH", "1", "TEST.IMG_MIN_SIZE", "64", "TEST.IMG_MAX_SIZE", "64",
            "SOLVER.MAX_EPOCH", str(epochs), "SOLVER.NUM_IMAGE_PER_EPOCH", "4", "GLOBAL.LOG_INTERVAL", "1",
            "GLOBAL.OUTPUT_DIR", str(out), "GLOBAL.CKPT_SAVE_DIR", str(out / "ckpt")]


def test_train_switch_eval_then_resume(synthetic, tmp_path, monkeypatch):
    trainer = det_train.main(["-f", CONFIG, "--device", "cpu", *_opts(tmp_path)])
    assert trainer.state.step == 4 and trainer.progress.epoch == 2
    loader = trainer.dataloader
    assert trainer.model.use_l1 and not loader.mosaic_dataset.enable_mosaic and not loader.mosaic_dataset.enable_mixup
    assert loader.forks == 2  # forked at the start, then again at the no-aug switch
    for weights in ("model", "EMA"):
        results = trainer.eval_results[weights]
        assert {"AP", "AP50", "AP75", "AR@100"} <= set(results) and -1 <= results["AP"] <= 1, weights
    ckpt = torch.load(tmp_path / "ckpt" / "latest.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["progress"]["epoch"] == 2

    restored, original = {}, ResumeHook.before_train

    def spy(self):  # the trainer's state just after the restore
        original(self)
        t = self.trainer
        restored.update(model=copy.deepcopy(t.model.module.state_dict()),
                        optimizer=copy.deepcopy(t.state.optimizer.state_dict()),
                        ema=copy.deepcopy(t.state.ema_params), step=t.state.step, epoch=t.progress.epoch)

    monkeypatch.setattr(ResumeHook, "before_train", spy)
    resumed = det_train.main(["-f", CONFIG, "--device", "cpu", "--resume", *_opts(tmp_path, epochs=3)])

    assert restored["step"] == 4 and restored["epoch"] == 3
    assert restored["model"].keys() == ckpt["model"].keys()
    assert all(torch.equal(restored["model"][k], v) for k, v in ckpt["model"].items())
    assert all(torch.equal(restored["ema"][k], v) for k, v in ckpt["ema"].items())
    assert restored["optimizer"]["param_groups"] == ckpt["optimizer"]["param_groups"]
    for i, state in ckpt["optimizer"]["state"].items():
        assert torch.equal(restored["optimizer"]["state"][i]["momentum_buffer"], state["momentum_buffer"])
    assert resumed.state.step == 6 and resumed.progress.epoch == 3  # one more epoch of two steps
    assert torch.load(tmp_path / "ckpt" / "latest.pt", weights_only=True)["progress"]["epoch"] == 3


def test_worker_error_reaches_det_train(tmp_path):
    """A truncated image in the train set fails in a DataLoader worker; the
    error reaches det_train."""
    train, val = make_synthetic_coco(str(tmp_path / "bad"), n_train=4, n_val=2, size=64)
    for path in (tmp_path / "bad" / "train").iterdir():
        path.write_bytes(path.read_bytes()[:100])
    register_dataset("test_bad_train", *train)
    opts = [*_opts(tmp_path, test="dummy"), "DATA.TRAIN.name", "test_bad_train"]
    with pytest.raises(ValueError, match="truncated PNG chunk"):
        det_train.main(["-f", CONFIG, "--device", "cpu", *opts])


def test_eval_wiring_that_fails_raises(synthetic, tmp_path):
    """The JAX package logs a test set it cannot build and trains on; the
    port raises before training."""
    with pytest.raises(KeyError, match="no_such_set"):
        det_train.main(["-f", CONFIG, "--device", "cpu", *_opts(tmp_path, test="no_such_set")])


@pytest.mark.parametrize("model", ["faster_rcnn", "centernet"])
def test_dataloader_builder_trains_on_the_set(synthetic, tmp_path, model):
    """Tiny Faster R-CNN and tiny CenterNet, two steps each over the set
    through DataloaderBuilder and their own AUG.TRAIN_VALUE (Faster R-CNN:
    ShortestEdgeResize to 640-800 and flip; CenterNet: CenterAffine to
    512x512, flip and the colour jitters), aspect-ratio grouped batches of
    2, the RoIAlign or the row scatter on every step."""
    from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain
    from basedet_tpu_torch.ops.scatter_rows import scatter_rows_plain
    from tests.test_torch_det_train import CENTERNET_CONFIG, FRCNN_CONFIG, centernet_opts, frcnn_opts

    config, opts, counted, per_step = {
        "faster_rcnn": (FRCNN_CONFIG, frcnn_opts(tmp_path), multilevel_roi_align_plain, 1),
        "centernet": (CENTERNET_CONFIG, centernet_opts(tmp_path), scatter_rows_plain, 3)}[model]
    before = counted.calls
    trainer = det_train.main(["-f", config, "--device", "cpu", *opts, "DATA.TRAIN.name", "test_synth_train",
                              "DATA.NUM_WORKERS", "0", "SOLVER.MAX_EPOCH", "1"])
    assert trainer.state.step == 2 and counted.calls - before == 2 * per_step
    assert torch.isfinite(torch.tensor(trainer.meters["total_loss"].latest))
    assert trainer.cfg.AUG.TRAIN_VALUE[0][0] == ("ShortestEdgeResize" if model == "faster_rcnn" else "CenterAffine")


@pytest.mark.parametrize("config", ["retinanet_r50_1x", "faster_rcnn_r50_1x"])
def test_trainable_bn_backbone_starts_at_the_identity(config):
    """With BACKBONE.NORM "BN" (the from-scratch recipe of sanity_e2e) every
    BN of the backbone starts where flax's nn.BatchNorm starts: scale 1,
    bias 0, running mean 0 and variance 1. (RetinaNet's and Faster R-CNN's
    init once reset only FrozenBN, and the modules, built on the meta
    device, kept whatever memory to_empty gave them.)"""
    from basedet_tpu_torch import build_model
    from basedet_tpu_torch.tools import import_config

    cfg = import_config(f"basedet_tpu_torch/playground/{config}/config.py")
    cfg.merge(["MODEL.BACKBONE.NAME", "resnet18", "MODEL.BACKBONE.NORM", "BN", "MODEL.BACKBONE.FREEZE_AT", "0"])
    bns = [m for m in build_model(cfg, "cpu").module.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 1 + 8 * 2 + 3  # the stem, two per basic block, three downsamples
    for m in bns:
        assert torch.equal(m.weight, torch.ones_like(m.weight)) and torch.equal(m.bias, torch.zeros_like(m.bias))
        assert torch.equal(m.running_mean, torch.zeros_like(m.running_mean))
        assert torch.equal(m.running_var, torch.ones_like(m.running_var))
