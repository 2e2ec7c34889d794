"""``det_train -d DIR`` of the port on the CPU: every ``*.py`` config of the
directory trained in sorted order, as ``basedet_tpu/tools/det_train.py:36-55``
does; each config writes to its own output directory and the last one's
trainer is returned. Tiny YOLOX-S (width 0.25) on synthetic 96² batches, one
step each."""
import torch

from basedet_tpu_torch.tools import det_train
from tests.torch_threads import torch_threads  # noqa: F401

CONFIG = '''from basedet_tpu_torch.configs import YOLOXSConfig


class Cfg(YOLOXSConfig):
    def __init__(self):
        super().__init__()
        self.SEED = {seed}
        self.GLOBAL.OUTPUT_DIR = {out!r}
        self.GLOBAL.CKPT_SAVE_DIR = {ckpt!r}
'''

OPTS = ["MODEL.WIDTH_FACTOR", "0.25", "MODEL.BATCHSIZE", "2", "DATA.MAX_INSTANCES", "8", "DATA.TRAIN.name", "dummy",
        "DATA.TEST.name", "dummy", "AUG.TRAIN_SETTING.INPUT_SIZE", "(96,96)",
        "AUG.TRAIN_SETTING.MULTISCALE_RANGE", "(3,3)", "SOLVER.MAX_EPOCH", "1", "SOLVER.NUM_IMAGE_PER_EPOCH", "2",
        "GLOBAL.LOG_INTERVAL", "1"]


def test_det_train_dir_trains_every_config_in_sorted_order(tmp_path):
    configs = tmp_path / "configs"
    configs.mkdir()
    for name, seed in (("b_second.py", 2), ("a_first.py", 1)):
        out = tmp_path / name[:-3]
        (configs / name).write_text(CONFIG.format(seed=seed, out=str(out), ckpt=str(out / "ckpt")))
    (configs / "notes.txt").write_text("not a config")
    seen = []
    train = det_train._train_one

    def recorded(config_file, args, device):
        seen.append(config_file)
        return train(config_file, args, device)

    det_train._train_one = recorded
    try:
        trainer = det_train.main(["-d", str(configs), "--device", "cpu", *OPTS])
    finally:
        det_train._train_one = train
    assert [p.rsplit("/", 1)[1] for p in seen] == ["a_first.py", "b_second.py"]
    assert trainer.cfg.SEED == 2 and trainer.state.step == 1
    for name in ("a_first", "b_second"):
        assert (tmp_path / name / "ckpt" / "dumped_model.pt").exists(), name
    first = torch.load(tmp_path / "a_first" / "ckpt" / "dumped_model.pt", weights_only=True)
    second = torch.load(tmp_path / "b_second" / "ckpt" / "dumped_model.pt", weights_only=True)
    assert first.keys() == second.keys()
